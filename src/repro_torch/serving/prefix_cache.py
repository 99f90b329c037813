"""Prefix-KV cache keyed by multi-step LRU — the paper's flagship integration.

Port of ``repro.serving.prefix_cache``.  Prompts are
split into fixed-size token chunks; each chunk is identified by a rolling
*chain hash* (the chunk's tokens combined with the parent chunk's hash, so
a chunk key names an entire prefix).  The chain hash is the key in a
multi-step LRU cache (``repro_torch.core.MultiStepLRUCache``, one-pass
engine) whose value is a page index into the ``PagedKVPool``: recency lives
in lane order, one-hit-wonder prompts cannot evict established hot
prefixes, and eviction surfaces the evicted page so the pool recycles it.

``serve_chains`` performs a whole serving tick — every queued request's
longest-hit prefix lookup, the hit-prefix promotions and the conditional
inserts of the not-yet-cached chunks — in ONE op-coded engine call: each
chain's chunks go in as OP_CHAIN_GET rows and again as OP_CHAIN_PUT rows
carrying pre-staged page values.  On a CUDA device that call is one launch
of the one-pass kernel.  ``device_calls`` counts engine invocations, one
per ``_call``.

The split admission path's ``lookup_chains`` is the two-call baseline: one
LOOKUP call over every chunk of every chain, then one GET call promoting
the hit prefixes (``insert_chains`` publishes the new chunks afterwards).

``backend`` swaps the local ``MultiStepLRUCache`` for any object with the
same ``access``/``occupancy`` interface, such as
``core.sharded.ShardedCacheClient``, which routes the same one-call tick
through the sharded engine; with its caller-order ranks the sharded table
is bit-equal to the local one.

Sheds and retries: a capacity-bounded backend may shed whole chains and
reports them in its ``last_shed`` caller-order mask.  ``serve_chains``
returns a shed chain as ``ChainServe(shed=True)``: none of its rows
executed, it counts in no hit or miss, and the caller re-submits it next
tick (``retries`` flags count in ``stats()["retried"]``).  A split-placing
backend sheds only a chunk suffix, in both islands alike: the chain is
served up to the first shed row (``served_len``), its hit length the
leading hit run within that prefix, and ``stats()["partial_served"]``
counts it.  On the split path a shed row is a forced miss (``lookup_chains``)
or returns its staged page (``insert_chains``), counted in ``shed``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import (MSLRUConfig, MultiStepLRUCache, OP_ACCESS,
                              OP_CHAIN_GET, OP_CHAIN_PUT, OP_DELETE, OP_GET,
                              OP_LOOKUP)
from repro_torch.core.policies import fmix32_py

__all__ = ["PrefixCache", "ChainServe", "chunk_chain_hashes", "fmix32_py",
           "service_tick_percentiles"]

_MASK31 = 0x7FFFFFFF
_MASK32 = 0xFFFFFFFF


def _host(x) -> np.ndarray:
    """A backend's result field as a numpy array."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def service_tick_percentiles(samples) -> tuple[float, float]:
    """(p50, p99) of integer tick-latency samples — ``method="higher"``
    keeps them conservative instead of interpolating; (0, 0) when empty."""
    lat = np.asarray(samples, np.float64)
    if not lat.size:
        return 0.0, 0.0
    return (float(np.percentile(lat, 50, method="higher")),
            float(np.percentile(lat, 99, method="higher")))


def chunk_chain_hashes(tokens: np.ndarray, chunk_tokens: int) -> list[int]:
    """Chain hashes for every complete chunk of a 1-D token array.

    h_i = fmix32(h_{i-1} ^ fnv(chunk_i)); masked to 31 bits (never EMPTY/0).
    """
    out = []
    h = 0x9E3779B9
    for i in range(len(tokens) // chunk_tokens):
        ch = 0x811C9DC5
        for t in tokens[i * chunk_tokens: (i + 1) * chunk_tokens].tolist():
            ch = ((ch ^ int(t)) * 0x01000193) & _MASK32
        h = fmix32_py(h ^ ch)
        out.append((h & _MASK31) | 1)
    return out


class ChainServe:
    """Per-chain outcome of a fused tick: ``pages`` (the longest-hit
    prefix's page values, promoted), ``hitlen``, and ``puts`` — one entry
    per staged chunk: ``None`` if the row did not execute (inside the hit
    prefix, or past ``served_len``), else ``(absorbed, stored_value)`` where
    ``absorbed`` means the insert hit an already-resident chunk and
    ``stored_value`` is the page the cache holds for it.  ``served_len`` is
    the chunk count the backend placed (a split-placing backend may shed a
    chunk suffix: the caller re-queues only the tail inserts); ``shed``
    means the backend dropped the whole chain (``served_len`` 0, nothing
    executed or counted): re-submit it next tick."""

    __slots__ = ("pages", "hitlen", "puts", "shed", "served_len")

    def __init__(self, pages, hitlen, puts, served_len, shed=False):
        self.pages = pages
        self.hitlen = hitlen
        self.puts = puts
        self.shed = shed
        self.served_len = 0 if shed else served_len


class PrefixCache:
    """Multi-step-LRU map: chain-hash -> KV page index (batched mixed ops)."""

    def __init__(self, num_sets: int = 1024, m: int = 2, p: int = 4,
                 chunk_tokens: int = 64, policy: str = "multistep",
                 engine: str = "onepass", cost_aware: bool = False,
                 device="cuda", backend=None):
        if backend is None:
            self.cfg = MSLRUConfig(num_sets=num_sets, m=m, p=p, value_planes=1,
                                   policy=policy, cost_planes=1 if cost_aware else 0)
            self.cache = MultiStepLRUCache(self.cfg, engine=engine, device=device)
            self.cost_aware = bool(cost_aware)
        else:
            self.cache = backend
            self.cfg = backend.cfg
            # cost-awareness follows the backend's table geometry
            self.cost_aware = bool(self.cfg.cost_planes)
        self.chunk_tokens = chunk_tokens
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.device_calls = 0
        self.shed = 0            # chain-events a bounded backend dropped whole
        self.partial_served = 0  # chains served up to a fragment boundary
        self.retried = 0         # chains re-submitted after a shed
        self.fallbacks = 0       # requests that fell back to plain prefill
        # per-request ticks-to-service samples (queue wait and shed
        # retries), reported by the serving tier via ``note_service_latency``
        self.service_ticks: list[int] = []
        # -- re-prefill accounting (the quantity cost-aware eviction cuts) --
        # FLOPs re-spent prefilling a chunk that was computed in some
        # earlier tick and has since been evicted; chunk t of a chain costs
        # (t+1) * chunk_tokens^2 (attention over its prefix)
        self.reprefill_flops = 0
        # summed stored cost of evicted entries (device cost-plane units)
        self.evicted_cost = 0
        self._computed_ever: set[int] = set()   # chunk hashes ever prefilled
        self._page_cost: dict[int, int] = {}    # live page -> stored cost

    @staticmethod
    def chain_costs(n: int) -> list[int]:
        """Per-chunk re-prefill costs for an ``n``-chunk chain: losing the
        depth-``k`` chunk orphans every deeper chunk, so its cost is the
        tail re-prefill sum ``(n(n+1) - k(k+1)) / 2`` in units of
        ``chunk_tokens^2`` FLOPs — leaf chunks are the cheap victims."""
        return [(n * (n + 1) - k * (k + 1)) // 2 for k in range(n)]

    def _account_reprefill(self, chain, hitlen: int) -> None:
        """Chunks past the hit prefix get (re)prefilled by the caller this
        tick: charge ``reprefill_flops`` for every one seen in an earlier
        tick and mark all of them computed."""
        ct2 = self.chunk_tokens * self.chunk_tokens
        for t in range(hitlen, len(chain)):
            h = int(chain[t])
            if h in self._computed_ever:
                self.reprefill_flops += (t + 1) * ct2
            else:
                self._computed_ever.add(h)

    def _account_evictions(self, evicted) -> None:
        """Pop evicted pages' stored costs into ``evicted_cost``."""
        for pg in evicted:
            self.evicted_cost += self._page_cost.pop(int(pg), 0)

    def _note_chains(self, chains, skip=None) -> None:
        """Register served chains with an elastic backend's chain registry
        (``ShardedCacheClient.note_chain``) so a reshard can drain them; a
        no-op for a backend without one.  ``skip[c]`` leaves out chain
        ``c`` (a shed chain executed no row)."""
        note = getattr(self.cache, "note_chain", None)
        if note is None:
            return
        for c, chain in enumerate(chains):
            if chain and not (skip is not None and skip[c]):
                note(chain)

    # -- elasticity passthrough (sharded backends) --------------------------
    def reshard(self, new_ndev: int, drain_batch: int = 256) -> list[int]:
        """Drain and rebuild the backend table on ``new_ndev`` shards
        (``ShardedCacheClient.reshard``); returns the orphaned pages the
        caller must release to its pool."""
        return self.cache.reshard(new_ndev, drain_batch=drain_batch)

    def mark_degraded(self, shard: int) -> list[int]:
        """Treat a backend shard as lost (``ShardedCacheClient.mark_degraded``);
        returns the orphaned pages."""
        return self.cache.mark_degraded(shard)

    def note_fallback(self) -> None:
        """Count one request falling back to plain prefill after exhausting
        its shed retries."""
        self.fallbacks += 1

    # -- batched engine access ----------------------------------------------
    def _call(self, keys: list[int], ops, vals: list[int] | None = None,
              chain_ids: list[int] | None = None,
              costs: list[int] | None = None):
        """ONE engine invocation over ``keys``; ``ops`` is a scalar opcode
        or a per-row vector; ``chain_ids`` enables the fused chain ops.
        Returns ``(out, shed)``: the result's fields as numpy arrays and the
        (n,) bool mask of rows a bounded backend shed (all False for the
        local engine).

        The batch is padded to the next power of two with OP_LOOKUP rows on
        key 0 (chunk hashes are odd, so key 0 is never resident, and LOOKUP
        never mutates), as in the JAX package, whose compiled engine needs
        O(log B) shapes.  A backend that pads its own slabs
        (``self_padding``, the sharded client) is not padded here: padding
        rows must not compete with real rows for its per-peer buffers.
        ``device_calls`` counts exactly one per call.
        """
        self.device_calls += 1
        n = len(keys)
        bp = (n if getattr(self.cache, "self_padding", False)
              else 1 << (n - 1).bit_length())
        k = np.zeros(bp, np.int32)
        k[:n] = keys
        v = np.zeros((bp, 1), np.int32)
        if vals is not None:
            v[:n, 0] = vals
        o = np.full(bp, OP_LOOKUP, np.int32)
        o[:n] = ops
        c = None
        if chain_ids is not None:
            c = np.zeros(bp, np.int32)
            c[:n] = chain_ids
        cst = None
        if costs is not None:
            cst = np.zeros(bp, np.int32)
            cst[:n] = costs
        res = self.cache.access(k, v, ops=o, chain_ids=c, costs=cst)
        shed = getattr(self.cache, "last_shed", None)
        shed = np.zeros(n, bool) if shed is None else np.asarray(shed)[:n]
        return {f: _host(getattr(res, f))[:n] for f in res._fields}, shed

    # -- fused one-call tick -------------------------------------------------
    def serve_chains(self, chains: list[list[int]], staged: list[list[int]],
                     retries: list[bool] | None = None):
        """One device call for a whole tick's chains (lookup + promote +
        conditional insert).

        ``staged[c]`` holds page values for a *prefix* of chain ``c``'s
        chunks (the chunks the caller could fund).  ``retries[c]`` marks a
        chain re-submitted after a shed.  Returns ``(results, evicted)``: a
        ``ChainServe`` per chain and the evicted page values to recycle.  A
        chain the backend shed comes back as ``ChainServe(shed=True)``.
        """
        if retries is not None:
            self.retried += sum(bool(r) for r in retries)
        ks: list[int] = []
        ops: list[int] = []
        vals: list[int] = []
        cids: list[int] = []
        costs: list[int] = []
        chain_cost = [self.chain_costs(len(chain)) for chain in chains]
        for c, chain in enumerate(chains):
            for h in chain:
                ks.append(h)
                ops.append(OP_CHAIN_GET)
                vals.append(0)
                cids.append(c)
                costs.append(0)                # GET rows never insert
        for c, chain in enumerate(chains):
            for t, (h, pg) in enumerate(zip(chain, staged[c])):
                ks.append(h)
                ops.append(OP_CHAIN_PUT)
                vals.append(pg)
                cids.append(c)
                costs.append(chain_cost[c][t])
        if not ks:
            return [ChainServe([], 0, [], len(chain)) for chain in chains], []

        out, shed = self._call(ks, ops, vals=vals, chain_ids=cids,
                               costs=costs if self.cost_aware else None)
        hit = out["hit"]
        val = out["value"][:, 0]
        evicted = [int(x) for x, ok in zip(out["evicted_val"][:, 0],
                                           out["evicted_valid"]) if bool(ok)]
        self.evictions += len(evicted)

        # each chain's served boundary: the first shed row of either island
        # (a split-placing backend sheds a chunk suffix in both alike); a
        # whole-chain shed puts it at 0
        clens = np.array([len(c) for c in chains], np.int64)
        sl = clens.copy()
        i = 0
        for c, chain in enumerate(chains):
            s = shed[i: i + len(chain)]
            if s.any():
                sl[c] = min(sl[c], int(np.argmax(s)))
            i += len(chain)
        for c, chain in enumerate(chains):
            m = min(len(staged[c]), len(chain))
            s = shed[i: i + m]
            if s.any():
                sl[c] = min(sl[c], int(np.argmax(s)))
            i += m
        chain_shed = (sl == 0) & (clens > 0)
        self.shed += int(chain_shed.sum())
        self.partial_served += int(((sl > 0) & (sl < clens)).sum())
        self._note_chains(chains, skip=chain_shed)

        results: list[ChainServe] = []
        i = 0
        for c, chain in enumerate(chains):
            n = len(chain)
            if chain_shed[c]:
                results.append(ChainServe([], 0, [], 0, shed=True))
                i += n
                continue
            s = int(sl[c])
            # the leading hit run of the served prefix: a later fragment's
            # hits past an earlier fragment's miss do not count
            hseg = hit[i: i + s]
            k = s if hseg.all() else int(np.argmin(hseg))
            self.hits += k
            if k < n:
                self.misses += 1
            self._account_reprefill(chain, k)
            results.append(ChainServe([int(x) for x in val[i: i + k]], k, [], s))
            i += n
        for c, chain in enumerate(chains):
            m = min(len(staged[c]), len(chain))
            if chain_shed[c]:
                i += m
                continue
            k = results[c].hitlen
            s = int(sl[c])
            puts = []
            for t in range(m):
                if t < k or t >= s:
                    puts.append(None)          # row did not execute
                else:
                    puts.append((bool(hit[i + t]), int(val[i + t])))
                    if not bool(hit[i + t]):
                        # a miss-insert published the STAGED page (the
                        # engine returns value 0 on a miss) — it is live now
                        self._page_cost[int(staged[c][t])] = chain_cost[c][t]
            results[c].puts = puts
            i += m
        # after the publish bookkeeping, so a page published and displaced
        # within one tick still settles its stored cost
        self._account_evictions(evicted)
        return results, evicted

    # -- split path: lookups, then inserts ------------------------------------
    def lookup_chains(self, chains: list[list[int]]) -> list[list[int]]:
        """Pages for each chain's longest cached prefix, in at most 2 device
        calls: one LOOKUP call over every chunk of every chain (read-only,
        so chains cannot perturb each other's probe), a host-side
        longest-prefix scan, then one GET call promoting exactly the
        hit-prefix chunks in chain order — the same mutations and stats as
        the fused ``serve_chains`` pass.  A shed probe row is a forced miss
        here (the fused path retries instead); a chain counts once in
        ``shed`` however many of its rows shed over the two calls."""
        flat = [h for c in chains for h in c]
        if not flat:
            return [[] for _ in chains]
        self._note_chains(chains)
        out, shed = self._call(flat, OP_LOOKUP)
        hit = out["hit"]
        val = out["value"][:, 0]
        pages: list[list[int]] = []
        promote: list[int] = []
        promote_chain: list[int] = []      # promote row -> chain index
        shed_chains: set[int] = set()
        i = 0
        for ci, chain in enumerate(chains):
            got: list[int] = []
            if shed[i: i + len(chain)].any():
                shed_chains.add(ci)
            for j in range(len(chain)):
                if not bool(hit[i + j]) or bool(shed[i + j]):
                    break
                got.append(int(val[i + j]))
            i += len(chain)
            self.hits += len(got)
            if len(got) < len(chain):
                self.misses += 1
            # the caller (re)prefills past the hit prefix: account here, so
            # the split tick counts each chunk once
            self._account_reprefill(chain, len(got))
            promote.extend(chain[: len(got)])
            promote_chain.extend([ci] * len(got))
            pages.append(got)
        if promote:
            # a shed promote row loses only its recency bump
            _, pshed = self._call(promote, OP_GET)
            shed_chains |= {c for c, s in zip(promote_chain, pshed) if bool(s)}
        self.shed += len(shed_chains)
        return pages

    def lookup_chain(self, chain: list[int]) -> list[int]:
        """Pages for the longest cached prefix (get semantics: promotes)."""
        return self.lookup_chains([chain])[0]

    def insert_chain(self, chain: list[int], pages: list[int]) -> list[int]:
        """Insert chunk->page entries; returns the pages to recycle."""
        return self.insert_chains([chain], [pages])

    def insert_chains(self, chains: list[list[int]], pages: list[list[int]],
                      depths: list[int] | None = None,
                      chain_lens: list[int] | None = None) -> list[int]:
        """Insert chunk->page entries for all chains in ONE ACCESS batch;
        returns every page the pool should recycle: the victims the inserts
        evicted, staged pages whose insert was absorbed as a duplicate hit
        (never published, so dropping them would leak pool storage), and
        the staged pages of rows a bounded backend shed.  Only true
        evictions count in ``stats()["evictions"]``.

        ``depths[c]`` / ``chain_lens[c]`` locate chain ``c`` when it is a
        suffix of a longer chain, so per-chunk costs match what
        ``serve_chains`` would stage for the same chunks; ``None`` treats
        every chain as complete (depth 0)."""
        flat_k = [h for c in chains for h in c]
        flat_p = [pg for ps in pages for pg in ps]
        if len(flat_k) != len(flat_p):
            raise ValueError(f"{len(flat_k)} chunks but {len(flat_p)} pages")
        if not flat_k:
            return []
        self._note_chains(chains)
        flat_c: list[int] = []
        for ci, c in enumerate(chains):
            d = 0 if depths is None else depths[ci]
            n = len(c) + d if chain_lens is None else chain_lens[ci]
            flat_c.extend(self.chain_costs(n)[d: d + len(c)])
        out, shed = self._call(flat_k, OP_ACCESS, vals=flat_p,
                               costs=flat_c if self.cost_aware else None)
        hit = out["hit"]
        evicted = [int(v) for v, ok in zip(out["evicted_val"][:, 0],
                                           out["evicted_valid"]) if bool(ok)]
        self.evictions += len(evicted)
        for p, h, s, cost in zip(flat_p, hit, shed, flat_c):
            if not bool(h) and not bool(s):    # published: page now live
                self._page_cost[int(p)] = cost
        self._account_evictions(evicted)
        redundant = [int(p) for p, h in zip(flat_p, hit) if bool(h)]
        # a shed insert row never published: its staged page goes back
        dropped = [int(p) for p, s in zip(flat_p, shed) if bool(s)]
        if dropped:
            i = 0
            for ps in pages:
                if shed[i: i + len(ps)].any():
                    self.shed += 1
                i += len(ps)
        return evicted + redundant + dropped

    def delete(self, chain_hash: int) -> bool:
        """Invalidate one chunk; False if it was not resident or was shed."""
        out, shed = self._call([chain_hash], OP_DELETE)
        if bool(shed[0]):
            self.shed += 1
            return False
        return bool(out["hit"][0])

    def note_service_latency(self, ticks: int) -> None:
        """Record one request's ticks-to-service; summarized as p50/p99."""
        self.service_ticks.append(int(ticks))

    def stats(self) -> dict:
        total = self.hits + self.misses
        p50, p99 = service_tick_percentiles(self.service_ticks)
        return {
            "hits": self.hits,
            "misses": self.misses,
            "hit_ratio": self.hits / total if total else 0.0,
            "evictions": self.evictions,
            "occupancy": self.cache.occupancy,
            "device_calls": self.device_calls,
            "shed": self.shed,
            "partial_served": self.partial_served,
            "retried": self.retried,
            "fallbacks": self.fallbacks,
            "service_ticks_p50": p50,
            "service_ticks_p99": p99,
            "reprefill_flops": self.reprefill_flops,
            "evicted_cost": self.evicted_cost,
        }
