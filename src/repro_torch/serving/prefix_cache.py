"""Prefix-KV cache keyed by multi-step LRU — the paper's flagship integration.

Port of ``repro.serving.prefix_cache`` with the local backend.  Prompts are
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

The local backend never sheds, so every chain comes back served whole
(``ChainServe.served_len == len(chain)``, ``shed`` False).  The JAX
package's ``backend=`` hook (the sharded client with its sheds, retries and
split placement) and the elastic passthroughs wait for the sharded cache.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import (MSLRUConfig, MultiStepLRUCache, OP_ACCESS,
                              OP_CHAIN_GET, OP_CHAIN_PUT, OP_GET, OP_LOOKUP)

__all__ = ["PrefixCache", "ChainServe", "chunk_chain_hashes", "fmix32_py",
           "service_tick_percentiles"]

_MASK31 = 0x7FFFFFFF
_MASK32 = 0xFFFFFFFF


def fmix32_py(x: int) -> int:
    """MurmurHash3's fmix32 on a Python int (uint32 semantics); a copy of
    ``repro.core.policies.fmix32_py``."""
    x &= _MASK32
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & _MASK32
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & _MASK32
    x ^= x >> 16
    return x


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
    prefix), else ``(absorbed, stored_value)`` where ``absorbed`` means the
    insert hit an already-resident chunk and ``stored_value`` is the page
    the cache holds for it.  ``served_len`` is the chunk count the backend
    placed and ``shed`` whether it dropped the whole chain; the local
    backend always serves the whole chain."""

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
                 device="cuda"):
        self.cfg = MSLRUConfig(num_sets=num_sets, m=m, p=p, value_planes=1,
                               policy=policy, cost_planes=1 if cost_aware else 0)
        self.cache = MultiStepLRUCache(self.cfg, engine=engine, device=device)
        self.cost_aware = bool(cost_aware)
        self.chunk_tokens = chunk_tokens
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.device_calls = 0
        # per-request ticks-to-service samples (queue wait), reported by the
        # serving tier via ``note_service_latency``
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

    # -- batched engine access ----------------------------------------------
    def _call(self, keys: list[int], ops, vals: list[int] | None = None,
              chain_ids: list[int] | None = None,
              costs: list[int] | None = None) -> dict:
        """ONE engine invocation over ``keys``; ``ops`` is a scalar opcode
        or a per-row vector; ``chain_ids`` enables the fused chain ops.
        Returns the result's fields as numpy arrays.

        The batch is padded to the next power of two with OP_LOOKUP rows on
        key 0 (chunk hashes are odd, so key 0 is never resident, and LOOKUP
        never mutates), as in the JAX package, whose compiled engine needs
        O(log B) shapes.  ``device_calls`` counts exactly one per call.
        """
        self.device_calls += 1
        n = len(keys)
        bp = 1 << (n - 1).bit_length()
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
        return {f: getattr(res, f).cpu().numpy()[:n] for f in res._fields}

    # -- fused one-call tick -------------------------------------------------
    def serve_chains(self, chains: list[list[int]], staged: list[list[int]]):
        """One device call for a whole tick's chains (lookup + promote +
        conditional insert).

        ``staged[c]`` holds page values for a *prefix* of chain ``c``'s
        chunks (the chunks the caller could fund).  Returns ``(results,
        evicted)``: a ``ChainServe`` per chain and the evicted page values
        to recycle.
        """
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

        out = self._call(ks, ops, vals=vals, chain_ids=cids,
                         costs=costs if self.cost_aware else None)
        hit = out["hit"]
        val = out["value"][:, 0]
        evicted = [int(x) for x, ok in zip(out["evicted_val"][:, 0],
                                           out["evicted_valid"]) if bool(ok)]
        self.evictions += len(evicted)

        results: list[ChainServe] = []
        i = 0
        for chain in chains:
            n = len(chain)
            # the device's segmented AND leaves a leading hit run
            hseg = hit[i: i + n]
            k = n if hseg.all() else int(np.argmin(hseg))
            self.hits += k
            if k < n:
                self.misses += 1
            self._account_reprefill(chain, k)
            results.append(ChainServe([int(x) for x in val[i: i + k]], k, [], n))
            i += n
        for c, chain in enumerate(chains):
            m = min(len(staged[c]), len(chain))
            k = results[c].hitlen
            puts = []
            for t in range(m):
                if t < k:
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
        the fused ``serve_chains`` pass."""
        flat = [h for c in chains for h in c]
        if not flat:
            return [[] for _ in chains]
        out = self._call(flat, OP_LOOKUP)
        hit = out["hit"]
        val = out["value"][:, 0]
        pages: list[list[int]] = []
        promote: list[int] = []
        i = 0
        for chain in chains:
            n = len(chain)
            k = n if hit[i: i + n].all() else int(np.argmin(hit[i: i + n]))
            got = [int(x) for x in val[i: i + k]]
            i += n
            self.hits += k
            if k < n:
                self.misses += 1
            # the caller (re)prefills past the hit prefix: account here, so
            # the split tick counts each chunk once
            self._account_reprefill(chain, k)
            promote.extend(chain[:k])
            pages.append(got)
        if promote:
            self._call(promote, OP_GET)
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
        evicted, plus staged pages whose insert was absorbed as a duplicate
        hit (never published, so dropping them would leak pool storage).
        Only true evictions count in ``stats()["evictions"]``.

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
        flat_c: list[int] = []
        for ci, c in enumerate(chains):
            d = 0 if depths is None else depths[ci]
            n = len(c) + d if chain_lens is None else chain_lens[ci]
            flat_c.extend(self.chain_costs(n)[d: d + len(c)])
        out = self._call(flat_k, OP_ACCESS, vals=flat_p,
                         costs=flat_c if self.cost_aware else None)
        hit = out["hit"]
        evicted = [int(v) for v, ok in zip(out["evicted_val"][:, 0],
                                           out["evicted_valid"]) if bool(ok)]
        self.evictions += len(evicted)
        for p, h, cost in zip(flat_p, hit, flat_c):
            if not bool(h):                    # published: page now live
                self._page_cost[int(p)] = cost
        self._account_evictions(evicted)
        return evicted + [int(p) for p, h in zip(flat_p, hit) if bool(h)]

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
            "service_ticks_p50": p50,
            "service_ticks_p99": p99,
            "reprefill_flops": self.reprefill_flops,
            "evicted_cost": self.evicted_cost,
        }
