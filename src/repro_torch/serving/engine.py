"""Continuous-batching serve engine with multi-step-LRU prefix reuse.

Port of ``repro.serving.engine`` for the attention decoder.  Flow per
request:

  1. chunk-hash the prompt; one op-coded ``PrefixCache.serve_chains`` call
     per tick finds every admitted request's longest cached prefix, promotes
     its hit chunks and inserts the rest with pre-staged page values;
  2. make the cached pages the request's prefix KV — ``kv_mode``:
     * ``"contiguous"`` (the oracle): gather the pages into the slot's
       contiguous KV cache (a device copy per borrower);
     * ``"paged"``: pin the pages and record the slot's block table — zero
       copies; the pool is the single resident store;
  3. prefill the remaining tokens of the tick's requests in one batched
     launch per dependency wave (paged mode reads the prefix out of the
     pool inside the launch);
  4. write the new chunks' KV into their pages;
  5. decode: ONE launch per tick advances every active slot at its own
     position (in-flight batching).  Paged decode walks the block table
     over the pool for the prefix and a slot-local tail for the rest; on a
     CUDA device each layer's attention is one launch of the paged kernel
     (``kernels/paged_attn.py``).

Fused admission keeps the JAX package's host-side page protocol line for
line: intra-tick prefix dedupe (one owner per distinct chunk, borrowers in
later waves), reserve-then-commit paging with evicted pages released first,
the pressure retry that funds leftover inserts from this tick's
evictions, and decode-overlapped borrower waves (the tick's decode launch
goes between the wave-0 and borrower prefills; a borrower owes this tick's
token and gets one follow-up launch).

Differences from the JAX package, none visible in tokens or counters:

  * PyTorch updates the caches in place, so a decode launch writes each
    row's new KV straight into the slot cache (or tail) instead of
    returning a cache that ``_merge_cache`` merges per slot.  Rows whose
    output the tick does not take — idle slots, and borrower slots in the
    launch issued before their wave — decode at a parked position
    (``prefix_len``, tail position 0) that their next prefill overwrites,
    so no launch touches another row's state or writes out of bounds.
  * Only what the local prefix-cache backend reaches is ported: decode mode
    ``"inflight"`` with fused admission.  A shed or partially placed chain,
    which only a bounded or sharded backend produces, raises
    ``NotImplementedError`` (so do the retry queue, plain fallback and
    pending tail inserts that follow from it).  Megastep and round-robin
    decode, split admission, throttling, faults and resharding are not
    ported yet.

Stats glossary: ``decode_launches`` counts decode launches (1 per tick, 2
on a tick whose borrower wave owes a token), ``launch_rows`` the active rows
they computed, ``host_syncs`` the host<->device barriers (``_sync``: one
per decode tick, one per prefill batch), ``gather_calls`` the prefix copies
admission made (0 in paged mode by contract), ``resident_kv_tokens_peak``
the per-tick high-water of KV tokens the active set holds resident, and
``pool_exhausted`` the chunks that ended a tick unfunded.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.model import Model, _embed, _final, _logits_fn
from repro_torch.serving.kv_cache import PagedKVPool
from repro_torch.serving.prefix_cache import (PrefixCache, chunk_chain_hashes,
                                              service_tick_percentiles)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (n,) int32
    max_new_tokens: int = 16
    out_tokens: list = dataclasses.field(default_factory=list)
    slot: int = -1
    pinned_pages: list = dataclasses.field(default_factory=list)
    prefill_skipped: int = 0
    prefill_computed: int = 0
    submit_tick: int = -1        # engine tick the request was queued
    admit_tick: int = -1         # tick it was served

    @property
    def service_ticks(self) -> int:
        """Admit latency in ticks (queue wait)."""
        if self.admit_tick < 0 or self.submit_tick < 0:
            return 0
        return self.admit_tick - self.submit_tick


def batched_continuation_prefill(cfg: ArchConfig, params, tokens, tok_lens,
                                 kv_prefix, prefix_lens):
    """One launch prefilling B continuation segments with per-row prefixes.

    tokens (B, Sb) int right-padded; tok_lens (B,) real segment lengths;
    kv_prefix: (k, v) each (L, B, Pb, KVH, Dh) right-padded per row, or None
    when no request has a prefix; prefix_lens (B,) int.  Returns (logits
    (B, V) at each row's LAST REAL token, new_k, new_v (L, B, Sb, KVH, Dh) —
    padded tail positions carry garbage; callers slice to ``tok_lens``).
    """
    b, s = tokens.shape
    dev = tokens.device
    h = _embed(cfg, params, tokens)
    positions = prefix_lens[:, None].long() + torch.arange(s, device=dev)[None, :]
    pb = 0 if kv_prefix is None else kv_prefix[0].shape[2]
    pidx = torch.arange(pb, device=dev)
    if pb:
        k_pos = torch.cat([pidx[None].expand(b, pb), positions], dim=1)
        k_valid = torch.cat([pidx[None] < prefix_lens[:, None],
                             torch.ones((b, s), dtype=torch.bool, device=dev)], dim=1)
    else:
        k_pos = positions
        k_valid = torch.ones((b, s), dtype=torch.bool, device=dev)
    ks, vs = [], []
    for l, (p_l, w_l, t_l) in enumerate(zip(params["blocks"], cfg.windows(),
                                            cfg.thetas())):
        x = tfm._norm(cfg, p_l["ln1"], h)
        q, k, v = attn_mod._project_qkv(p_l["attn"], x, cfg.n_heads, cfg.n_kv_heads,
                                        cfg.head_dim, positions, cfg.rope_kind, t_l)
        k_full, v_full = k, v
        if pb:
            k_full = torch.cat([kv_prefix[0][l], k], dim=1)
            v_full = torch.cat([kv_prefix[1][l], v], dim=1)
        ctx = attn_mod.masked_batch_attention(
            q, k_full, v_full, q_pos=positions, k_pos=k_pos, k_valid=k_valid,
            window=w_l, softcap=cfg.softcap, chunk=cfg.attn_chunk)
        a_out = ctx.reshape(b, s, cfg.n_heads * cfg.head_dim) @ p_l["attn"]["wo"]
        h = tfm._residual(cfg, p_l, h, x, a_out)
        ks.append(k)
        vs.append(v)
    h = _final(cfg, params, h)
    last = (tok_lens.long() - 1).clamp(0, s - 1)
    logits = _logits_fn(cfg, params)(h[torch.arange(b, device=dev), last])
    return logits, torch.stack(ks), torch.stack(vs)


def paged_batched_continuation_prefill(cfg: ArchConfig, params, tokens,
                                       tok_lens, pool_k, pool_v, page_idx,
                                       prefix_lens):
    """``batched_continuation_prefill`` with the per-row KV prefix read out
    of the paged pool inside the launch.

    page_idx (B, NPb) int names each row's prefix pages (right-padded —
    lanes at or past ``prefix_lens`` are masked, so padded entries may point
    anywhere in range).  pool_k/v are the pool planes (L, n_pages,
    page_tokens, KVH, Dh).  The gather is transient, so
    ``PagedKVPool.gather_calls`` stays 0.  When NPb·page_tokens equals the
    contiguous path's prefix bucket, the lane layout (and every reduction)
    matches the contiguous launch bit for bit.
    """
    b, npb = page_idx.shape
    shape = (cfg.n_layers, b, npb * pool_k.shape[2], *pool_k.shape[3:])
    flat = page_idx.reshape(-1).long()
    gk = pool_k[:, flat].reshape(shape)
    gv = pool_v[:, flat].reshape(shape)
    return batched_continuation_prefill(cfg, params, tokens, tok_lens, (gk, gv),
                                        prefix_lens)


def paged_decode_step(cfg: ArchConfig, params, tokens, tail_cache, pool_k,
                      pool_v, block_tables, prefix_lens, cur_lens, *, smax: int):
    """One in-flight decode launch straight from the paged pool.

    The paged analogue of ``model.decode_step``: each layer's attention
    walks the slot's block table over the pool plane for its prefix and
    reads/writes the slot-local tail for everything the row computed itself
    (``transformer.attn_block_decode_paged``; on a CUDA device one launch of
    the paged kernel per layer).  tokens (B, 1); tail_cache {"k","v"}
    (L, B, Tmax, KVH, Dh), updated in place; pool_k/v (L, n_pages,
    page_tokens, KVH, Dh); block_tables (B, NP) int32; prefix_lens/cur_lens
    (B,) int32.  Returns (logits (B, V), tail_cache).
    """
    h = _embed(cfg, params, tokens)
    for l, (p_l, w_l, t_l) in enumerate(zip(params["blocks"], cfg.windows(),
                                            cfg.thetas())):
        h, _, _ = tfm.attn_block_decode_paged(
            cfg, p_l, h, pool_k[l], pool_v[l], block_tables, tail_cache["k"][l],
            tail_cache["v"][l], prefix_lens, cur_lens, w_l, t_l, smax=smax)
    h = _final(cfg, params, h)
    return _logits_fn(cfg, params)(h[:, -1]), tail_cache


def _pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length() if n > 0 else 0


class ServeEngine:
    """Host-side continuous batching loop around the decode step."""

    def __init__(self, model: Model, params, *, slots: int = 4,
                 max_len: int = 512, prefix_cache: PrefixCache | None = None,
                 pool: PagedKVPool | None = None, eos_token: int = -1,
                 overlap_decode: bool = True, decode_mode: str = "inflight",
                 kv_mode: str = "contiguous", tail_tokens: int | None = None):
        if decode_mode != "inflight":
            raise NotImplementedError(f"decode_mode={decode_mode!r} is not yet "
                                      "ported; the port runs 'inflight'")
        if kv_mode not in ("contiguous", "paged"):
            raise ValueError(f"unknown kv_mode {kv_mode!r}")
        self.model = model
        self.cfg = model.cfg
        self.params = params
        self.device = next(params.parameters()).device
        self.slots = slots
        self.max_len = max_len
        self.eos = eos_token
        self.prefix_cache = prefix_cache
        self.pool = pool
        self.use_prefix = prefix_cache is not None and pool is not None
        self.kv_mode = kv_mode
        self.paged = kv_mode == "paged"
        if self.paged:
            if not self.use_prefix:
                raise ValueError("kv_mode='paged' needs a prefix cache and a "
                                 "pool (the pool is the resident KV store)")
            self.cache = pool.attach_slots(slots, max_len, tail_tokens)
            self.tail_cap = pool.tail_tokens
        else:
            self.cache = model.init_cache(slots, max_len, device=self.device)
        self.cur_len = np.zeros(slots, np.int32)
        self.active: dict[int, Request] = {}
        self._free_slots = list(range(slots))
        self.queue: list[Request] = []
        self.finished: list[Request] = []
        self.overlap_decode = overlap_decode
        self.ticks = 0               # completed engine ticks
        self.decode_launches = 0     # decode launches
        self.decode_tokens = 0       # tokens emitted by decode launches
        self.launch_rows = 0         # active rows computed across launches
        self.host_syncs = 0          # host<->device barriers (``_sync``)
        self.drain_launch_rows = 0   # launch_rows on drain-phase ticks
        self.drain_decode_tokens = 0  # decode tokens on drain-phase ticks
        self._last_tok = np.zeros((slots, 1), np.int32)  # per-slot last token
        self._service_ticks: list[int] = []  # per-request admit latencies
        self.pool_exhausted = 0      # chunks that ended a tick unfunded
        # resident-KV accounting (tokens that must stay in device memory for
        # the active set: per-slot KV + distinct pinned pool pages), sampled
        # once per decode tick
        self.resident_kv_tokens_peak = 0
        self._resident_tok_sum = 0
        self._resident_ticks = 0

    def _tensor(self, x: np.ndarray) -> torch.Tensor:
        """A host array as a tensor on the engine's device (a copy)."""
        return torch.from_numpy(np.array(x)).to(self.device)

    # -- admission -----------------------------------------------------------
    def submit(self, req: Request):
        # a request needs prompt+max_new_tokens positions; its last token
        # needs no KV write, so prompt+max_new == max_len is the last
        # admissible boundary
        need = len(req.prompt) + req.max_new_tokens
        if need > self.max_len:
            raise ValueError(
                f"request {req.rid}: prompt ({len(req.prompt)}) + "
                f"max_new_tokens ({req.max_new_tokens}) = {need} exceeds "
                f"max_len={self.max_len}")
        if req.submit_tick < 0:
            req.submit_tick = self.ticks
        self.queue.append(req)

    def _mark_active(self, req: Request):
        """Register ``req`` as serving; the first call stamps its admit tick
        and records the ticks-to-service sample."""
        self.active[req.rid] = req
        if req.admit_tick < 0:
            req.admit_tick = self.ticks
            waited = req.service_ticks
            self._service_ticks.append(waited)
            if self.prefix_cache is not None:
                self.prefix_cache.note_service_latency(waited)

    def _emit(self, req: Request, tok: int):
        """Append a token and keep the per-slot decode-token buffer current."""
        req.out_tokens.append(tok)
        if req.slot >= 0:
            self._last_tok[req.slot, 0] = tok

    def _check_tail(self, req: Request, rest: int):
        """Paged-mode tail bound: a slot's tail must hold its computed
        suffix plus every decoded token's KV (the last emitted token needs
        no write).  Caught before any state moves."""
        need = rest + req.max_new_tokens - 1
        if need > self.tail_cap:
            raise RuntimeError(
                f"request {req.rid}: computed suffix ({rest}) + "
                f"max_new_tokens-1 ({req.max_new_tokens - 1}) = {need} "
                f"exceeds tail_tokens={self.tail_cap}; raise tail_tokens "
                "(default max_len is always safe)")

    def _admit_plain(self, reqs: list[Request]):
        """Prompts shorter than a chunk (or no prefix cache): plain prefill."""
        emits = []
        for req in reqs:
            if self.paged:
                # no prefix: the whole prompt lives in the slot tail
                self._check_tail(req, len(req.prompt))
                self.pool.clear_slot(req.slot)
            batch = {"tokens": self._tensor(req.prompt[None].astype(np.int32))}
            logits, pc = self.model.prefill(self.params, batch)
            s = pc["k"].shape[2]
            self.cache["k"][:, req.slot, :s] = pc["k"][:, 0]
            self.cache["v"][:, req.slot, :s] = pc["v"][:, 0]
            req.prefill_computed = len(req.prompt)
            self.cur_len[req.slot] = len(req.prompt)
            self._mark_active(req)
            emits.append(torch.argmax(logits[0]))
        if reqs:
            for req, tok in zip(reqs, self._sync(emits)):
                self._emit(req, int(tok))

    # -- fused one-call admission -------------------------------------------
    def _admit_fused(self, reqs: list[Request]):
        """Admit a whole tick through ONE ``serve_chains`` call plus one
        batched prefill launch per dependency wave.  Runs the wave-0
        prefill inline and returns ``(pending, late)``: thunks for the
        borrower waves (``step`` interleaves them with the tick's decode
        launch) and the rids admitted in those waves.

        Page protocol per staged chunk, after the call:
          * inside the hit prefix      -> ``abort`` (chunk was cached)
          * insert executed, miss      -> ``commit`` + write content
          * insert absorbed, stored
            value != our page          -> ``abort`` (duplicate; recycle)
          * insert absorbed, stored
            value == our page          -> ``commit`` (the table holds OUR
            page, so it must live and we write its content)
        Evicted pages release before the reconciliation, so the pressure
        retry can re-fund unfunded inserts from this tick's own evictions
        (one extra ACCESS call, only when it fires).
        """
        ct = self.prefix_cache.chunk_tokens if self.use_prefix else 0
        pref = [r for r in reqs if self.use_prefix and len(r.prompt) >= ct]
        pref_ids = {id(r) for r in pref}
        plain = [r for r in reqs if id(r) not in pref_ids]

        chains = [chunk_chain_hashes(r.prompt, ct) for r in pref]
        # --- stage pages: intra-tick dedupe + reserve --------------------
        owner: dict[int, tuple[int, int, bool]] = {}  # hash -> (c, page, ok)
        staged: list[list[int]] = []
        own: list[list[bool]] = []
        for c, chain in enumerate(chains):
            vals: list[int] = []
            owns: list[bool] = []
            for h in chain:
                if h in owner:
                    _, pg, funded = owner[h]
                    if not funded:
                        break              # keep the funded run a prefix
                    vals.append(pg)
                    owns.append(False)     # borrowed: the owner's page
                else:
                    pg = self.pool.reserve()
                    if pg is None:
                        owner[h] = (c, -1, False)
                        break
                    owner[h] = (c, pg, True)
                    vals.append(pg)
                    owns.append(True)
            staged.append(vals)
            own.append(owns)

        evicted_set: set[int] = set()
        results = []
        if pref:
            results, evicted = self.prefix_cache.serve_chains(chains, staged)
            for r, chain in zip(results, chains):
                if r.shed or r.served_len < len(chain):
                    raise NotImplementedError(
                        "a shed or partially placed chain: only a bounded or "
                        "sharded backend sheds, and none is ported yet")
            evicted_set = set(evicted)
            for pg in evicted:
                self.pool.release(pg)

        # --- reconcile reservations --------------------------------------
        published: dict[int, tuple[int, int]] = {}   # hash -> (owner c, page)
        to_write: list[list[tuple[int, int]]] = [[] for _ in pref]
        for c, chain in enumerate(chains):
            r = results[c]
            for t, (pg, is_own) in enumerate(zip(staged[c], own[c])):
                if not is_own:
                    continue               # the owner reconciles this page
                if t < r.hitlen:
                    self.pool.abort(pg)    # chunk was already cached
                    continue
                absorbed, stored = r.puts[t]
                if absorbed and stored != pg:
                    self.pool.abort(pg)    # resident past the miss; recycle
                elif pg in evicted_set:
                    # inserted, then evicted by a LATER insert of this same
                    # call: the release above already freed the page — only
                    # clear the reservation, and neither write nor publish it
                    self.pool.commit(pg)
                else:
                    self.pool.commit(pg)
                    to_write[c].append((t, pg))
                    published[chain[t]] = (c, pg)

        # --- pressure retry: fund leftover inserts from recycled pages ----
        retry: list[tuple[int, int, list[int], list[int]]] = []
        for c, chain in enumerate(chains):
            start = max(results[c].hitlen, len(staged[c]))
            sub_h: list[int] = []
            sub_p: list[int] = []
            for t in range(start, len(chain)):
                if owner.get(chain[t], (c, -1, False))[0] != c:
                    break                  # another chain owns this chunk
                pg = self.pool.alloc()
                if pg is None:
                    # terminal: staging broke AND this tick's evictions could
                    # not re-fund the chunk — it ends the tick unpublished
                    self.pool_exhausted += 1
                    break
                sub_h.append(chain[t])
                sub_p.append(pg)
            if sub_h:
                retry.append((c, start, sub_h, sub_p))
        if retry:
            recycled = set(self.prefix_cache.insert_chains(
                [x[2] for x in retry], [x[3] for x in retry],
                depths=[x[1] for x in retry],
                chain_lens=[len(chains[x[0]]) for x in retry]))
            for pg in recycled:
                self.pool.release(pg)
            # a retry insert may have evicted a chunk the main call just
            # published: its page is free again — drop it from the write and
            # dedupe plans so nothing aliases its next owner
            published = {h: cp for h, cp in published.items() if cp[1] not in recycled}
            to_write = [[(t, pg) for (t, pg) in lst if pg not in recycled]
                        for lst in to_write]
            for c, start, sub_h, sub_p in retry:
                for j, (h, pg) in enumerate(zip(sub_h, sub_p)):
                    if pg not in recycled:  # absorbed retries were recycled
                        to_write[c].append((start + j, pg))
                        published[h] = (c, pg)

        # --- prefill jobs: effective prefix + dependency waves ------------
        jobs = []
        for c, (req, chain) in enumerate(zip(pref, chains)):
            r = results[c]
            pages = list(r.pages)
            deps: set[int] = set()
            if r.hitlen * ct >= len(req.prompt):
                # fully-cached chunk-aligned prompt: always compute at
                # least the last chunk
                pages = pages[:-1]
            if len(pages) == r.hitlen:     # untrimmed: try dedupe extension
                t = r.hitlen
                while t < len(chain) and (t + 1) * ct < len(req.prompt):
                    pub = published.get(chain[t])
                    if pub is None or pub[0] == c:
                        break
                    pages.append(pub[1])   # gather the owner's page
                    deps.add(pub[0])       # ... after the owner WRITES it
                    t += 1
            # register now so the tick's decode schedule already accounts
            # for the later-wave admits
            self.cur_len[req.slot] = len(req.prompt)
            self._mark_active(req)
            jobs.append({"req": req, "c": c, "pages": pages, "deps": deps})

        # a gatherer runs STRICTLY after every chain whose published pages it
        # gathers has written them: waves are a fixpoint over the edges
        wave_of = {j["c"]: 0 for j in jobs}
        for _ in range(len(jobs)):
            changed = False
            for j in jobs:
                w = max((wave_of[p] + 1 for p in j["deps"]), default=0)
                if w != wave_of[j["c"]]:
                    wave_of[j["c"]] = w
                    changed = True
            if not changed:
                break
        for j in jobs:
            j["wave"] = wave_of[j["c"]]

        self._prefill_wave([j for j in jobs if j["wave"] == 0], to_write, ct)
        pending = []
        late: set[int] = set()
        for w in range(1, max((j["wave"] for j in jobs), default=-1) + 1):
            jw = [j for j in jobs if j["wave"] == w]
            pending.append(functools.partial(self._prefill_wave, jw, to_write, ct))
            late.update(j["req"].rid for j in jw)

        self._admit_plain(plain)
        return pending, late

    def _prefill_wave(self, jobs, to_write, ct):
        """One bucket-padded batched prefill launch for ``jobs``."""
        if not jobs:
            return
        cfg = self.cfg
        plens, rests, gathered = [], [], []
        for j in jobs:
            req, pages = j["req"], j["pages"]
            plen = len(pages) * ct
            plens.append(plen)
            rests.append(len(req.prompt) - plen)
            if self.paged:
                self._check_tail(req, len(req.prompt) - plen)
            for pg in pages:
                self.pool.pin(pg)
                req.pinned_pages.append(pg)
            # paged mode never materializes the prefix copy: the launch
            # reads pool pages directly (borrowers included)
            gathered.append(self.pool.gather_pages(pages)
                            if pages and not self.paged else None)
        bp = _pow2(len(jobs))
        sb = _pow2(max(rests))
        pb = _pow2(max(plens)) if any(plens) else 0
        toks = np.zeros((bp, sb), np.int32)
        lens = np.ones(bp, np.int32)
        pl = np.zeros(bp, np.int32)
        for i, j in enumerate(jobs):
            toks[i, : rests[i]] = j["req"].prompt[plens[i]:]
            lens[i] = rests[i]
            pl[i] = plens[i]
        toks, lens, pl = self._tensor(toks), self._tensor(lens), self._tensor(pl)
        if pb and self.paged:
            # pow2 page-count bucket sized so the prefix lane count equals
            # the contiguous path's pb bucket (ct is a power of two), keeping
            # the launches bit-comparable
            npb = max(1, -(-pb // ct))
            pidx = np.zeros((bp, npb), np.int32)
            for i, j in enumerate(jobs):
                pidx[i, : len(j["pages"])] = j["pages"]
            logits, nk, nv = paged_batched_continuation_prefill(
                cfg, self.params, toks, lens, self.pool.k, self.pool.v,
                self._tensor(pidx), pl)
        elif pb:
            shape = (cfg.n_layers, bp, pb, cfg.n_kv_heads, cfg.head_dim)
            pk = torch.zeros(shape, dtype=self.pool.k.dtype, device=self.device)
            pv = torch.zeros(shape, dtype=self.pool.v.dtype, device=self.device)
            for i, g in enumerate(gathered):
                if g is not None:
                    pk[:, i, : plens[i]] = g[0]
                    pv[:, i, : plens[i]] = g[1]
            logits, nk, nv = batched_continuation_prefill(
                cfg, self.params, toks, lens, (pk, pv), pl)
        else:
            logits, nk, nv = batched_continuation_prefill(
                cfg, self.params, toks, lens, None, pl)
        # one batched fetch for the wave's first tokens
        emit_toks = self._sync(torch.argmax(logits, -1))

        for i, j in enumerate(jobs):
            req, c = j["req"], j["c"]
            slot = req.slot
            plen, rest = plens[i], rests[i]
            req.prefill_skipped = plen
            req.prefill_computed = rest
            if self.paged:
                # the slot holds only the tail; the prefix stays
                # pool-resident behind the block table
                self.cache["k"][:, slot, :rest] = nk[:, i, :rest]
                self.cache["v"][:, slot, :rest] = nv[:, i, :rest]
                self.pool.set_block_table(slot, j["pages"])
            else:
                if gathered[i] is not None:
                    self.cache["k"][:, slot, :plen] = gathered[i][0]
                    self.cache["v"][:, slot, :plen] = gathered[i][1]
                self.cache["k"][:, slot, plen: plen + rest] = nk[:, i, :rest]
                self.cache["v"][:, slot, plen: plen + rest] = nv[:, i, :rest]
            writes = to_write[c]
            if writes:
                kc = torch.stack([nk[:, i, t * ct - plen: (t + 1) * ct - plen]
                                  for t, _ in writes], dim=1)
                vc = torch.stack([nv[:, i, t * ct - plen: (t + 1) * ct - plen]
                                  for t, _ in writes], dim=1)
                self.pool.write_pages([pg for _, pg in writes], kc, vc)
            self.cur_len[slot] = len(req.prompt)
            self._mark_active(req)
            self._emit(req, int(emit_toks[i]))

    def _sync(self, x):
        """ONE host<->device barrier: fetch a tensor, or a sequence of
        same-shaped tensors stacked, in a single copy, and count it.  Every
        host fetch the engine makes (decode tokens, prefill argmaxes) goes
        through here, so ``stats()["host_syncs"]`` is the run's barrier
        count.  (Prefix-cache device calls are counted separately.)"""
        self.host_syncs += 1
        if not isinstance(x, torch.Tensor):
            x = torch.stack(list(x))
        return x.cpu().numpy()

    def _launch_decode(self, live: np.ndarray) -> torch.Tensor:
        """ONE decode launch over the per-slot token buffer; rows in ``live``
        decode at their ``cur_len``, the others at a parked position (see
        the module docstring).  Paged mode reads the pool planes and block
        tables at launch time, so pages a borrower wave published earlier
        this tick are visible.  Counts the launch and its active rows and
        returns the argmax tokens ON DEVICE — callers batch the fetch into
        their tick's single ``_sync``."""
        tokens = self._tensor(self._last_tok)
        if self.paged:
            plens = self.pool.prefix_lens
            curs = self._tensor(np.where(live, self.cur_len, plens).astype(np.int32))
            logits, _ = paged_decode_step(
                self.cfg, self.params, tokens, self.cache, self.pool.k, self.pool.v,
                self.pool.device_block_tables(), self._tensor(plens), curs,
                smax=self.max_len)
        else:
            curs = self._tensor(np.where(live, self.cur_len, 0).astype(np.int32))
            logits, _ = self.model.decode_step(self.params, tokens, self.cache, curs)
        self.decode_launches += 1
        self.launch_rows += len(self.active)
        return torch.argmax(logits, -1)

    # -- main loop -------------------------------------------------------------
    def step(self):
        """One engine tick: admit all free slots, then ONE decode launch that
        advances every active slot at its own ``cur_len``.  With
        ``overlap_decode`` (default) the decode launch is issued between the
        wave-0 and borrower prefill launches; borrower slots admitted by
        those later waves owe this tick's token and get one follow-up launch
        (the only case a tick costs 2 launches)."""
        admits = []
        while self._free_slots and self.queue:
            req = self.queue.pop(0)
            req.slot = self._free_slots.pop()
            admits.append(req)
        pending: list = []
        late: set[int] = set()
        if admits:
            pending, late = self._admit_fused(admits)
        if not self.active:
            for th in pending:
                th()
            self.ticks += 1
            return
        accept = np.zeros(self.slots, bool)
        for r in self.active.values():
            accept[r.slot] = True
        late_slots = {r.slot for r in self.active.values() if r.rid in late}
        nxt = np.zeros(self.slots, np.int64)
        if pending and self.overlap_decode:
            # decode launch first (ready slots), THEN the borrower waves
            accept_a = accept.copy()
            for s in late_slots:
                accept_a[s] = False
            nxt_a = self._launch_decode(accept_a)
            for th in pending:
                th()
            late_due = accept & ~accept_a
            nxt_b = None
            if late_due.any():
                # a borrower slot admitted by a later wave owes this tick's
                # token — follow-up launch now that its prefill ran
                nxt_b = self._launch_decode(accept)
            if nxt_b is None:
                nxt_a = self._sync(nxt_a)
            else:
                nxt_a, nxt_b = self._sync((nxt_a, nxt_b))
                nxt[late_due] = nxt_b[late_due]
            nxt[accept_a] = nxt_a[accept_a]
        else:
            for th in pending:
                th()
            nxt[accept] = self._sync(self._launch_decode(accept))[accept]
        done = []
        for r in self.active.values():
            if accept[r.slot]:
                tok = int(nxt[r.slot])
                self._emit(r, tok)
                self.cur_len[r.slot] += 1
                if (len(r.out_tokens) >= r.max_new_tokens or tok == self.eos
                        or self.cur_len[r.slot] >= self.max_len - 1):
                    done.append(r.rid)
        self.decode_tokens += int(accept.sum())
        if not admits and not self.queue:
            # drain-phase economics (nothing waiting)
            self.drain_launch_rows += len(self.active)
            self.drain_decode_tokens += int(accept.sum())
        if self.pool is not None and self.active:
            # resident-KV sample at the tick's high-water point (before
            # retirements): per-slot KV tokens (the full sequence in
            # contiguous mode, only the tail in paged mode) plus every
            # distinct pinned pool page
            slot_tok, pinned = 0, set()
            for r in self.active.values():
                slot_tok += int(self.cur_len[r.slot])
                if self.paged:
                    slot_tok -= int(self.pool.prefix_lens[r.slot])
                pinned.update(r.pinned_pages)
            resident = slot_tok + len(pinned) * self.pool.page_tokens
            self.resident_kv_tokens_peak = max(self.resident_kv_tokens_peak, resident)
            self._resident_tok_sum += resident
            self._resident_ticks += 1
        for rid in done:
            r = self.active.pop(rid)
            for pg in r.pinned_pages:
                self.pool.unpin(pg)
            if self.paged:
                self.pool.clear_slot(r.slot)
            self._free_slots.append(r.slot)
            self.finished.append(r)
        self.ticks += 1

    def run_until_done(self, max_ticks: int = 10000) -> int:
        """Drive ticks until every queued/active request retires; returns
        the tick count."""
        start = self.ticks
        while (self.queue or self.active) and self.ticks - start < max_ticks:
            self.step()
        return self.ticks - start

    def stats(self) -> dict:
        """Serve-side counters: launch economics and admit latency."""
        p50, p99 = service_tick_percentiles(self._service_ticks)
        return {
            "ticks": self.ticks,
            "decode_launches": self.decode_launches,
            "decode_tokens": self.decode_tokens,
            "launch_rows": self.launch_rows,
            "launches_per_token": (self.launch_rows / self.decode_tokens
                                   if self.decode_tokens else 0.0),
            "host_syncs": self.host_syncs,
            "host_syncs_per_token": (self.host_syncs / self.decode_tokens
                                     if self.decode_tokens else 0.0),
            "drain_launch_rows": self.drain_launch_rows,
            "drain_decode_tokens": self.drain_decode_tokens,
            "drain_launches_per_token": (
                self.drain_launch_rows / self.drain_decode_tokens
                if self.drain_decode_tokens else 0.0),
            "requests_serviced": len(self._service_ticks),
            "service_ticks_p50": p50,
            "service_ticks_p99": p99,
            "kv_mode": self.kv_mode,
            "pool_exhausted": self.pool_exhausted,
            "gather_calls": self.pool.gather_calls if self.pool is not None else 0,
            "resident_kv_tokens_peak": self.resident_kv_tokens_peak,
            "resident_kv_tokens_mean": (self._resident_tok_sum / self._resident_ticks
                                        if self._resident_ticks else 0.0),
            "resident_kv_bytes_peak": (self.resident_kv_tokens_peak
                                       * self._kv_bytes_per_token()),
            "reprefill_flops": getattr(self.prefix_cache, "reprefill_flops", 0),
            "evicted_cost": getattr(self.prefix_cache, "evicted_cost", 0),
        }

    def _kv_bytes_per_token(self) -> int:
        """Device bytes one token's K+V occupies across all layers."""
        return (2 * self.cfg.n_layers * self.cfg.n_kv_heads * self.cfg.head_dim
                * self.cache["k"].element_size())
