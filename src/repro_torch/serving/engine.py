"""Continuous-batching serve engine with multi-step-LRU prefix reuse.

Port of ``repro.serving.engine`` for every family of the JAX package: the
attention decoder (every FFN, MoE too), the hymba hybrid, xLSTM and the
Whisper encoder-decoder.  Flow per request:

  1. chunk-hash the prompt; find every admitted request's longest cached
     prefix — ``admit_mode``:
     * ``"fused"`` (default): one op-coded ``PrefixCache.serve_chains``
       call per tick finds the prefixes, promotes the hit chunks and
       inserts the rest with pre-staged page values;
     * ``"split"`` (the equivalence baseline): one LOOKUP and one GET call
       (``PrefixCache.lookup_chains``), a B = 1 prefill per request, then
       one ACCESS call (``insert_chains``) publishing the new chunks;
  2. make the cached pages the request's prefix KV — ``kv_mode``:
     * ``"contiguous"`` (the oracle): gather the pages into the slot's
       contiguous KV cache (a device copy per borrower);
     * ``"paged"``: pin the pages and record the slot's block table — zero
       copies; the pool is the single resident store;
  3. prefill the remaining tokens (fused admission: one batched launch per
     dependency wave; paged mode reads the prefix out of the pool inside
     the launch);
  4. write the new chunks' KV into their pages;
  5. decode — ``decode_mode``:
     * ``"inflight"`` (default): ONE launch per tick advances every active
       slot at its own position;
     * ``"roundrobin"`` (the legacy oracle schedule): one launch per tick,
       only the slots at the batch-minimum ``cur_len`` emit;
     * ``"megastep"``: a pure-decode tick runs a window of K ticks as one
       device program (``megastep_decode``) with one host sync, and the
       host replays the window's bookkeeping on the ticks the tokens
       would have been emitted on; ticks with admissions run in-flight.
     Paged decode walks the block table over the pool for the prefix and a
     slot-local tail for the rest; on a CUDA device each layer's attention
     is one launch of the paged kernel (``kernels/paged_attn.py``).

Fused admission keeps the JAX package's host-side page protocol line for
line: intra-tick prefix dedupe (one owner per distinct chunk, borrowers in
later waves), reserve-then-commit paging with evicted pages released first,
the pressure retry that funds leftover inserts from this tick's
evictions, and decode-overlapped borrower waves (the tick's decode launch
goes between the wave-0 and borrower prefills; a borrower owes this tick's
token and gets one follow-up launch).  The megastep planner
(``_plan_window``) is the JAX package's: K is the largest horizon in which
no host-visible event (an admission into a freed slot) can fall.

As in the JAX package, the prefix cache serves only attention decoders
without meta tokens (``mixer == "attn"``, not ``enc_dec``): hymba's Mamba
state and xLSTM's memories summarise the whole sequence, and a Whisper
decoder's KV depends on its request's audio, so a cached page of KV is not
a prefix any of them can resume from.  They admit through plain prefill,
which installs every leaf of the prefill's cache into the slot along the
leaf's batch axis (``cache_batch_axes``): the KV over meta tokens and
prompt where the family has one, hymba's Mamba ``h`` and ``conv``, xLSTM's
mLSTM and sLSTM state, Whisper's cross-attention KV ``xk``/``xv``.  A
Whisper request carries its audio as ``Request.frames`` (the stubbed conv
frontend's output), which the prefill encodes.  ``kv_mode="paged"`` raises
for these families.

Differences from the JAX package, none visible in tokens or counters:

  * PyTorch updates the KV caches in place, so a decode launch writes each
    row's new KV straight into the slot cache (or tail) instead of
    returning a cache that ``_merge_cache`` merges per slot.  A row whose
    output a launch discards decodes at a parked position chosen so that
    it writes nothing another step reads:
    - a row with no live state (an idle slot, a borrower slot in the
      launch issued before its wave, a row that retired inside a megastep
      window) parks at ``prefix_len`` (tail position 0) in paged mode and
      0 in contiguous mode, which its next prefill overwrites;
    - a row with live state that does not emit (a round-robin row above
      the batch minimum, a megastep row past the window's ``k_limit``)
      decodes at its OWN ``cur_len`` with its own last token: it writes
      exactly the KV that its next real step writes, bit for bit (rows are
      row-local and the inputs are the same), into a position nothing has
      read yet.
    Recurrent state has no position, so that shortcut would advance it:
    every cache leaf that ``cache_batch_axes`` names beyond ``k``, ``v``
    and the cross-attention ``xk``, ``xv`` (``state_leaves``: hymba's Mamba
    ``h`` and ``conv``, every xLSTM leaf) comes back from the decode step as
    a new tensor and is written back only for the rows that emit
    (``freeze_rows``: ``torch.where`` along the leaf's batch axis, written
    in place into the persistent tensor, so a captured graph keeps its
    storage).  The KV is never select-merged: that would copy the whole
    cache four times per step; nor is the cross-attention KV, which no
    decode step writes.
  * A megastep window is a Python loop of ``steps`` decode steps.  On a CUDA
    device the engine captures it as one ``torch.cuda.CUDAGraph`` per pow2
    ``steps`` bucket (the counterpart of the JAX package's one compile per
    ``steps``), at the bucket's first use after one eager warm-up on a
    side stream with ``k_limit = 0``, and replays it for every later window
    of that bucket.  The graph reads its operands from one persistent
    device vector (``k_limit`` among them, so one graph serves every K of
    its bucket; the block tables are copied in each window) filled by one
    host-to-device copy, and writes tokens, emit masks, ``cur_len`` and
    the live mask into one output tensor fetched by the window's single
    ``_sync``.  Kernel launch counters move at capture, not at replay, so
    the engine takes the capture's launches back and adds them on every
    replay.  If capture or replay fails the engine raises; CPU tensors run
    the same loop eagerly (the tests).

Sheds, retries and faults (a capacity-bounded ``ShardedCacheClient``
backend), the JAX package's protocol line for line:

  * A shed chain releases its slot and its staged pages and moves to
    ``retry_queue``, which the next tick admits ahead of the queue; after
    ``max_shed_retries`` sheds a request falls back to plain prefill
    (``fallbacks``), so every request completes.  A shed owner of a chunk a
    served borrower inserted hands the page to that borrower, which writes
    it.  Split admission has no retry: there a shed probe is a forced miss
    and a shed insert returns its page.
  * A split-placing backend sheds only a chunk suffix: the request is
    served this tick, its tail pages commit and are written, and their
    inserts re-run in one ``insert_chains`` call at the next tick boundary
    (``_flush_pending_inserts``).
  * ``throttle_threshold`` defers new admissions whose home shards report
    pressure at or above it (``ShardedCacheClient.chain_pressure``), at
    most ``max_throttle_ticks`` times each; retries and fallbacks are never
    throttled, and an all-hot queue admits its front request.
  * ``mark_degraded``, ``reshard`` and ``apply_fault`` change the backend
    between ticks; orphaned pages go back to the pool under its
    deferred-free contract (a pinned page frees when its last reader
    unpins).  ``run_until_done(fault_plan=)`` applies a ``FaultPlan`` at
    tick boundaries and caps each megastep window at the next fault tick.

Stats glossary: ``decode_launches`` counts decode launches (1 per tick, 2
on a tick whose borrower wave owes a token, 1 per megastep window),
``launch_rows`` the active rows they computed (a window counts its rows
once), ``megastep_windows``/``mean_window`` the windows and the ticks each
covered on average, ``host_syncs`` the host<->device barriers (``_sync``:
one per decode tick or window, one per prefill batch), ``gather_calls`` the
prefix copies admission made (0 in paged mode by contract),
``resident_kv_tokens_peak`` the per-tick high-water of KV tokens the active
set holds resident, and ``pool_exhausted`` the chunks that ended a tick
unfunded.  ``fallbacks``/``fallback_rate`` count requests that exhausted
their shed retries, ``throttled_admissions`` the queue entries throttling
skipped, and ``split_chains``, ``partial_sheds``, ``slab_occupancy_peak``
and ``partial_served`` mirror a sharded backend's and the prefix cache's
split-placement counters (0 without one).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import paged_attn
from repro_torch.models import attention as attn_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.model import (Model, _embed, _final, _logits_fn,
                                      cache_batch_axes)
from repro_torch.serving.kv_cache import PagedKVPool
from repro_torch.serving.prefix_cache import (PrefixCache, chunk_chain_hashes,
                                              service_tick_percentiles)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (n,) int32
    max_new_tokens: int = 16
    frames: torch.Tensor | None = None  # (enc_len, d_model) bf16: an enc_dec
                                        # model's audio frames, else None
    out_tokens: list = dataclasses.field(default_factory=list)
    slot: int = -1
    pinned_pages: list = dataclasses.field(default_factory=list)
    prefill_skipped: int = 0
    prefill_computed: int = 0
    shed_count: int = 0          # times a bounded backend shed this chain
    force_plain: bool = False    # bypass the prefix cache (shed fallback)
    submit_tick: int = -1        # engine tick the request was queued
    admit_tick: int = -1         # tick it was served (after its sheds)
    throttle_ticks: int = 0      # admission scans that skipped it (throttling)
    chain_hashes: list | None = None  # chunk-chain hashes, kept for throttle scans

    @property
    def service_ticks(self) -> int:
        """Admit latency in ticks (queue wait and shed retries)."""
        if self.admit_tick < 0 or self.submit_tick < 0:
            return 0
        return self.admit_tick - self.submit_tick


def continuation_prefill(cfg: ArchConfig, params, tokens, kv_prefix,
                         prefix_len: int):
    """Prefill ``tokens`` (B = 1, S_rest) on top of an existing KV prefix.

    kv_prefix: (k, v) each (L, 1, prefix_len, KVH, Dh), or None.  Returns
    (logits at the last token (V,), new_k, new_v (L, 1, S_rest, KVH, Dh)).
    """
    b, s = tokens.shape
    h = _embed(cfg, params, tokens)
    positions = prefix_len + torch.arange(s, device=tokens.device)[None, :]
    # M-RoPE rotates by (B, 3, S) streams, as the JAX model path does.  The
    # port departs here on purpose from the JAX engine, which hands M-RoPE
    # the (B, S) positions (src/repro/serving/engine.py:260, :329): its
    # _mrope_pos (src/repro/models/layers.py:214-217) then reads the batch
    # axis as the stream axis and fills the missing streams with NaN.
    rope_pos = attn_mod.rope_positions(positions, cfg.rope_kind)
    ks, vs = [], []
    for l, (p_l, w_l, t_l) in enumerate(zip(params["blocks"], cfg.windows(),
                                            cfg.thetas())):
        x = tfm._norm(cfg, p_l["ln1"], h)
        q, k, v = attn_mod._project_qkv(p_l["attn"], x, cfg.n_heads, cfg.n_kv_heads,
                                        cfg.head_dim, rope_pos, cfg.rope_kind, t_l)
        k_full, v_full = k, v
        if kv_prefix is not None:
            k_full = torch.cat([kv_prefix[0][l], k], dim=1)
            v_full = torch.cat([kv_prefix[1][l], v], dim=1)
        ctx = attn_mod.chunked_attention(
            q, k_full, v_full, causal=True, window=w_l, softcap=cfg.softcap,
            chunk=cfg.attn_chunk, q_offset=prefix_len)
        a_out = ctx.reshape(b, s, cfg.n_heads * cfg.head_dim) @ p_l["attn"]["wo"]
        h = tfm._residual(cfg, p_l, h, x, a_out)
        ks.append(k)
        vs.append(v)
    h = _final(cfg, params, h)
    return _logits_fn(cfg, params)(h[:, -1])[0], torch.stack(ks), torch.stack(vs)


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
    # M-RoPE's (B, 3, S) streams, as in continuation_prefill; masks keep (B, S)
    rope_pos = attn_mod.rope_positions(positions, cfg.rope_kind)
    ks, vs = [], []
    for l, (p_l, w_l, t_l) in enumerate(zip(params["blocks"], cfg.windows(),
                                            cfg.thetas())):
        x = tfm._norm(cfg, p_l["ln1"], h)
        q, k, v = attn_mod._project_qkv(p_l["attn"], x, cfg.n_heads, cfg.n_kv_heads,
                                        cfg.head_dim, rope_pos, cfg.rope_kind, t_l)
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


# top-level cache leaves that are not recurrent state: the KV a decode step
# writes in place at a position, and the cross-attention KV that admission
# writes and no decode step touches
POSITIONAL = ("k", "v")
CROSS_KV = ("xk", "xv")


def state_leaves(axes: dict, path: tuple = ()) -> list:
    """(path, batch axis) of every recurrent cache leaf in ``axes`` (the
    structure of ``model.cache_batch_axes``): all but ``POSITIONAL`` and
    ``CROSS_KV``."""
    out = []
    for name, ax in axes.items():
        if isinstance(ax, dict):
            out += state_leaves(ax, path + (name,))
        elif path or name not in POSITIONAL + CROSS_KV:
            out.append((path + (name,), ax))
    return out


def _leaf(tree: dict, path: tuple) -> torch.Tensor:
    for name in path:
        tree = tree[name]
    return tree


def freeze_rows(cache: dict, new: dict, leaves: list, keep) -> None:
    """The freeze: each recurrent leaf (``state_leaves``) of ``cache`` takes
    ``new``'s rows where ``keep`` (B,) bool (a tensor, or a host array) is
    set and keeps its own elsewhere, written in place (one select pass per
    leaf, its output the leaf itself)."""
    if not leaves:
        return
    keep = torch.as_tensor(keep, device=_leaf(cache, leaves[0][0]).device)
    for path, ax in leaves:
        old = _leaf(cache, path)
        shape = [1] * old.ndim
        shape[ax] = keep.shape[0]
        torch.where(keep.view(shape), _leaf(new, path), old, out=old)


def megastep_decode(decode_fn, params, last_tok, cache, cur_lens, live, rem, *,
                    eos: int, max_len: int, steps: int, k_limit, park,
                    state=()):
    """Up to ``steps`` in-flight decode ticks in one device program.

    ``decode_fn(params, tokens, cache, cur_lens) -> (logits, cache)`` is a
    row-local decode step that writes each row's new KV at its
    ``cur_lens`` entry in place (``model.decode_step`` or a paged wrapper)
    and returns the recurrent leaves ``state`` (``state_leaves``) new;
    after each step those take the new rows only where a row emits
    (``freeze_rows``).
    Each step: decode -> argmax -> ``emit = live & (i < k_limit)`` ->
    advance ``last_tok``/``cur_len``/``rem`` where emitting -> retire a row
    (live -> False) after the emission that exhausts ``rem`` (callers pass
    min(max_new budget, max_len-1 - cur_len)), emits ``eos``, or reaches
    ``max_len - 1``: the in-flight retirement test verbatim.  A live row
    decodes at its own ``cur_len`` (past ``k_limit`` it rewrites the KV its
    next real step writes, bit for bit, from its frozen state); a retired
    or idle row at ``park``.

    ``last_tok`` (B, 1) int32; ``cur_lens``/``rem``/``park`` (B,) int32;
    ``live`` (B,) bool; ``k_limit`` an int or a 0-d int tensor on the
    device (so one captured ``steps`` bucket serves every window size).
    Makes no host sync.  Returns ``(last_tok, cur_lens, live, toks, emits)``
    with ``toks`` (steps, B) int32 (-1 where a row did not emit) and
    ``emits`` (steps, B) bool.
    """
    lt, cu, lv, rm = last_tok, cur_lens, live, rem
    toks, emits = [], []
    for i in range(steps):
        emit = lv & (k_limit > i)
        logits, new = decode_fn(params, lt, cache, torch.where(lv, cu, park))
        freeze_rows(cache, new, state, emit)
        tok = torch.argmax(logits, -1).to(torch.int32)
        lt = torch.where(emit[:, None], tok[:, None], lt)
        cu = cu + emit.to(cu.dtype)
        rm = rm - emit.to(rm.dtype)
        lv = lv & ~(emit & ((rm <= 0) | (tok == eos) | (cu >= max_len - 1)))
        toks.append(torch.where(emit, tok, -1))
        emits.append(emit)
    return lt, cu, lv, torch.stack(toks), torch.stack(emits)


def _pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length() if n > 0 else 0


@dataclasses.dataclass
class WindowGraph:
    """One captured megastep bucket: the graph, its output tensor (the
    packed (2·steps + 2, slots) int32 result) and the kernel launches it
    holds, by counter name."""
    graph: "torch.cuda.CUDAGraph"
    out: torch.Tensor
    launches: dict


class ServeEngine:
    """Host-side continuous batching loop around the decode step."""

    def __init__(self, model: Model, params, *, slots: int = 4,
                 max_len: int = 512, prefix_cache: PrefixCache | None = None,
                 pool: PagedKVPool | None = None, eos_token: int = -1,
                 admit_batching: bool = True, admit_mode: str | None = None,
                 overlap_decode: bool = True, decode_mode: str = "inflight",
                 kv_mode: str = "contiguous", max_window: int = 16,
                 tail_tokens: int | None = None, max_shed_retries: int = 3,
                 throttle_threshold: float | None = None,
                 max_throttle_ticks: int = 8):
        if decode_mode not in ("inflight", "roundrobin", "megastep"):
            raise ValueError(f"unknown decode_mode {decode_mode!r}")
        if kv_mode not in ("contiguous", "paged"):
            raise ValueError(f"unknown kv_mode {kv_mode!r}")
        # "fused" (default): one cache call + batched prefill per tick;
        # "split": LOOKUP + GET, per-request prefill, ACCESS (the baseline)
        admit_mode = admit_mode or ("fused" if admit_batching else "split")
        if admit_mode not in ("fused", "split"):
            raise ValueError(f"unknown admit_mode {admit_mode!r}")
        if max_window < 1:
            raise ValueError(f"max_window must be >= 1, got {max_window}")
        self.model = model
        self.cfg = model.cfg
        self.params = params
        self.device = next(params.parameters()).device
        self.slots = slots
        self.max_len = max_len
        self.eos = eos_token
        self.prefix_cache = prefix_cache
        self.pool = pool
        # the prefix cache serves attention decoders without meta tokens only
        self.use_prefix = (prefix_cache is not None and pool is not None
                           and self.cfg.mixer == "attn" and not self.cfg.enc_dec
                           and self.cfg.meta_tokens == 0)
        self.kv_mode = kv_mode
        self.paged = kv_mode == "paged"
        # recurrent cache leaves: written back only for the rows that emit
        self._state = state_leaves(cache_batch_axes(self.cfg))
        if self.paged:
            if not self.use_prefix:
                raise ValueError("kv_mode='paged' needs a prefix cache and a "
                                 "pool (the pool is the resident KV store) on "
                                 "an attention decoder without meta tokens")
            self.cache = pool.attach_slots(slots, max_len, tail_tokens)
            self.tail_cap = pool.tail_tokens
        else:
            self.cache = model.init_cache(slots, max_len, device=self.device)
        self.cur_len = np.zeros(slots, np.int32)
        self.active: dict[int, Request] = {}
        self._free_slots = list(range(slots))
        self.queue: list[Request] = []
        self.retry_queue: list[Request] = []   # shed chains, admitted first
        self.finished: list[Request] = []
        self.max_shed_retries = max_shed_retries
        # owner-aware admission throttling (None: off)
        self.throttle_threshold = throttle_threshold
        self.max_throttle_ticks = max_throttle_ticks
        self.throttled_admissions = 0
        # tail-chunk inserts a split-placing backend shed, re-run at the next
        # tick boundary in one batched call
        self._pending_inserts: list[dict] = []
        self.fallbacks = 0           # requests that exhausted shed retries
        self.fault_log: list[tuple[int, str]] = []  # (tick, event) applied
        self.admit_batching = admit_batching
        self.admit_mode = admit_mode
        self.overlap_decode = overlap_decode
        self.decode_mode = decode_mode
        self.max_window = int(max_window)
        # megastep on a CUDA device: one captured graph per pow2 ``steps``
        # bucket, all reading one persistent operand vector (laid out by
        # ``_window_inputs``) filled from a pinned host copy
        self.window_graphs: dict[int, WindowGraph] = {}
        self._win_w = -(-slots // 4) * 4   # 16-byte aligned segment width
        self._win_in: torch.Tensor | None = None
        self._win_stage: torch.Tensor | None = None
        self.ticks = 0               # completed engine ticks
        self.decode_launches = 0     # decode launches (a window is one)
        self.decode_tokens = 0       # tokens emitted by decode launches
        self.launch_rows = 0         # active rows computed across launches
        self.megastep_windows = 0    # fused windows run (megastep mode)
        self._window_ticks_sum = 0   # ticks covered by those windows
        self.window_steps = 0        # decode steps they ran (pow2 buckets)
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
        if (req.frames is None) == self.cfg.enc_dec:
            raise ValueError(f"request {req.rid}: an encoder-decoder request "
                             "needs its frames, any other none")
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
        """Prompts shorter than a chunk (or no prefix cache): plain prefill,
        its cache installed into the slot leaf by leaf."""
        emits = []
        for req in reqs:
            if self.paged:
                # no prefix: the whole prompt lives in the slot tail
                self._check_tail(req, len(req.prompt))
                self.pool.clear_slot(req.slot)
            batch = {"tokens": self._tensor(req.prompt[None].astype(np.int32))}
            if req.frames is not None:
                batch["frames"] = req.frames[None].to(self.device)
            logits, pc = self.model.prefill(self.params, batch)
            for name in POSITIONAL:      # the prompt's (and meta tokens') KV
                if name in pc:
                    self.cache[name][:, req.slot, :pc[name].shape[2]] = pc[name][:, 0]
            for name in CROSS_KV:
                if name in pc:
                    self.cache[name][:, req.slot] = pc[name][:, 0]
            for path, ax in self._state:
                _leaf(self.cache, path).select(ax, req.slot).copy_(
                    _leaf(pc, path).select(ax, 0))
            req.prefill_computed = len(req.prompt)
            self.cur_len[req.slot] = len(req.prompt)
            self._mark_active(req)
            emits.append(torch.argmax(logits[0]))
        if reqs:
            for req, tok in zip(reqs, self._sync(emits)):
                self._emit(req, int(tok))

    # -- split admission (the baseline) ----------------------------------------
    def _admit_split(self, reqs: list[Request]):
        """Admission in at most 3 prefix-cache device calls: one LOOKUP and
        one GET call (``lookup_chains``) over every request's chunk chain,
        one B = 1 prefill per request, then one ACCESS call
        (``insert_chains``) publishing all new chunks.  Evicted pages
        recycle to the pool only after all of the tick's admissions, so a
        near-full pool may defer a page's reuse to the next tick."""
        cfg = self.cfg
        ct = self.prefix_cache.chunk_tokens if self.use_prefix else 0
        pref = [r for r in reqs if self.use_prefix and len(r.prompt) >= ct
                and not r.force_plain]
        pref_ids = {id(r) for r in pref}
        plain = [r for r in reqs if id(r) not in pref_ids]

        chains = [chunk_chain_hashes(r.prompt, ct) for r in pref]
        pages_per = self.prefix_cache.lookup_chains(chains) if pref else []
        emits = []                 # per-request argmaxes; ONE batched fetch
        ins_chains: list[list[int]] = []
        ins_pages: list[list[int]] = []
        ins_depths: list[int] = []
        ins_lens: list[int] = []
        for req, chain, pages in zip(pref, chains, pages_per):
            slot = req.slot
            if len(pages) * ct >= len(req.prompt):
                # fully-cached chunk-aligned prompt: always compute at least
                # the last chunk (its re-publish is absorbed as a duplicate
                # and the staged page recycles)
                pages = pages[:-1]
            plen = len(pages) * ct
            req.prefill_skipped = plen
            rl = len(req.prompt) - plen
            req.prefill_computed = rl
            pk = pv = None
            for pg in pages:
                self.pool.pin(pg)
                req.pinned_pages.append(pg)
            if pages and not self.paged:
                pk, pv = self.pool.gather_pages(pages)
                pk, pv = pk[:, None], pv[:, None]          # (L, 1, plen, ...)
            rest = self._tensor(req.prompt[None, plen:].astype(np.int32))
            if self.paged:
                self._check_tail(req, rl)
            if self.paged and pages:
                # zero-copy: the launch reads the prefix out of the pool
                logits, nk, nv = paged_batched_continuation_prefill(
                    cfg, self.params, rest, self._tensor(np.array([rl], np.int32)),
                    self.pool.k, self.pool.v,
                    self._tensor(np.array(pages, np.int32)[None]),
                    self._tensor(np.array([plen], np.int32)))
                logits = logits[0]
            elif pk is not None:
                logits, nk, nv = continuation_prefill(cfg, self.params, rest,
                                                      (pk, pv), plen)
            else:
                logits, nk, nv = continuation_prefill(cfg, self.params, rest, None, 0)
            if self.paged:
                # the slot holds only the tail; the prefix stays pool-resident
                self.cache["k"][:, slot, :rl] = nk[:, 0, :rl]
                self.cache["v"][:, slot, :rl] = nv[:, 0, :rl]
                self.pool.set_block_table(slot, pages)
            else:
                if pk is not None:
                    self.cache["k"][:, slot, :plen] = pk[:, 0]
                    self.cache["v"][:, slot, :plen] = pv[:, 0]
                self.cache["k"][:, slot, plen: plen + rl] = nk[:, 0, :rl]
                self.cache["v"][:, slot, plen: plen + rl] = nv[:, 0, :rl]
            # stage the new chunks' pages; published in one batch below
            new_pages = []
            for _ in range(len(req.prompt) // ct - len(pages)):
                pg = self.pool.alloc()
                if pg is None:
                    # near-full pool: the rest of this chain's chunks go
                    # unpublished this tick
                    self.pool_exhausted += 1
                    break
                new_pages.append(pg)
            if new_pages:
                npg = len(new_pages)
                shape = (cfg.n_layers, npg, ct, cfg.n_kv_heads, cfg.head_dim)
                self.pool.write_pages(new_pages, nk[:, 0, : npg * ct].reshape(shape),
                                      nv[:, 0, : npg * ct].reshape(shape))
                ins_chains.append(chain[len(pages): len(pages) + npg])
                ins_pages.append(new_pages)
                ins_depths.append(len(pages))
                ins_lens.append(len(chain))
            self.cur_len[slot] = len(req.prompt)
            self._mark_active(req)
            emits.append(torch.argmax(logits))
        if pref:
            for req, tok in zip(pref, self._sync(emits)):
                self._emit(req, int(tok))
        if ins_chains:
            for pg in self.prefix_cache.insert_chains(
                    ins_chains, ins_pages, depths=ins_depths, chain_lens=ins_lens):
                self.pool.release(pg)
        self._admit_plain(plain)

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
          * owner chain SHED           -> promote the first served borrower
            whose insert carried the page (commit; the borrower writes the
            content), else ``abort``
          * past a split placement's
            served boundary            -> ``commit`` + write; the insert
            re-runs at the next tick boundary (unless a served borrower's
            insert landed it: then that borrower is promoted)
        Evicted pages release before the reconciliation, so the pressure
        retry can re-fund unfunded inserts from this tick's own evictions
        (one extra ACCESS call, only when it fires).
        """
        ct = self.prefix_cache.chunk_tokens if self.use_prefix else 0
        pref = [r for r in reqs if self.use_prefix and len(r.prompt) >= ct
                and not r.force_plain]
        pref_ids = {id(r) for r in pref}
        plain = [r for r in reqs if id(r) not in pref_ids]

        chains = [chunk_chain_hashes(r.prompt, ct) for r in pref]
        # --- stage pages: intra-tick dedupe + reserve --------------------
        owner: dict[int, tuple[int, int, bool]] = {}  # hash -> (c, page, ok)
        borrowers: dict[int, list[tuple[int, int]]] = {}  # hash -> [(c, t)]
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
                    borrowers.setdefault(h, []).append((c, len(vals)))
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
            results, evicted = self.prefix_cache.serve_chains(
                chains, staged, retries=[r.shed_count > 0 for r in pref])
            evicted_set = set(evicted)
            for pg in evicted:
                self.pool.release(pg)

        def promote(c, t, pg, resident_abort):
            """Hand owner page ``pg`` of chunk ``chains[c][t]`` to the first
            served borrower whose insert executed; returns whether one
            took it.  A borrower whose insert found the chunk resident
            under another page ends the search (``resident_abort``: the
            page aborts back)."""
            for c2, t2 in borrowers.get(chains[c][t], []):
                r2 = results[c2]
                if r2.shed or t2 >= len(r2.puts) or r2.puts[t2] is None:
                    continue               # borrower row did not insert
                absorbed2, stored2 = r2.puts[t2]
                if absorbed2 and stored2 != pg:
                    if resident_abort:
                        self.pool.abort(pg)
                        return True
                    return False
                self.pool.commit(pg)
                if pg not in evicted_set:
                    to_write[c2].append((t2, pg))
                    published[chains[c][t]] = (c2, pg)
                return True
            return False

        # --- reconcile reservations --------------------------------------
        published: dict[int, tuple[int, int]] = {}   # hash -> (owner c, page)
        to_write: list[list[tuple[int, int]]] = [[] for _ in pref]
        pend_tail: dict[int, list[tuple[int, int, int]]] = {}  # c -> (t, h, pg)
        for c, chain in enumerate(chains):
            r = results[c]
            for t, (pg, is_own) in enumerate(zip(staged[c], own[c])):
                if not is_own:
                    continue               # the owner reconciles this page
                if r.shed:
                    # the owner never reached the device, but a served
                    # borrower's CHAIN_PUT may have inserted our page id
                    if not promote(c, t, pg, resident_abort=False):
                        self.pool.abort(pg)
                    continue
                if t < r.hitlen:
                    self.pool.abort(pg)    # chunk was already cached
                    continue
                if r.puts[t] is None:
                    # split placement shed the chunk suffix: the owner is
                    # served (its prefill computes the chunk) but the insert
                    # never reached the table; keep the page, write it, and
                    # re-run the insert next tick
                    if not promote(c, t, pg, resident_abort=True):
                        self.pool.commit(pg)
                        to_write[c].append((t, pg))
                        published[chain[t]] = (c, pg)
                        pend_tail.setdefault(c, []).append((t, chain[t], pg))
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

        # --- partial tails: one pending insert per contiguous depth run ---
        for c, rows in pend_tail.items():
            runs: list[list[tuple[int, int, int]]] = []
            for t, h, pg in rows:
                if not runs or t != runs[-1][-1][0] + 1:
                    runs.append([])
                runs[-1].append((t, h, pg))
            for run in runs:
                self._pending_inserts.append({
                    "hashes": [x[1] for x in run], "pages": [x[2] for x in run],
                    "depth": run[0][0], "chain_len": len(chains[c])})

        # --- shed chains: release the slot, retry next tick ---------------
        for c, req in enumerate(pref):
            if results[c].shed:
                req.shed_count += 1
                self._free_slots.append(req.slot)
                req.slot = -1
                self.retry_queue.append(req)

        # --- pressure retry: fund leftover inserts from recycled pages ----
        retry: list[tuple[int, int, list[int], list[int]]] = []
        for c, chain in enumerate(chains):
            r = results[c]
            if r.shed or r.served_len < len(chain):
                # a partially placed chain's tail belongs to the pending
                # insert flush: re-inserting it now would land chunks out of
                # prefix order on the saturated slab
                continue
            start = max(r.hitlen, len(staged[c]))
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
            if r.shed:
                continue
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

    def _launch_decode(self, live: np.ndarray, emit: np.ndarray) -> torch.Tensor:
        """ONE decode launch over the per-slot token buffer; rows in ``live``
        decode at their ``cur_len``, the others at a parked position (see
        the module docstring); only the rows in ``emit`` keep their advanced
        recurrent state.  Paged mode reads the pool planes and block
        tables at launch time, so pages a borrower wave published earlier
        this tick are visible.  Counts the launch and its active rows and
        returns the argmax tokens ON DEVICE — callers batch the fetch into
        their tick's single ``_sync``."""
        tokens = self._tensor(self._last_tok)
        if self.paged:
            plens = self.pool.prefix_lens
            curs = self._tensor(np.where(live, self.cur_len, plens).astype(np.int32))
            logits, new = paged_decode_step(
                self.cfg, self.params, tokens, self.cache, self.pool.k, self.pool.v,
                self.pool.device_block_tables(), self._tensor(plens), curs,
                smax=self.max_len)
        else:
            curs = self._tensor(np.where(live, self.cur_len, 0).astype(np.int32))
            logits, new = self.model.decode_step(self.params, tokens, self.cache, curs)
        freeze_rows(self.cache, new, self._state, emit)
        self.decode_launches += 1
        self.launch_rows += len(self.active)
        return torch.argmax(logits, -1)

    # -- main loop -------------------------------------------------------------
    def step(self, window_cap: int | None = None):
        """One engine tick: admit all free slots, then ONE decode launch.
        In megastep mode a pure-decode tick instead runs a K-tick window
        (``_megastep``) and advances ``self.ticks`` by K; ``window_cap``
        bounds K.

        Admission goes through one fused call (``admit_mode="fused"``) or
        the split path; ``admit_batching=False`` admits one request at a
        time through the split path.  Shed requests re-admit from
        ``retry_queue`` ahead of the queue; one shed ``max_shed_retries``
        times falls back to plain prefill.  Pending tail inserts of last
        tick's partial placements run first.  Decode: in-flight (every
        active slot emits at its own ``cur_len``) or round-robin (only the
        slots at the batch-minimum length emit).  With ``overlap_decode`` (default) the
        decode launch is issued between the wave-0 and borrower prefill
        launches; borrower slots admitted by those later waves owe this
        tick's token and get one follow-up launch (the only case a tick
        costs 2 launches)."""
        self._flush_pending_inserts()
        admits = []
        while self._free_slots and (self.retry_queue or self.queue):
            req = (self.retry_queue.pop(0) if self.retry_queue
                   else self._pop_admission())
            if req.shed_count >= self.max_shed_retries and not req.force_plain:
                # guaranteed progress: plain (cache-less) prefill, counted;
                # the request keeps its submit tick, so its service ticks
                # span every shed
                req.force_plain = True
                self.fallbacks += 1
                if self.prefix_cache is not None:
                    self.prefix_cache.note_fallback()
            req.slot = self._free_slots.pop()
            admits.append(req)
        pending: list = []
        late: set[int] = set()
        if admits:
            if not self.admit_batching:
                for req in admits:
                    self._admit_split([req])
            elif self.admit_mode == "fused":
                pending, late = self._admit_fused(admits)
            else:
                self._admit_split(admits)
        if not self.active:
            for th in pending:
                th()
            self.ticks += 1
            return
        if (self.decode_mode == "megastep" and not admits and not pending
                and not self._pending_inserts):
            # pure-decode tick: nothing host-visible can happen for K
            # ticks, so the whole window runs as one device program
            self._megastep(self._plan_window(window_cap))
            return
        # ``ready`` rows decode at their own cur_len; ``accept`` rows emit
        accept = np.zeros(self.slots, bool)
        for r in self.active.values():
            accept[r.slot] = True
        ready = accept.copy()
        if self.decode_mode == "roundrobin":
            cur = min(int(self.cur_len[r.slot]) for r in self.active.values())
            accept &= self.cur_len == cur
        late_slots = [r.slot for r in self.active.values() if r.rid in late]
        nxt = np.zeros(self.slots, np.int64)
        if pending and self.overlap_decode:
            # decode launch first (ready slots), THEN the borrower waves
            ready_a = ready.copy()
            ready_a[late_slots] = False
            accept_a = accept & ready_a
            nxt_a = self._launch_decode(ready_a, accept_a)
            for th in pending:
                th()
            late_due = accept & ~accept_a
            nxt_b = None
            if late_due.any():
                # a borrower slot admitted by a later wave owes this tick's
                # token — follow-up launch now that its prefill ran
                nxt_b = self._launch_decode(ready, late_due)
            if nxt_b is None:
                nxt_a = self._sync(nxt_a)
            else:
                nxt_a, nxt_b = self._sync((nxt_a, nxt_b))
                nxt[late_due] = nxt_b[late_due]
            nxt[accept_a] = nxt_a[accept_a]
        else:
            for th in pending:
                th()
            nxt[accept] = self._sync(self._launch_decode(ready, accept))[accept]
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
        if not admits and not self.queue and not self.retry_queue:
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
            self._sample_resident(slot_tok + len(pinned) * self.pool.page_tokens)
        self._retire([self.active[rid] for rid in done])
        self.ticks += 1

    def _flush_pending_inserts(self):
        """Re-run the tail-chunk inserts a split-placing backend shed last
        tick, in ONE batched ``insert_chains`` call.  The pages are already
        committed and written; an insert that is absorbed, evicts a victim
        or sheds again returns pages to recycle, so the pool's ``free +
        refcount == n_pages`` holds on every outcome."""
        if not self._pending_inserts:
            return
        pend, self._pending_inserts = self._pending_inserts, []
        recycled = self.prefix_cache.insert_chains(
            [p["hashes"] for p in pend], [p["pages"] for p in pend],
            depths=[p["depth"] for p in pend],
            chain_lens=[p["chain_len"] for p in pend])
        for pg in recycled:
            self.pool.release(pg)

    def _pop_admission(self) -> Request:
        """Pop the next new request.  With throttling on, scan past requests
        whose home shards are saturated (the backend's ``chain_pressure`` at
        or above ``throttle_threshold``) to the first the backend can serve
        now.  Plain-prefill requests (fallbacks, prompts shorter than a
        chunk) and requests skipped ``max_throttle_ticks`` times are taken
        as they come; when every queued request is hot the front one admits
        anyway (a hot admit beats an idle slot)."""
        thr = self.throttle_threshold
        press = getattr(getattr(self.prefix_cache, "cache", None), "chain_pressure", None)
        if thr is None or press is None or not self.use_prefix:
            return self.queue.pop(0)
        ct = self.prefix_cache.chunk_tokens
        pick = None
        for i, r in enumerate(self.queue):
            if (r.force_plain or len(r.prompt) < ct
                    or r.throttle_ticks >= self.max_throttle_ticks):
                pick = i
                break
            if r.chain_hashes is None:
                r.chain_hashes = chunk_chain_hashes(r.prompt, ct)
            if press(r.chain_hashes) < thr:
                pick = i
                break
        if pick is None:
            pick = 0                       # all hot: admit the front anyway
        for r in self.queue[:pick]:
            r.throttle_ticks += 1
        self.throttled_admissions += pick
        return self.queue.pop(pick)

    def _sample_resident(self, resident: int):
        self.resident_kv_tokens_peak = max(self.resident_kv_tokens_peak, resident)
        self._resident_tok_sum += resident
        self._resident_ticks += 1

    def _retire(self, reqs: list[Request]):
        """Free ``reqs``' slots and pages, in order."""
        for r in reqs:
            self.active.pop(r.rid)
            for pg in r.pinned_pages:
                self.pool.unpin(pg)
            if self.paged:
                self.pool.clear_slot(r.slot)
            self._free_slots.append(r.slot)
            self.finished.append(r)

    # -- megastep windows ----------------------------------------------------
    def _rem_budget(self, r: Request) -> int:
        """Ticks until ``r`` MUST retire (ignoring EOS): the tighter of its
        max_new budget and the ``max_len - 1`` cache-edge guard."""
        return min(r.max_new_tokens - len(r.out_tokens),
                   self.max_len - 1 - int(self.cur_len[r.slot]))

    def _plan_window(self, cap: int | None = None) -> int:
        """Largest provably event-free decode horizon: no admission into a
        freed slot can fall strictly inside the window."""
        rems = [self._rem_budget(r) for r in self.active.values()]
        if self.queue or self.retry_queue:
            # a retirement frees a slot the queue claims NEXT tick; with
            # EOS enabled any tick could retire, else the first possible
            # retirement is exactly min(rem) ticks out
            k = 1 if self.eos >= 0 else min(rems)
        else:
            # nothing waits: retired rows just park, so run the whole tail
            k = max(rems)
        k = max(1, min(k, self.max_window))
        if cap is not None:
            k = min(k, max(1, int(cap)))
        return k

    def _window_inputs(self, k: int) -> np.ndarray:
        """A window's operands as one int32 vector, in segments of width
        ``_win_w`` (a multiple of 4, so every segment is 16-byte aligned, as
        the paged kernel requires of the prefix lengths and block tables
        it reads): last token, cur_len, live, rem, park (prefix_len in paged
        mode, else 0), k_limit, then in paged mode the block tables."""
        b, w = self.slots, self._win_w
        bt = self.pool.block_tables.reshape(-1) if self.paged else np.zeros(0, np.int32)
        x = np.zeros(6 * w + bt.size, np.int32)
        x[:b] = self._last_tok[:, 0]
        x[w: w + b] = self.cur_len
        for r in self.active.values():
            x[2 * w + r.slot] = 1
            x[3 * w + r.slot] = self._rem_budget(r)
        if self.paged:
            x[4 * w: 4 * w + b] = self.pool.prefix_lens
        x[5 * w] = k
        x[6 * w:] = bt
        return x

    def _window_body(self, inb: torch.Tensor, steps: int) -> torch.Tensor:
        """``megastep_decode`` over the operand vector ``inb`` (on the
        engine's device); returns the packed (2·steps + 2, slots) int32
        result: tokens, emit masks, cur_len, live."""
        b, w = self.slots, self._win_w
        seg = [inb[i * w: i * w + b] for i in range(5)]
        park = seg[4]
        if self.paged:
            bt = inb[6 * w:].view(b, -1)

            def decode_fn(params, tokens, cache, cur_lens):
                return paged_decode_step(self.cfg, params, tokens, cache, self.pool.k,
                                         self.pool.v, bt, park, cur_lens,
                                         smax=self.max_len)
        else:
            decode_fn = self.model.decode_step
        _, cu, lv, toks, emits = megastep_decode(
            decode_fn, self.params, seg[0][:, None], self.cache, seg[1], seg[2] != 0,
            seg[3], eos=self.eos, max_len=self.max_len, steps=steps,
            k_limit=inb[5 * w], park=park, state=self._state)
        return torch.cat([toks, emits.to(torch.int32), cu[None], lv[None].to(torch.int32)])

    def capture_window(self, steps: int, inputs: np.ndarray | None = None) -> WindowGraph:
        """Capture the ``steps`` bucket's window as a CUDA graph (CUDA
        only), after one eager warm-up on a side stream.  The warm-up runs
        on ``inputs`` (default: the engine's current state) with
        ``k_limit = 0``, so no row emits: live rows rewrite the KV their
        next step writes, idle rows park, and the recurrent leaves stay
        bit-equal.  Raises if capture fails."""
        if self.device.type != "cuda":
            raise ValueError("window graphs are captured on a CUDA device only")
        x = self._window_inputs(0) if inputs is None else inputs.copy()
        x[5 * self._win_w] = 0
        if self._win_in is None:
            self._win_in = torch.zeros(x.size, dtype=torch.int32, device=self.device)
            self._win_stage = torch.zeros(x.size, dtype=torch.int32).pin_memory()
        self._win_in.copy_(torch.from_numpy(x))
        if self.paged:
            paged_attn._library()       # build and load the kernel before capture
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._window_body(self._win_in, steps)
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        before = dict(paged_attn.LAUNCHES)
        try:
            with torch.cuda.graph(graph):
                out = self._window_body(self._win_in, steps)
        finally:
            # capture launches nothing on the card; replays add these back
            launches = {n: paged_attn.LAUNCHES[n] - c for n, c in before.items()}
            paged_attn.LAUNCHES.update(before)
        graph.instantiate()
        win = WindowGraph(graph, out, launches)
        self.window_graphs[steps] = win
        return win

    def _run_window(self, steps: int, x: np.ndarray) -> torch.Tensor:
        """The window's packed result on the device: the eager loop for CPU
        tensors, else the bucket's graph (captured at first use) replayed
        on ``x`` copied into the persistent operand vector."""
        if self.device.type != "cuda":
            return self._window_body(self._tensor(x), steps)
        win = self.window_graphs.get(steps) or self.capture_window(steps, x)
        self._win_stage.numpy()[:] = x
        self._win_in.copy_(self._win_stage, non_blocking=True)
        win.graph.replay()
        for name, n in win.launches.items():
            paged_attn.LAUNCHES[name] += n
        return win.out

    def _megastep(self, k: int):
        """Run a K-tick pure-decode window as one device program, then
        replay the window's host bookkeeping retroactively: emissions,
        resident-KV samples, retirements and tick accounting land on the
        tick each token would have been emitted on, as K in-flight ticks
        place them."""
        rows = list(self.active.values())
        drain = not self.queue and not self.retry_queue
        steps = _pow2(k)
        start_cur = self.cur_len.copy()
        out = self._run_window(steps, self._window_inputs(k))
        self.decode_launches += 1
        self.launch_rows += len(rows)
        self.megastep_windows += 1
        self.window_steps += steps
        o = self._sync(out)                # the window's ONE host barrier
        toks_h, emits_h = o[:steps], o[steps: 2 * steps] != 0
        n_emit = emits_h.sum(axis=0).astype(np.int64)     # (slots,)
        for r in rows:
            for j in range(int(n_emit[r.slot])):
                self._emit(r, int(toks_h[j, r.slot]))
        self.cur_len = o[2 * steps].astype(np.int32)
        ticks_used = int(n_emit.max())
        self.decode_tokens += int(n_emit.sum())
        if drain:
            self.drain_launch_rows += len(rows)
            self.drain_decode_tokens += int(n_emit.sum())
        if self.pool is not None:
            # the per-tick resident-KV samples: at window tick j a row is
            # resident iff it emits on j; its cur_len at the sample point
            # (post-emission, pre-retirement) is start + j + 1
            for j in range(ticks_used):
                slot_tok, pinned = 0, set()
                for r in rows:
                    if n_emit[r.slot] <= j:
                        continue
                    slot_tok += int(start_cur[r.slot]) + j + 1
                    if self.paged:
                        slot_tok -= int(self.pool.prefix_lens[r.slot])
                    pinned.update(r.pinned_pages)
                self._sample_resident(slot_tok + len(pinned) * self.pool.page_tokens)
        # retire in the in-flight order: ticks ascending, admission order
        # within a tick (a stable sort on each row's emit count)
        live = o[2 * steps + 1] != 0
        self._retire(sorted((r for r in rows if not live[r.slot]),
                            key=lambda r: int(n_emit[r.slot])))
        self.ticks += ticks_used
        self._window_ticks_sum += ticks_used

    # -- elasticity / fault tolerance ---------------------------------------
    def _release_orphans(self, orphans, event: str) -> int:
        for pg in orphans:
            self.pool.release(pg)      # a pinned page frees at its last unpin
        self.fault_log.append((self.ticks, event))
        return len(orphans)

    def mark_degraded(self, shard: int) -> int:
        """Treat a backend shard as lost (``ShardedCacheClient.mark_degraded``):
        its pages no table entry maps any more go back to the pool.  Chains
        homed there miss, shed and re-prefill through the shed/retry and
        plain-fallback path.  Returns the orphan count."""
        return self._release_orphans(self.prefix_cache.mark_degraded(shard),
                                     f"degrade:{shard}")

    def reshard(self, new_ndev: int) -> int:
        """Live D -> D' reshard at a tick boundary: the backend drains and
        rebuilds on the new mesh (``ShardedCacheClient.reshard``); queue,
        retry queue and active slots carry across untouched.  Unreachable
        entries' pages go back to the pool.  Returns the orphan count."""
        return self._release_orphans(self.prefix_cache.reshard(new_ndev),
                                     f"resize:{new_ndev}")

    def apply_fault(self, ev) -> None:
        """Apply one ``launch.elastic.FaultEvent``: "degrade"/"lose" a
        shard, "resize" the mesh, or inject transient "route_fail" sheds."""
        if ev.kind in ("degrade", "lose"):
            self.mark_degraded(ev.arg)
        elif ev.kind == "resize":
            self.reshard(ev.arg)
        elif ev.kind == "route_fail":
            self.prefix_cache.cache.inject_route_failures(calls=ev.arg, frac=ev.frac,
                                                          seed=ev.seed)
            self.fault_log.append((self.ticks, f"route_fail:{ev.arg}"))
        else:
            raise ValueError(f"unknown fault kind: {ev.kind!r}")

    def run_until_done(self, max_ticks: int = 10000, fault_plan=None) -> int:
        """Drive ticks until every queued, retried and active request retires
        and no tail insert is pending; returns the tick count (a megastep
        window of K counts K ticks).  ``fault_plan`` (``launch.elastic.FaultPlan``)
        applies its events at their tick boundaries, before the tick's
        admissions; its next due tick caps the megastep window, so no
        window straddles a fault."""
        start = self.ticks
        while ((self.queue or self.retry_queue or self.active or self._pending_inserts)
               and self.ticks - start < max_ticks):
            cap = None
            if fault_plan is not None:
                for ev in fault_plan.pop_due(self.ticks):
                    self.apply_fault(ev)
                nxt = fault_plan.next_tick()
                if nxt is not None:
                    cap = nxt - self.ticks
            self.step(window_cap=cap)
        return self.ticks - start

    def stats(self) -> dict:
        """Serve-side counters: launch economics and admit latency."""
        p50, p99 = service_tick_percentiles(self._service_ticks)
        backend = getattr(self.prefix_cache, "cache", None)
        return {
            "ticks": self.ticks,
            "decode_launches": self.decode_launches,
            "decode_tokens": self.decode_tokens,
            "launch_rows": self.launch_rows,
            "launches_per_token": (self.launch_rows / self.decode_tokens
                                   if self.decode_tokens else 0.0),
            "megastep_windows": self.megastep_windows,
            "mean_window": (self._window_ticks_sum / self.megastep_windows
                            if self.megastep_windows else 0.0),
            "max_window": self.max_window,
            # decode steps the windows ran: each pads its ticks to a pow2
            "megastep_steps": self.window_steps,
            "host_syncs": self.host_syncs,
            "host_syncs_per_token": (self.host_syncs / self.decode_tokens
                                     if self.decode_tokens else 0.0),
            "drain_launch_rows": self.drain_launch_rows,
            "drain_decode_tokens": self.drain_decode_tokens,
            "drain_launches_per_token": (
                self.drain_launch_rows / self.drain_decode_tokens
                if self.drain_decode_tokens else 0.0),
            "requests_serviced": len(self._service_ticks),
            "fallbacks": self.fallbacks,
            "fallback_rate": (self.fallbacks / len(self._service_ticks)
                              if self._service_ticks else 0.0),
            "throttled_admissions": self.throttled_admissions,
            # a sharded backend's split-placement counters (0 without one)
            "split_chains": getattr(backend, "split_chains", 0),
            "partial_sheds": getattr(backend, "partial_sheds", 0),
            "slab_occupancy_peak": getattr(backend, "slab_occupancy_peak", 0.0),
            "partial_served": getattr(self.prefix_cache, "partial_served", 0),
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
        """Device bytes one token's K+V occupies across all layers (0 for a
        family without KV)."""
        if "k" not in self.cache:
            return 0
        return (2 * self.cfg.n_layers * self.cfg.n_kv_heads * self.cfg.head_dim
                * self.cache["k"].element_size())
