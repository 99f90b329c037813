"""GQA attention: chunked softmax for training and prefill, KV-cache decode,
paged decode.

Port of ``repro.models.attention``.  Training and prefill attention is
plain PyTorch over query chunks, as the JAX package computes it outside any
Pallas kernel (no SDPA); when it records a graph, each chunk's scores are
recomputed in backward, as the JAX scan's ``jax.checkpoint(body)`` does.
Decode over a contiguous cache (``attn_decode``) and the gather rendering
of paged decode share one set of score/mask/softmax lines
(``kernels.paged_attn.dense_decode_attention``), so the two are
bit-identical on the same bits.  ``paged_attn_decode`` runs the paged
kernel for CUDA tensors and its plain version for CPU tensors: the device
of the tensors chooses.

Sliding windows are per-layer ints (<= 0 means global).  Positions are
(B, S) for RoPE and (B, 3, S) for M-RoPE, whose decode broadcasts the row's
``cur_len`` to all three streams.  Decode writes the new token's KV into
the cache (or tail) in place.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels.paged_attn import (NEG_INF, dense_decode_attention,
                                            paged_attn_decode_call, q_scale,
                                            window_value)
from repro_torch.models.layers import (apply_mrope, apply_rope, dense_init, from_local, hint,
                                       is_dtensor, local, recompute_in_backward, rmsnorm,
                                       rmsnorm_init)

# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def attn_init(gen: torch.Generator, d_model: int, n_heads: int, n_kv_heads: int,
              d_head: int, qk_norm: bool = False) -> dict:
    p = {
        "wq": dense_init(gen, d_model, n_heads * d_head),
        "wk": dense_init(gen, d_model, n_kv_heads * d_head),
        "wv": dense_init(gen, d_model, n_kv_heads * d_head),
        "wo": dense_init(gen, n_heads * d_head, d_model),
    }
    if qk_norm:
        p["q_norm"] = rmsnorm_init(d_head, gen.device)
        p["k_norm"] = rmsnorm_init(d_head, gen.device)
    return p


def _project_qkv(params, x, n_heads, n_kv_heads, d_head, positions, rope_kind, theta):
    b, s, _ = x.shape
    q = hint(x @ params["wq"], "heads").reshape(b, s, n_heads, d_head)
    k = hint(x @ params["wk"], "heads").reshape(b, s, n_kv_heads, d_head)
    v = hint(x @ params["wv"], "heads").reshape(b, s, n_kv_heads, d_head)
    if "q_norm" in params:
        q = rmsnorm(params["q_norm"], q)
        k = rmsnorm(params["k_norm"], k)
    if rope_kind == "rope":
        q = apply_rope(q, positions, theta)
        k = apply_rope(k, positions, theta)
    elif rope_kind == "mrope":
        q = apply_mrope(q, positions, theta)
        k = apply_mrope(k, positions, theta)
    elif rope_kind != "none":
        raise NotImplementedError(f"rope_kind={rope_kind!r} is not yet ported")
    return q, k, v


def _attend(qj, k, v, mask, softcap):
    """One query chunk: qj (B, c, H, Dh) pre-scaled; k, v (B, Skv, KVH, Dh);
    mask broadcastable to (B, 1, c, Skv).  Returns (B, H, c, Dh)."""
    b, c, h, dh = qj.shape
    skv, kvh = k.shape[1], k.shape[2]
    rep = h // kvh
    qg = qj.reshape(b, c, kvh, rep, dh)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg, k).float().reshape(b, h, c, skv)
    if softcap > 0.0:
        s = torch.tanh(s / softcap) * softcap
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    pg = p.to(v.dtype).reshape(b, kvh, rep, c, skv)
    return torch.einsum("bgrqk,bkgd->bgrqd", pg, v).reshape(b, h, c, dh)


# ---------------------------------------------------------------------------
# chunked causal attention (training and prefill)
# ---------------------------------------------------------------------------

def chunked_attention(q, k, v, *, causal: bool = True, window=None,
                      softcap: float = 0.0, chunk: int = 512, q_offset: int = 0):
    """q (B,Sq,H,Dh); k,v (B,Skv,KVH,Dh).  Loop over query chunks; each
    attends over the full KV with a masked f32 softmax.

    window: None/int (<=0 global) — key at absolute pk visible to the query
    at pq iff pq - window < pk <= pq.  q_offset: absolute position of q[0].
    """
    sq, skv = q.shape[1], k.shape[1]
    qf = q * q_scale(q.shape[-1])
    k_pos = torch.arange(skv, device=q.device)
    w = window_value(window)
    outs = []
    for start in range(0, sq, chunk):
        qj = qf[:, start:start + chunk]
        q_pos = q_offset + start + torch.arange(qj.shape[1], device=q.device)
        mask = torch.ones((qj.shape[1], skv), dtype=torch.bool, device=q.device)
        if causal:
            mask &= q_pos[:, None] >= k_pos[None, :]
        if w > 0:
            mask &= q_pos[:, None] - k_pos[None, :] < w
        outs.append(recompute_in_backward(_attend, qj, k, v, mask[None, None], softcap))
    return torch.cat(outs, dim=2).transpose(1, 2).to(q.dtype)   # (B, Sq, H, Dh)


def per_head(fn, q, k, v, *rows, hq: int, hk: int):
    """``fn(q, k, v, *rows)``: attention, independent per (row, head), whose
    output has q's shape.  On DTensors each rank runs ``fn`` on its blocks
    (a region DTensor would otherwise plan through the einsums' views):
    rows as q's batch dim is sharded, heads over a mesh dim q shards them on
    when both q's and the KV's head counts (dims ``hq``, ``hk``) divide it
    (each rank's q heads then read its own KV heads), every other dim whole;
    ``rows`` (per-row vectors) follow the rows.  A plain call on one
    device."""
    if not is_dtensor(q):
        return fn(q, k, v, *rows)
    from torch.distributed.tensor import Replicate, Shard

    mesh = q.device_mesh
    pq, pk = [], []
    for i, p in enumerate(q.placements):
        n = mesh.size(i)
        if p == Shard(0) and q.shape[0] % n == 0:
            pq.append(p), pk.append(p)
        elif p == Shard(hq) and q.shape[hq] % n == 0 and k.shape[hk] % n == 0:
            pq.append(p), pk.append(Shard(hk))
        else:
            pq.append(Replicate()), pk.append(Replicate())
    pr = [p if p == Shard(0) else Replicate() for p in pq]

    def block(x, pl):
        if not is_dtensor(x):
            x = from_local(x, mesh, [Replicate()] * mesh.ndim)
        return x.redistribute(mesh, pl).to_local()

    out = fn(block(q, pq), block(k, pk), block(v, pk), *(block(r, pr) for r in rows))
    return from_local(out.contiguous(), mesh, pq, q.shape)


def masked_batch_attention(q, k, v, *, q_pos, k_pos, k_valid, window=None,
                           softcap: float = 0.0, chunk: int = 512):
    """``chunked_attention`` with per-ROW positions and key validity.

    q (B,Sq,H,Dh); k,v (B,Skv,KVH,Dh); q_pos (B,Sq) and k_pos (B,Skv)
    absolute positions; k_valid (B,Skv) masks padding slots.  The batched
    continuation prefill puts rows with different prefix lengths in one
    launch this way.
    """
    sq = q.shape[1]
    qf = q * q_scale(q.shape[-1])
    w = window_value(window)
    outs = []
    for start in range(0, sq, chunk):
        qj = qf[:, start:start + chunk]
        qp = q_pos[:, start:start + chunk]
        mask = k_valid[:, None, :] & (qp[:, :, None] >= k_pos[:, None, :])
        if w > 0:
            mask &= qp[:, :, None] - k_pos[:, None, :] < w
        outs.append(recompute_in_backward(_attend, qj, k, v, mask[:, None], softcap))
    return torch.cat(outs, dim=2).transpose(1, 2).to(q.dtype)   # (B, Sq, H, Dh)


def attn_apply(params, x, positions, *, n_heads, n_kv_heads, d_head,
               rope_kind="rope", theta=1e4, causal=True, window=None,
               softcap=0.0, chunk=512):
    """Full attention sublayer for training and prefill. Returns (out, (k, v))."""
    q, k, v = _project_qkv(params, x, n_heads, n_kv_heads, d_head,
                           positions, rope_kind, theta)
    ctx = per_head(functools.partial(chunked_attention, causal=causal, window=window,
                                     softcap=softcap, chunk=chunk), q, k, v, hq=2, hk=2)
    b, s = ctx.shape[:2]
    return hint(ctx.reshape(b, s, n_heads * d_head), "heads") @ params["wo"], (k, v)


# ---------------------------------------------------------------------------
# decode (single new token against a KV cache)
# ---------------------------------------------------------------------------

def _cur_rows(cur_len, b, device) -> torch.Tensor:
    return torch.as_tensor(cur_len, dtype=torch.int64, device=device).expand(b)


def rope_positions(positions, rope_kind):
    """The positions ``_project_qkv`` rotates by, from (B, S) ones: as they
    are for RoPE, or for M-RoPE the (B, 3, S) streams of text, three equal
    ones (as the JAX model path builds them)."""
    if rope_kind == "mrope":
        return positions[:, None, :].expand(positions.shape[0], 3, positions.shape[1])
    return positions


def attn_decode(params, x, cache_k, cache_v, cur_len, *, n_heads, n_kv_heads,
                d_head, rope_kind="rope", theta=1e4, window=None, softcap=0.0):
    """x (B,1,D); cache_k/v (B,Smax,KVH,Dh) with cur_len valid entries.

    ``cur_len`` is an int (every row at one position) or a (B,) tensor
    (in-flight batching: row b writes its new KV at ``cur_len[b]`` and
    attends over [0, cur_len[b]]).  The math is row-local.  The new KV is
    written into the cache in place.  Returns (out (B,1,D), cache_k,
    cache_v).
    """
    b = x.shape[0]
    cur = _cur_rows(cur_len, b, x.device)
    q, k, v = _project_qkv(params, x, n_heads, n_kv_heads, d_head,
                           rope_positions(cur[:, None], rope_kind), rope_kind, theta)
    _write_rows(cache_k, cur, k[:, 0])
    _write_rows(cache_v, cur, v[:, 0])
    ctx = per_head(functools.partial(dense_decode_attention, window=window, softcap=softcap),
                   q[:, 0], cache_k, cache_v, cur, hq=1, hk=2)
    return (ctx.reshape(b, n_heads * d_head) @ params["wo"])[:, None, :], cache_k, cache_v


def _write_rows(cache: torch.Tensor, cur: torch.Tensor, new: torch.Tensor) -> None:
    """``cache[b, cur[b]] = new[b]`` for every row b, in place: cache (B,
    Smax, KVH, Dh), new (B, KVH, Dh).  A DTensor cache (batch over the batch
    axes, KV heads or the sequence over 'model') is written shard by shard:
    each rank writes its rows at the positions its block of the sequence
    holds (DTensor has no rule for an in-place scatter into a sharded
    tensor)."""
    if not is_dtensor(cache):
        rows = torch.arange(cache.shape[0], device=cache.device)
        cache[rows, cur] = new.to(cache.dtype)
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    mesh, pl = cache.device_mesh, cache.placements
    # new laid out as the cache without its sequence dim
    new_pl = tuple(Shard(p.dim - (p.dim > 1)) if p.is_shard() and p.dim != 1 else Replicate()
                   for p in pl)
    new_l = local(new.redistribute(mesh, new_pl) if is_dtensor(new) else new)
    shape, offset = compute_local_shape_and_global_offset(cache.shape, mesh, pl)
    cache_l = cache.to_local()
    if cache_l.numel() == 0:
        return
    cur = cur.full_tensor() if is_dtensor(cur) else cur
    pos = cur[offset[0]:offset[0] + shape[0]] - offset[1]
    inside = (pos >= 0) & (pos < shape[1])
    pos = pos.clamp(0, shape[1] - 1)
    rows = torch.arange(shape[0], device=cache_l.device)
    cache_l[rows, pos] = torch.where(inside[:, None, None], new_l.to(cache_l.dtype),
                                     cache_l[rows, pos])


# ---------------------------------------------------------------------------
# paged decode (block-table walk over the shared pool + slot-local tail)
# ---------------------------------------------------------------------------

def paged_attn_decode(params, x, pool_k, pool_v, block_table, tail_k, tail_v,
                      prefix_len, cur_len, *, smax, n_heads, n_kv_heads, d_head,
                      rope_kind="rope", theta=1e4, window=None, softcap=0.0):
    """Decode one token per row straight from the paged pool: row b's first
    ``prefix_len[b]`` positions live in the shared pool pages named by
    ``block_table[b]``, everything the row computed itself in its private
    tail at tail position ``abs_pos - prefix_len[b]``.

    x (B,1,D); pool_k/v (n_pages, page_tokens, KVH, Dh) — one layer's pool
    plane; block_table (B, NP) int32; tail_k/v (B, Tmax, KVH, Dh);
    prefix_len, cur_len (B,) int32.  The new KV is written into the tail at
    ``cur_len - prefix_len`` in place; the row attends over absolute
    [0, cur_len].  CUDA tensors run the paged kernel, CPU tensors its plain
    version over ``smax`` lanes (bit-identical to ``attn_decode`` on the
    assembled contiguous cache).  Returns (out (B,1,D), tail_k, tail_v).
    """
    b = x.shape[0]
    cur = _cur_rows(cur_len, b, x.device)
    plen = _cur_rows(prefix_len, b, x.device)
    q, k, v = _project_qkv(params, x, n_heads, n_kv_heads, d_head,
                           rope_positions(cur[:, None], rope_kind), rope_kind, theta)
    rows = torch.arange(b, device=x.device)
    t_new = cur - plen                     # the engine keeps t_new < Tmax
    tail_k[rows, t_new] = k[:, 0].to(tail_k.dtype)
    tail_v[rows, t_new] = v[:, 0].to(tail_v.dtype)
    ctx = paged_attn_decode_call(q[:, 0], pool_k, pool_v, block_table, tail_k, tail_v,
                                 prefix_len, cur_len, window=window, softcap=softcap,
                                 smax=smax)
    return (ctx.reshape(b, n_heads * d_head) @ params["wo"])[:, None, :], tail_k, tail_v
