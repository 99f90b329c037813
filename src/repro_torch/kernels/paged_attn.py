"""Paged decode attention: the CUDA kernel and its plain PyTorch version.

Port of ``repro.kernels.paged_attn``.  One decode row attends over two
segments without a resident contiguous copy of its sequence: the *prefix*,
``prefix_len`` tokens in the shared ``PagedKVPool`` pages named by the row's
block table, and the *tail*, the tokens the row computed itself, at tail
position ``abs_pos - prefix_len``.

* ``paged_attn_decode_call`` — the wrapper.  CUDA tensors launch the kernel
  of ``csrc/paged_attn.cu`` (built by ``build.py`` at first use; its head
  note says what bounds it and what its design does about it), CPU tensors
  run the plain version; it never falls back from one to the other.
  ``LAUNCHES["paged_attn"]`` counts its launches.  ``kernel_splits`` gives
  the cluster size (blocks per (row, KV head)) the launcher picks.
* ``paged_attn_decode_plain`` — the gather and full-softmax rendering of
  ``repro.models.attention.paged_attn_decode``: it assembles each row's
  contiguous view transiently and runs ``dense_decode_attention``, the
  score/mask/softmax lines of the contiguous ``attn_decode``, so its output
  is bit-identical to the contiguous path fed the same bits.

The kernel computes the scores in f32 from the bf16 values (as the TPU
kernel does) where the plain version rounds them to bf16 first (as the JAX
mirror does), and it accumulates flash-style: the two agree to bf16
resolution, not bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels.build import load_library

__all__ = ["HEAD_DIMS", "LAUNCHES", "MAX_REP", "NEG_INF", "SOURCE",
           "dense_decode_attention", "gather_view", "kernel_splits",
           "paged_attn_decode_call",
           "paged_attn_decode_plain", "q_scale", "window_value"]

LAUNCHES = {"paged_attn": 0}

NEG_INF = -1e30          # finite, as the JAX package's
HEAD_DIMS = (16, 24, 32, 64, 96, 128, 256)  # head dims the kernel is built for
MAX_REP = 16             # query heads per KV head the kernel takes
SOURCE = Path(__file__).resolve().parent / "csrc" / "paged_attn.cu"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


@functools.lru_cache(maxsize=None)
def _library():
    lib = load_library(SOURCE)
    # the instances' dynamic shared-memory limits, set once here: never
    # inside a CUDA-graph capture of a launch
    err = lib.paged_attn_prepare()
    if err != 0:
        raise RuntimeError(f"paged_attn: setting the shared-memory limits failed: "
                           f"CUDA error {err}")
    lib.paged_attn_launch.argtypes = [_P] * 9 + [_I] * 9 + [_F, _F, _P]
    lib.paged_attn_launch.restype = _I
    lib.paged_attn_splits.argtypes = [_I] * 6
    lib.paged_attn_splits.restype = _I
    return lib


def kernel_splits(q, pool_k, block_table, tail_k, *, window=None) -> int:
    """Blocks per (row, KV head) cluster that the kernel launches for these
    operands: set from their shapes (the static bound NP * page_tokens +
    Tmax, capped by the window and by one wave of the grid), never from the
    rows' lengths.  Builds the library."""
    return _library().paged_attn_splits(q.shape[0], pool_k.shape[2], block_table.shape[1],
                                        pool_k.shape[1], tail_k.shape[1],
                                        window_value(window))


def window_value(window) -> int:
    """A sliding window as an int: None or <= 0 means global."""
    return 0 if window is None else int(window)


def q_scale(d_head: int) -> float:
    """Dh^-0.5 rounded to bf16, the factor the reference scales q by in
    q's dtype."""
    return float(torch.tensor(d_head ** -0.5, dtype=torch.bfloat16))


def dense_decode_attention(q, cache_k, cache_v, cur, *, window=None,
                           softcap: float = 0.0) -> torch.Tensor:
    """Full-softmax decode attention over a contiguous cache.

    q (B, H, Dh) unscaled; cache_k/v (B, Smax, KVH, Dh); cur (B,) int: row
    b attends over positions [0, cur[b]].  The score/mask/softmax lines of
    ``repro.models.attention.attn_decode``: q scaled in its dtype, bf16
    scores cast to f32, optional tanh softcap, NEG_INF mask, f32 softmax,
    bf16 probabilities.  Returns the context (B, H, Dh) in q's dtype.
    """
    b, h, dh = q.shape
    smax, kvh = cache_k.shape[1], cache_k.shape[2]
    rep = h // kvh
    qg = (q * q_scale(dh)).reshape(b, kvh, rep, dh)
    s = torch.einsum("bgrd,bkgd->bgrk", qg, cache_k.to(q.dtype)).float()
    if softcap > 0.0:
        s = torch.tanh(s / softcap) * softcap
    k_pos = torch.arange(smax, device=q.device)
    mask = k_pos[None, :] <= cur[:, None]
    w = window_value(window)
    if w > 0:
        mask &= cur[:, None] - k_pos[None, :] < w
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bgrk,bkgd->bgrd", p.to(q.dtype), cache_v.to(q.dtype))
    return ctx.reshape(b, h, dh)


def _rows(x, b: int, device) -> torch.Tensor:
    """A per-row int vector (B,): a python int broadcasts."""
    if isinstance(x, int):
        return torch.full((b,), x, dtype=torch.int32, device=device)
    return x.to(torch.int32).expand(b)


def gather_view(pool_k, pool_v, block_table, tail_k, tail_v, prefix_len, *,
                smax: int | None = None):
    """Each row's contiguous (B, smax, KVH, Dh) K and V views, assembled
    transiently: the block-table walk's pages, padded or cut to ``smax``
    lanes (default NP·page_tokens), with the tail written over them at
    ``prefix_len + t`` (tail lanes past ``smax`` are dropped)."""
    b, npg = block_table.shape
    pt, tmax = pool_k.shape[1], tail_k.shape[1]
    smax = npg * pt if smax is None else smax
    plen = _rows(prefix_len, b, tail_k.device)
    rows = torch.arange(b, device=tail_k.device)[:, None]
    tidx = plen[:, None].long() + torch.arange(tmax, device=tail_k.device)[None, :]
    views = []
    for pool, tail in ((pool_k, tail_k), (pool_v, tail_v)):
        g = pool[block_table.reshape(-1).long()].reshape(b, npg * pt, *pool.shape[2:])
        # a buffer wide enough for every tail lane; lanes past smax are cut
        buf = torch.zeros((b, max(smax, npg * pt) + tmax, *pool.shape[2:]),
                          dtype=tail.dtype, device=tail.device)
        n = min(smax, npg * pt)
        buf[:, :n] = g[:, :n]
        buf[rows, tidx] = tail
        views.append(buf[:, :smax])
    return views[0], views[1]


def paged_attn_decode_plain(q, pool_k, pool_v, block_table, tail_k, tail_v,
                            prefix_len, cur_len, *, window=None,
                            softcap: float = 0.0, smax: int | None = None):
    """Plain PyTorch version of ``paged_attn_decode_call`` (any device):
    ``dense_decode_attention`` over ``gather_view``'s assembled cache."""
    cache_k, cache_v = gather_view(pool_k, pool_v, block_table, tail_k, tail_v,
                                   prefix_len, smax=smax)
    cur = _rows(cur_len, q.shape[0], q.device)
    return dense_decode_attention(q, cache_k, cache_v, cur, window=window,
                                  softcap=softcap)


def _check_cuda(q, pool_k, pool_v, block_table, tail_k, tail_v, plen, cur):
    """Validate the operands the kernel reads; raise on what it cannot take."""
    b, h, dh = q.shape
    n_pages, pt, kvh, _ = pool_k.shape
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh} not in the kernel's built set {HEAD_DIMS}")
    if h % kvh:
        raise ValueError(f"H = {h} is not a multiple of KVH = {kvh}")
    if h // kvh > MAX_REP:
        raise ValueError(f"H / KVH = {h // kvh} > {MAX_REP} query heads per KV head, "
                         f"the most the kernel is built for")
    tmax = tail_k.shape[1]
    shapes = {"q": (q, (b, h, dh), torch.bfloat16),
              "pool_k": (pool_k, (n_pages, pt, kvh, dh), torch.bfloat16),
              "pool_v": (pool_v, (n_pages, pt, kvh, dh), torch.bfloat16),
              "block_table": (block_table, (b, block_table.shape[1]), torch.int32),
              "tail_k": (tail_k, (b, tmax, kvh, dh), torch.bfloat16),
              "tail_v": (tail_v, (b, tmax, kvh, dh), torch.bfloat16),
              "prefix_len": (plen, (b,), torch.int32),
              "cur_len": (cur, (b,), torch.int32)}
    for name, (t, shape, dtype) in shapes.items():
        if t.device != q.device or t.device.type != "cuda":
            raise ValueError(f"{name} must lie on q's CUDA device, got {t.device}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def paged_attn_decode_call(q, pool_k, pool_v, block_table, tail_k, tail_v,
                           prefix_len, cur_len, *, window=None,
                           softcap: float = 0.0, smax: int | None = None):
    """Decode attention for B rows straight from the paged pool.

    q (B, H, Dh) *unscaled*; pool_k/v (n_pages, pt, KVH, Dh) one layer's
    plane; block_table (B, NP) int32; tail_k/v (B, Tmax, KVH, Dh) with the
    new token already written at ``cur_len - prefix_len``; prefix_len,
    cur_len (B,) int32 (or ints).  ``window`` is None, an int or a 0-d
    tensor (<= 0 means global); ``softcap`` a float.  Returns the context
    (B, H, Dh) in q's dtype.  CPU tensors run the plain version with
    ``smax`` lanes; CUDA tensors launch the kernel, which walks only the
    valid positions (so ``smax`` does not change what it computes).
    """
    if q.device.type == "cpu":
        return paged_attn_decode_plain(q, pool_k, pool_v, block_table, tail_k,
                                       tail_v, prefix_len, cur_len, window=window,
                                       softcap=softcap, smax=smax)
    b, h, dh = q.shape
    plen = _rows(prefix_len, b, q.device).contiguous()
    cur = _rows(cur_len, b, q.device).contiguous()
    _check_cuda(q, pool_k, pool_v, block_table, tail_k, tail_v, plen, cur)
    n_pages, pt, kvh, _ = pool_k.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        LAUNCHES["paged_attn"] += 1
        err = _library().paged_attn_launch(
            q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), block_table.data_ptr(),
            tail_k.data_ptr(), tail_v.data_ptr(), plen.data_ptr(), cur.data_ptr(),
            out.data_ptr(), b, h, kvh, dh, n_pages, pt, block_table.shape[1],
            tail_k.shape[1], window_value(window), float(softcap), q_scale(dh), stream)
    if err != 0:
        raise RuntimeError(f"paged_attn launch failed: CUDA error {err}")
    return out
