"""The attention block: init, prefill, contiguous decode and paged decode.

Port of the attention-block part of ``repro.models.transformer``, forward
only.  A block's parameters keep the JAX package's names and layout
(``ln1``, ``attn``, ``mlp``, ``ln2``).  The JAX layer ``scan`` becomes a
Python loop over blocks in ``model.py``; window and theta are per-layer
Python numbers.  Norms are RMSNorm or LayerNorm (``cfg.norm``).  The JAX
package's other families (hymba, xLSTM, MoE) are not ported yet and raise.
"""

from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models.layers import (gelu_mlp, gelu_mlp_init, layernorm,
                                       layernorm_init, rmsnorm, rmsnorm_init,
                                       swiglu, swiglu_init)


def _norm_init(cfg, device, d=None):
    d = d or cfg.d_model
    return layernorm_init(d, device) if cfg.norm == "ln" else rmsnorm_init(d, device)


def _norm(cfg, p, x):
    if cfg.norm == "ln":
        return layernorm(p, x, cfg.norm_eps)
    return rmsnorm(p, x, cfg.norm_eps)


def attn_block_init(gen: torch.Generator, cfg) -> dict:
    p = {
        "ln1": _norm_init(cfg, gen.device),
        "attn": attn.attn_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                               cfg.head_dim, qk_norm=cfg.qk_norm),
    }
    if cfg.ffn == "swiglu":
        p["mlp"] = swiglu_init(gen, cfg.d_model, cfg.d_ff)
    elif cfg.ffn == "gelu":
        p["mlp"] = gelu_mlp_init(gen, cfg.d_model, cfg.d_ff)
    elif cfg.ffn != "none":
        raise NotImplementedError(f"ffn={cfg.ffn!r} is not yet ported")
    if not cfg.parallel_block and cfg.ffn != "none":
        p["ln2"] = _norm_init(cfg, gen.device)
    return p


def _ffn_apply(cfg, p, x):
    """The block's FFN; the same for prefill and decode (the JAX package's
    ``_ffn_decode`` differs from ``_ffn_apply`` only for MoE)."""
    if cfg.ffn == "swiglu":
        return swiglu(p["mlp"], x)
    if cfg.ffn == "gelu":
        return gelu_mlp(p["mlp"], x)
    return torch.zeros_like(x)


def _residual(cfg, p, h, x, a_out):
    """h + attention out (+ FFN), sequential or parallel block."""
    if cfg.parallel_block:
        return h + a_out + _ffn_apply(cfg, p, x)
    h = h + a_out
    if cfg.ffn != "none":
        h = h + _ffn_apply(cfg, p, _norm(cfg, p["ln2"], h))
    return h


def attn_block_apply(cfg, p, h, positions, window, theta):
    """Prefill.  Returns (h, (k, v))."""
    x = _norm(cfg, p["ln1"], h)
    a_out, kv = attn.attn_apply(
        p["attn"], x, positions, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        d_head=cfg.head_dim, rope_kind=cfg.rope_kind, theta=theta,
        window=window, softcap=cfg.softcap, chunk=cfg.attn_chunk)
    return _residual(cfg, p, h, x, a_out), kv


def attn_block_decode(cfg, p, h, cache_k, cache_v, cur_len, window, theta):
    x = _norm(cfg, p["ln1"], h)
    a_out, ck, cv = attn.attn_decode(
        p["attn"], x, cache_k, cache_v, cur_len, n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads, d_head=cfg.head_dim, rope_kind=cfg.rope_kind,
        theta=theta, window=window, softcap=cfg.softcap)
    return _residual(cfg, p, h, x, a_out), ck, cv


def attn_block_decode_paged(cfg, p, h, pool_k, pool_v, block_table,
                            tail_k, tail_v, prefix_len, cur_len, window,
                            theta, *, smax):
    """``attn_block_decode`` with the KV read through a block-table walk
    over the shared pool plus the slot-local tail.  pool_k/v are ONE
    layer's pool plane (n_pages, page_tokens, KVH, Dh); tail_k/v
    (B, Tmax, KVH, Dh) are updated in place and returned."""
    x = _norm(cfg, p["ln1"], h)
    a_out, tk, tv = attn.paged_attn_decode(
        p["attn"], x, pool_k, pool_v, block_table, tail_k, tail_v,
        prefix_len, cur_len, smax=smax, n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads, d_head=cfg.head_dim,
        rope_kind=cfg.rope_kind, theta=theta, window=window,
        softcap=cfg.softcap)
    return _residual(cfg, p, h, x, a_out), tk, tv
