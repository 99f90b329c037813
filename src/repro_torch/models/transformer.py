"""Blocks of every family: the attention block (training and prefill,
contiguous decode, paged decode), the hymba hybrid block, the xLSTM group,
and Whisper's encoder and decoder blocks.

Port of ``repro.models.transformer``.  A block's parameters
keep the JAX package's names and layout (``ln1``, ``attn``, ``mlp``,
``ln2``; hymba adds ``mamba``, ``fuse_a`` and ``fuse_m``; an xLSTM group is
``{"mlstm": [g-1 blocks of "ln", "cell"], "slstm": {"ln", "cell", "ln_ffn",
"mlp"}}``; a Whisper decoder block has ``self_attn``, ``ln_x`` and
``cross_attn``).  The JAX layer ``scan`` becomes a Python loop over blocks
in ``model.py`` (and over an xLSTM group's mLSTM blocks here); window and
theta are per-layer Python numbers.  Norms are RMSNorm or LayerNorm
(``cfg.norm``).  The FFN is SwiGLU, GeLU or MoE; as in the JAX package,
training and prefill run the MoE with capacity dispatch (``_ffn_apply``,
which adds its aux losses into the caller's running sums in training) and
decode computes every expert (``_ffn_decode``).  The ``*_apply`` functions
are the training forward too: autograd takes their backward, and the model
drops the KV and state they return.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.configs.base import xlstm_ffn_dim
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm
from repro_torch.models.layers import (COMPUTE_DTYPE, gelu_mlp, gelu_mlp_init, hint,
                                       layernorm, layernorm_init, rmsnorm,
                                       rmsnorm_init, swiglu, swiglu_init)


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
    elif cfg.ffn == "moe":
        p["mlp"] = moe_mod.moe_init(gen, cfg.d_model, cfg.d_ff, cfg.n_experts)
    if not cfg.parallel_block and cfg.ffn != "none":
        p["ln2"] = _norm_init(cfg, gen.device)
    return p


def _ffn_apply(cfg, p, x, aux=None):
    """The block's FFN in training and prefill: MoE with capacity dispatch,
    its aux losses (``lb_loss``, ``z_loss``, ``drop_frac``) added into
    ``aux``, the caller's running sums over layers, when one is given."""
    if cfg.ffn == "moe":
        y, a = moe_mod.moe_apply(p["mlp"], x, n_experts=cfg.n_experts,
                                 top_k=cfg.moe_top_k,
                                 capacity_factor=cfg.capacity_factor)
        if aux is not None:
            aux.update({k: aux[k] + a[k] for k in aux})
        return y
    return _ffn_decode(cfg, p, x)


def _ffn_decode(cfg, p, x):
    """The block's FFN in decode: MoE computes every expert on the B tokens."""
    if cfg.ffn == "moe":
        return moe_mod.moe_decode(p["mlp"], x, n_experts=cfg.n_experts,
                                  top_k=cfg.moe_top_k)
    if cfg.ffn == "swiglu":
        return swiglu(p["mlp"], x)
    if cfg.ffn == "gelu":
        return gelu_mlp(p["mlp"], x)
    return torch.zeros_like(x)


def _residual(cfg, p, h, x, a_out, ffn=_ffn_apply):
    """h + attention out (+ ``ffn``: ``_ffn_apply`` in training and prefill,
    ``_ffn_decode`` in decode), sequential or parallel block."""
    if cfg.parallel_block:
        return h + a_out + ffn(cfg, p, x)
    # (each sub-layer's sum pinned by the hint: a DTensor holds the
    # attention's row-parallel output as a pending sum over 'model')
    h = hint(h + a_out, "act")
    if cfg.ffn != "none":
        h = h + ffn(cfg, p, _norm(cfg, p["ln2"], h))
    return h


def attn_block_apply(cfg, p, h, positions, window, theta, aux=None):
    """Training and prefill.  Returns (h, (k, v)); an MoE FFN adds its aux
    losses into ``aux`` when one is given (``_ffn_apply``)."""
    x = _norm(cfg, p["ln1"], h)
    a_out, kv = attn.attn_apply(
        p["attn"], x, positions, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        d_head=cfg.head_dim, rope_kind=cfg.rope_kind, theta=theta,
        window=window, softcap=cfg.softcap, chunk=cfg.attn_chunk)
    return _residual(cfg, p, h, x, a_out,
                     lambda cfg, p, x: _ffn_apply(cfg, p, x, aux)), kv


def attn_block_decode(cfg, p, h, cache_k, cache_v, cur_len, window, theta):
    x = _norm(cfg, p["ln1"], h)
    a_out, ck, cv = attn.attn_decode(
        p["attn"], x, cache_k, cache_v, cur_len, n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads, d_head=cfg.head_dim, rope_kind=cfg.rope_kind,
        theta=theta, window=window, softcap=cfg.softcap)
    return _residual(cfg, p, h, x, a_out, _ffn_decode), ck, cv


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
    return _residual(cfg, p, h, x, a_out, _ffn_decode), tk, tv


# -- hymba: parallel attention and Mamba heads, learned fusion gates ---------

def hymba_block_init(gen: torch.Generator, cfg) -> dict:
    dev = gen.device
    return {
        "ln1": _norm_init(cfg, dev),
        "attn": attn.attn_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                               cfg.head_dim),
        "mamba": ssm.mamba_init(gen, cfg.d_model, cfg.d_model, cfg.ssm_state),
        "fuse_a": torch.full((cfg.d_model,), 0.5, dtype=torch.float32, device=dev),
        "fuse_m": torch.full((cfg.d_model,), 0.5, dtype=torch.float32, device=dev),
        "ln2": _norm_init(cfg, dev),
        "mlp": swiglu_init(gen, cfg.d_model, cfg.d_ff),
    }


def _hymba_mix(cfg, p, h, a_out, m_out):
    """h + the fused attention and Mamba outputs (f32 gates cast to bf16),
    then the SwiGLU sublayer."""
    h = hint(h + (p["fuse_a"].to(COMPUTE_DTYPE) * a_out
                  + p["fuse_m"].to(COMPUTE_DTYPE) * m_out), "act")
    return h + swiglu(p["mlp"], _norm(cfg, p["ln2"], h))


def hymba_block_apply(cfg, p, h, positions, window, theta):
    """Training and prefill.  Returns (h, (k, v), the Mamba state after
    the sequence)."""
    x = _norm(cfg, p["ln1"], h)
    a_out, kv = attn.attn_apply(
        p["attn"], x, positions, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        d_head=cfg.head_dim, rope_kind=cfg.rope_kind, theta=theta,
        window=window, chunk=cfg.attn_chunk)
    m_out, mstate = ssm.mamba_apply(p["mamba"], x, d_state=cfg.ssm_state,
                                    chunk=cfg.ssm_chunk, return_state=True)
    return _hymba_mix(cfg, p, h, a_out, m_out), kv, mstate


def hymba_block_decode(cfg, p, h, cache_k, cache_v, mstate, cur_len, window, theta):
    """Decode: the KV written in place, the new Mamba state returned (the
    caller decides which rows keep it)."""
    x = _norm(cfg, p["ln1"], h)
    a_out, ck, cv = attn.attn_decode(
        p["attn"], x, cache_k, cache_v, cur_len, n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads, d_head=cfg.head_dim, rope_kind=cfg.rope_kind,
        theta=theta, window=window)
    m_out, mstate = ssm.mamba_decode(p["mamba"], x, mstate, d_state=cfg.ssm_state)
    return _hymba_mix(cfg, p, h, a_out, m_out), ck, cv, mstate


# -- xLSTM group: (g-1) mLSTM blocks and one sLSTM block ---------------------

def xlstm_group_init(gen: torch.Generator, cfg) -> dict:
    dev = gen.device
    return {
        "mlstm": [{"ln": _norm_init(cfg, dev),
                   "cell": ssm.mlstm_init(gen, cfg.d_model, cfg.n_heads,
                                          cfg.mlstm_proj_factor)}
                  for _ in range(cfg.scan_group - 1)],
        "slstm": {"ln": _norm_init(cfg, dev),
                  "cell": ssm.slstm_init(gen, cfg.d_model, cfg.n_heads),
                  "ln_ffn": _norm_init(cfg, dev),
                  "mlp": gelu_mlp_init(gen, cfg.d_model, xlstm_ffn_dim(cfg))},
    }


def _slstm_block(cfg, sl, h, state=None):
    """The sLSTM block with its GeLU MLP; returns (h, the sLSTM state)."""
    y, state = ssm.slstm_apply(sl["cell"], _norm(cfg, sl["ln"], h), n_heads=cfg.n_heads,
                               state=state)
    h = hint(h + y, "act")
    return h + gelu_mlp(sl["mlp"], _norm(cfg, sl["ln_ffn"], h)), state


def xlstm_group_apply(cfg, p, h):
    """Training and prefill.  Returns (h, the group's state after the sequence:
    ``{"mlstm": [each block's {"c", "n", "m", "conv"}], "slstm": {"c", "n",
    "h", "m"}}``)."""
    mst = []
    for pl in p["mlstm"]:
        y, st = ssm.mlstm_apply(pl["cell"], _norm(cfg, pl["ln"], h), n_heads=cfg.n_heads,
                                chunk=cfg.ssm_chunk, return_state=True)
        h = hint(h + y, "act")
        mst.append(st)
    h, sst = _slstm_block(cfg, p["slstm"], h)
    return h, {"mlstm": mst, "slstm": sst}


def xlstm_group_decode(cfg, p, h, states):
    """One token.  states ``{"mlstm": {leaf: (g-1, B, ...)}, "slstm": {leaf:
    (B, D)}}`` (the group's slice of the cache).  Returns (h, the new state,
    laid out as ``xlstm_group_apply``'s)."""
    mst = []
    for j, pl in enumerate(p["mlstm"]):
        st = {name: x[j] for name, x in states["mlstm"].items()}
        y, st = ssm.mlstm_decode(pl["cell"], _norm(cfg, pl["ln"], h), st,
                                 n_heads=cfg.n_heads)
        h = h + y
        mst.append(st)
    h, sst = _slstm_block(cfg, p["slstm"], h, states["slstm"])
    return h, {"mlstm": mst, "slstm": sst}


# -- Whisper encoder and decoder blocks ---------------------------------------

def enc_block_init(gen: torch.Generator, cfg) -> dict:
    dev = gen.device
    return {
        "ln1": _norm_init(cfg, dev),
        "attn": attn.attn_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                               cfg.head_dim),
        "ln2": _norm_init(cfg, dev),
        "mlp": gelu_mlp_init(gen, cfg.d_model, cfg.d_ff),
    }


def enc_block_apply(cfg, p, h, positions):
    """Bidirectional self-attention (no RoPE) and the GeLU MLP."""
    a, _ = attn.attn_apply(p["attn"], _norm(cfg, p["ln1"], h), positions,
                           n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                           d_head=cfg.head_dim, rope_kind="none", causal=False,
                           chunk=cfg.attn_chunk)
    h = hint(h + a, "act")
    return h + gelu_mlp(p["mlp"], _norm(cfg, p["ln2"], h))


def dec_block_init(gen: torch.Generator, cfg) -> dict:
    dev = gen.device
    return {
        "ln1": _norm_init(cfg, dev),
        "self_attn": attn.attn_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                    cfg.head_dim),
        "ln_x": _norm_init(cfg, dev),
        "cross_attn": attn.attn_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                     cfg.head_dim),
        "ln2": _norm_init(cfg, dev),
        "mlp": gelu_mlp_init(gen, cfg.d_model, cfg.d_ff),
    }


def _cross_attend(cfg, p, x, enc_k, enc_v):
    """x (B, S, D) queries against the encoder's K/V (B, Senc, KVH, Dh)."""
    b, s, _ = x.shape
    q = hint(x @ p["wq"], "heads").reshape(b, s, cfg.n_heads, cfg.head_dim)
    ctx = attn.per_head(functools.partial(attn.chunked_attention, causal=False,
                                          chunk=cfg.attn_chunk), q, enc_k, enc_v, hq=2, hk=2)
    return hint(ctx.reshape(b, s, cfg.n_heads * cfg.head_dim), "heads") @ p["wo"]


def cross_kv(cfg, p, enc_h):
    """The cross-attention K and V (B, Senc, KVH, Dh) of the encoder's output."""
    b, se, _ = enc_h.shape
    k = hint(enc_h @ p["wk"], "heads").reshape(b, se, cfg.n_kv_heads, cfg.head_dim)
    v = hint(enc_h @ p["wv"], "heads").reshape(b, se, cfg.n_kv_heads, cfg.head_dim)
    return k, v


def _dec_tail(cfg, p, h, enc_k, enc_v):
    """Cross-attention and the GeLU MLP, after the self-attention."""
    h = hint(h + _cross_attend(cfg, p["cross_attn"], _norm(cfg, p["ln_x"], h), enc_k, enc_v),
             "act")
    return h + gelu_mlp(p["mlp"], _norm(cfg, p["ln2"], h))


def dec_block_apply(cfg, p, h, positions, enc_k, enc_v):
    """Training and prefill.  Returns (h, the self-attention's (k, v))."""
    a, kv = attn.attn_apply(p["self_attn"], _norm(cfg, p["ln1"], h), positions,
                            n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                            d_head=cfg.head_dim, rope_kind="none", causal=True,
                            chunk=cfg.attn_chunk)
    return _dec_tail(cfg, p, hint(h + a, "act"), enc_k, enc_v), kv


def dec_block_decode(cfg, p, h, cache_k, cache_v, enc_k, enc_v, cur_len):
    """Decode: the self-attention KV written in place at ``cur_len``."""
    a, ck, cv = attn.attn_decode(
        p["self_attn"], _norm(cfg, p["ln1"], h), cache_k, cache_v, cur_len,
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, d_head=cfg.head_dim,
        rope_kind="none")
    return _dec_tail(cfg, p, hint(h + a, "act"), enc_k, enc_v), ck, cv


def sinusoid(pos: torch.Tensor, d: int) -> torch.Tensor:
    """Sinusoidal encodings (N, d) bf16 of positions ``pos`` (N,): sin on
    the even channels, cos on the odd, in f32."""
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=pos.device)
    ang = pos.float()[:, None] / torch.pow(10000.0, dim / d)
    return torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1).reshape(-1, d).to(
        COMPUTE_DTYPE)


def sinusoid_positions(s: int, d: int, offset: int = 0, device="cpu") -> torch.Tensor:
    """The encodings (s, d) of positions offset .. offset + s - 1."""
    return sinusoid(torch.arange(offset, offset + s, dtype=torch.float32, device=device), d)
