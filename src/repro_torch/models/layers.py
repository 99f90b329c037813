"""Shared layers, forward only: initializers, norms, RoPE, FFNs, embeddings.

Port of ``repro.models.layers`` with the JAX package's conventions:

  * weights are ``(d_in, d_out)`` and applied as ``x @ W`` (so each tensor
    compares with its JAX counterpart like for like);
  * compute dtype is bf16, with the JAX cast points: norms (RMSNorm and
    LayerNorm) take their row statistics in f32 and multiply in bf16, RoPE
    and M-RoPE rotate in f32;
  * initializers draw from an explicit ``torch.Generator`` on the target
    device (normal × scale in f32, then cast), so a full-width model is
    made on the card without a host copy.  The numbers differ from
    ``jax.random``'s; tests carry the JAX parameters across instead
    (``repro_torch.core.params_from_numpy``).

The custom VJPs of the JAX norms come with training.
"""

from __future__ import annotations

import torch

COMPUTE_DTYPE = torch.bfloat16
PARAM_DTYPE = torch.bfloat16

# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------


def _normal(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype=PARAM_DTYPE):
    scale = (1.0 / d_in) ** 0.5
    return (_normal(gen, (d_in, d_out)) * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype=PARAM_DTYPE):
    return (_normal(gen, (vocab, d)) * 0.02).to(dtype)


def rmsnorm_init(d: int, device) -> dict:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def layernorm_init(d: int, device) -> dict:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device),
            "bias": torch.zeros((d,), dtype=torch.float32, device=device)}


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """f32 mean square, then ``x * inv * scale`` in x's dtype (the JAX
    ``_rms_core``'s cast points)."""
    xf = x.float()
    ms = (xf * xf).sum(-1, keepdim=True) / x.shape[-1]
    inv = torch.rsqrt(ms + eps)
    return x * inv.to(x.dtype) * params["scale"].to(x.dtype)


def layernorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """f32 mean and mean square, ``var = max(E[x^2] - mu^2, 0)``, then
    ``(x - mu) * inv * scale + bias`` in x's dtype (the JAX ``_ln_core``'s
    cast points)."""
    d = x.shape[-1]
    xf = x.float()
    mu = xf.sum(-1, keepdim=True) / d
    ex2 = (xf * xf).sum(-1, keepdim=True) / d
    inv = torch.rsqrt(torch.clamp(ex2 - mu * mu, min=0.0) + eps)
    xc = (x - mu.to(x.dtype)) * inv.to(x.dtype)
    return xc * params["scale"].to(x.dtype) + params["bias"].to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(d_head: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, d_head, 2, dtype=torch.float32, device=device) / d_head
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (..., S, H, Dh); positions (..., S) int.  Pairwise (even, odd)
    rotation in f32, cast back to x's dtype."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)              # (Dh/2,)
    ang = positions[..., None].to(torch.float32) * freqs          # (..., S, Dh/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    xf1, xf2 = x[..., 0::2].float(), x[..., 1::2].float()
    r1 = xf1 * cos - xf2 * sin
    r2 = xf2 * cos + xf1 * sin
    return torch.stack([r1, r2], dim=-1).reshape(x.shape).to(x.dtype)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections=(2, 3, 3)) -> torch.Tensor:
    """Qwen2-VL's multimodal RoPE: x (..., S, H, Dh); positions (..., 3, S)
    int, one stream each for the (t, h, w) sections, which are relative
    weights over the Dh/2 frequency slots.  With three equal streams it is
    ``apply_rope`` bit for bit."""
    d_half = x.shape[-1] // 2
    total = sum(sections)
    bounds, acc = [], 0
    for s in sections[:-1]:
        acc += (d_half * s) // total
        bounds.append(acc)
    freqs = rope_freqs(x.shape[-1], theta, x.device)              # (Dh/2,)
    slot = torch.arange(d_half, device=x.device)
    section_id = torch.zeros((d_half,), dtype=torch.long, device=x.device)
    for b in bounds:
        section_id += (slot >= b).long()
    ang = _mrope_pos(positions, section_id) * freqs               # (..., S, Dh/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    xf1, xf2 = x[..., 0::2].float(), x[..., 1::2].float()
    r1 = xf1 * cos - xf2 * sin
    r2 = xf2 * cos + xf1 * sin
    return torch.stack([r1, r2], dim=-1).reshape(x.shape).to(x.dtype)


def _mrope_pos(positions: torch.Tensor, section_id: torch.Tensor) -> torch.Tensor:
    """positions (..., 3, S), section_id (Dh/2,) -> (..., S, Dh/2) f32: each
    frequency slot's position stream."""
    return positions.movedim(-2, -1).to(torch.float32)[..., section_id]


# ---------------------------------------------------------------------------
# FFN variants
# ---------------------------------------------------------------------------

def swiglu_init(gen: torch.Generator, d: int, d_ff: int) -> dict:
    return {"w_gate": dense_init(gen, d, d_ff), "w_up": dense_init(gen, d, d_ff),
            "w_down": dense_init(gen, d_ff, d)}


def swiglu(params, x: torch.Tensor) -> torch.Tensor:
    g = x @ params["w_gate"]
    u = x @ params["w_up"]
    h = g * torch.sigmoid(g) * u          # jax.nn.silu(g) * u
    return h @ params["w_down"]


def gelu_mlp_init(gen: torch.Generator, d: int, d_ff: int) -> dict:
    return {"w_up": dense_init(gen, d, d_ff), "w_down": dense_init(gen, d_ff, d)}


def gelu_mlp(params, x: torch.Tensor) -> torch.Tensor:
    h = torch.nn.functional.gelu(x @ params["w_up"], approximate="tanh")
    return h @ params["w_down"]


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------

def embed_tokens(embedding: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return embedding[tokens.long()].to(COMPUTE_DTYPE)
