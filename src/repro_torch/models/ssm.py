"""Mamba, the selective state-space mixer of the hymba hybrid.

Port of the Mamba part of ``repro.models.ssm``, forward only: a prefill
form over the whole sequence (``mamba_apply``) and a one-token decode form
with carried state (``mamba_decode``).  The state is position-free:
``{"h": (B, D, N) f32, "conv": (B, K-1, D) bf16}``.

``mamba_apply`` runs the diagonal recurrence ``h_t = a_t * h_{t-1} + bx_t``
chunk by chunk (``chunk`` positions each, the last chunk zero-padded as in
JAX: a padded position has dt = 0, so a = 1 and bx = 0 pass ``h``
through).  Inside a chunk the JAX package uses ``lax.associative_scan``;
PyTorch has none, so ``_sel_scan_chunk`` runs a Hillis-Steele scan of the
same combine, ceil(log2 L) whole-tensor steps over the chunk axis.  It
sums in another order than XLA's scan, so the two agree to f32 rounding,
not bit for bit.  (A cumprod/cumsum form would divide by the running
product of ``a``, which underflows over a long chunk.)
"""

from __future__ import annotations

import torch

from repro_torch.models.layers import COMPUTE_DTYPE, _normal, dense_init


def mamba_init(gen: torch.Generator, d_model: int, d_inner: int, d_state: int,
               d_conv: int = 4) -> dict:
    dev = gen.device
    return {
        "w_in": dense_init(gen, d_model, 2 * d_inner),       # x and gate z
        "conv_w": (_normal(gen, (d_conv, d_inner)) * 0.2).to(COMPUTE_DTYPE),
        "w_bc": dense_init(gen, d_inner, 2 * d_state),       # B_t, C_t
        "w_dt": dense_init(gen, d_inner, d_inner),
        "dt_bias": torch.zeros((d_inner,), dtype=torch.float32, device=dev),
        "a_log": torch.log(torch.arange(1, d_state + 1, dtype=torch.float32, device=dev)
                           )[None, :].repeat(d_inner, 1),    # A = -exp(a_log)
        "d_skip": torch.ones((d_inner,), dtype=torch.float32, device=dev),
        "w_out": dense_init(gen, d_inner, d_model),
    }


def _silu_bf16(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.silu in f32, rounded to the compute dtype."""
    xf = x.float()
    return (xf * torch.sigmoid(xf)).to(COMPUTE_DTYPE)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus: log(1 + e^x) as logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, state: torch.Tensor | None = None):
    """Depthwise causal conv: x (B, S, D), w (K, D); ``state`` (B, K-1, D)
    holds the K-1 positions before x (decode), else zeros.  Returns
    (out (B, S, D), the last K-1 positions of the padded input)."""
    k, s = w.shape[0], x.shape[1]
    if state is None:
        xp = torch.nn.functional.pad(x, (0, 0, k - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    out = xp[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + s] * w[i]
    return out, xp[:, -(k - 1):]


def _sel_scan_chunk(a: torch.Tensor, bx: torch.Tensor, h0: torch.Tensor):
    """Inclusive scan of ``h_t = a_t h_{t-1} + bx_t`` over axis 1 from h0.

    a, bx (B, L, D, N) f32; h0 (B, D, N).  Hillis-Steele over the combine
    (a1, b1), (a2, b2) -> (a1 a2, a2 b1 + b2): after the step of offset d,
    position t holds the composition of positions t-2d+1 .. t.  Returns
    (h (B, L, D, N), h at the chunk's last position)."""
    n = a.shape[1]
    d = 1
    while d < n:
        bx = torch.cat([bx[:, :d], a[:, d:] * bx[:, :-d] + bx[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    h = a * h0[:, None] + bx
    return h, h[:, -1]


def _project(params, xi: torch.Tensor, d_state: int):
    """xi (B, S, D) bf16 -> (B_t, C_t (B, S, N) f32, dt (B, S, D) f32, A (D, N))."""
    bc = (xi @ params["w_bc"]).float()
    b_t, c_t = bc[..., :d_state], bc[..., d_state:]
    dt = _softplus((xi @ params["w_dt"]).float() + params["dt_bias"])
    return b_t, c_t, dt, -torch.exp(params["a_log"])


def _out(params, y: torch.Tensor, xi: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    y = y + params["d_skip"] * xi.float()
    return (y.to(COMPUTE_DTYPE) * _silu_bf16(z)) @ params["w_out"]


def mamba_apply(params, x: torch.Tensor, *, d_state: int, chunk: int = 256,
                return_state: bool = False):
    """Prefill.  x (B, S, Dm) -> (B, S, Dm) [, the decode state after x]."""
    b, s, _ = x.shape
    xz = x @ params["w_in"]
    d_inner = xz.shape[-1] // 2
    xi_raw, z = xz[..., :d_inner], xz[..., d_inner:]
    xi, conv_state = _causal_conv(xi_raw, params["conv_w"])
    xi = _silu_bf16(xi)
    b_t, c_t, dt, a = _project(params, xi, d_state)

    nc = -(-s // chunk)
    pad = nc * chunk - s
    xf = xi.float()
    if pad:
        xf, dt, b_t, c_t = (torch.nn.functional.pad(t, (0, 0, 0, pad))
                            for t in (xf, dt, b_t, c_t))
    h = torch.zeros((b, d_inner, d_state), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        dc = dt[:, sl]
        da = torch.exp(dc[..., None] * a)                                 # (B,L,D,N)
        dbx = (dc * xf[:, sl])[..., None] * b_t[:, sl, None, :]
        hs, h = _sel_scan_chunk(da, dbx, h)
        ys.append(torch.einsum("bldn,bln->bld", hs, c_t[:, sl]))
    y = torch.cat(ys, dim=1)[:, :s]
    out = _out(params, y, xi, z)
    if return_state:
        return out, {"h": h, "conv": conv_state.to(COMPUTE_DTYPE)}
    return out


def mamba_decode(params, x: torch.Tensor, state: dict, *, d_state: int):
    """One token per row.  x (B, 1, Dm); state {"h": (B, D, N) f32, "conv":
    (B, K-1, D)}.  Returns (out (B, 1, Dm), the new state)."""
    xz = x @ params["w_in"]
    d_inner = xz.shape[-1] // 2
    xi, z = xz[..., :d_inner], xz[..., d_inner:]
    xi, conv_state = _causal_conv(xi, params["conv_w"], state["conv"])
    xi = _silu_bf16(xi)
    b_t, c_t, dt, a = _project(params, xi, d_state)
    da = torch.exp(dt[:, 0, :, None] * a)                                 # (B,D,N)
    h = da * state["h"] + (dt[:, 0] * xi[:, 0].float())[..., None] * b_t[:, 0, None, :]
    y = torch.einsum("bdn,bn->bd", h, c_t[:, 0])[:, None, :]
    return _out(params, y, xi, z), {"h": h, "conv": conv_state}
