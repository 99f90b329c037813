"""Recurrent sequence mixers: Mamba (hymba) and xLSTM's mLSTM and sLSTM.

Port of ``repro.models.ssm``: for each mixer a training and prefill form
over the whole sequence that can return the state after it (autograd takes
its backward), and a one-token decode form with carried state.  Every
state is position-free:

  * Mamba ``{"h": (B, D, N) f32, "conv": (B, K-1, D) bf16}``;
  * mLSTM ``{"c": (B, H, Dh, Dh), "n": (B, H, Dh), "m": (B, H)}`` f32 and
    ``"conv": (B, 3, D_inner)`` bf16;
  * sLSTM ``{"c", "n", "h", "m"}``, each (B, D) f32.

``mamba_apply`` runs the diagonal recurrence ``h_t = a_t * h_{t-1} + bx_t``
chunk by chunk (``chunk`` positions each, the last chunk zero-padded as in
JAX: a padded position has dt = 0, so a = 1 and bx = 0 pass ``h``
through).  Inside a chunk the JAX package uses ``lax.associative_scan``;
PyTorch has none, so ``_sel_scan_chunk`` runs a Hillis-Steele scan of the
same combine, ceil(log2 L) whole-tensor steps over the chunk axis.  It
sums in another order than XLA's scan, so the two agree to f32 rounding,
not bit for bit.  (A cumprod/cumsum form would divide by the running
product of ``a``, which underflows over a long chunk.)

``mlstm_apply`` runs the stabilized chunkwise-parallel mLSTM (quadratic
inside a chunk, the matrix memory carried between chunks) as a Python loop
over ``chunk``-position chunks, the JAX ``lax.scan``'s; the last chunk is
padded with a log input gate of -1e30, so that a padded step adds nothing
to the state, and a log forget gate of 0, so that it keeps it.  The sLSTM
is sequential in the JAX package too (a ``lax.scan`` over time); here a
Python loop over positions.  Both keep f32 wherever the JAX code does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

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
    """Training and prefill.  x (B, S, Dm) -> (B, S, Dm) [, the decode
    state after x]."""
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


# ---------------------------------------------------------------------------
# mLSTM (xLSTM matrix memory, stabilized chunkwise-parallel form)
# ---------------------------------------------------------------------------

def mlstm_init(gen: torch.Generator, d_model: int, n_heads: int,
               proj_factor: float = 2.0) -> dict:
    d_inner = int(d_model * proj_factor)
    dev = gen.device
    return {
        "w_up": dense_init(gen, d_model, 2 * d_inner),       # x branch + gate z
        "conv_w": (_normal(gen, (4, d_inner)) * 0.2).to(COMPUTE_DTYPE),
        "wq": dense_init(gen, d_inner, d_inner),
        "wk": dense_init(gen, d_inner, d_inner),
        "wv": dense_init(gen, d_inner, d_inner),
        "w_if": dense_init(gen, d_inner, 2 * n_heads),       # i/f gate pre-acts
        "if_bias": torch.cat([torch.zeros((n_heads,), dtype=torch.float32, device=dev),
                              torch.full((n_heads,), 3.0, dtype=torch.float32,
                                         device=dev)]),
        "w_down": dense_init(gen, d_inner, d_model),
        "skip_scale": torch.ones((d_inner,), dtype=torch.float32, device=dev),
    }


def _mlstm_chunk(q, k, v, lf, li, state):
    """One stabilized chunk.  q, k, v (B, H, L, Dh); lf, li (B, H, L) log
    gates; state (C (B, H, Dh, Dh), n (B, H, Dh), m (B, H)).  Returns
    (h (B, H, L, Dh), the state at the chunk's end).  All f32."""
    c_in, n_in, m_in = state
    fcum = torch.cumsum(lf, dim=-1)                          # F_t (incl. t)
    g = li - fcum                                            # ĩ_j - F_j
    m_intra = torch.cummax(g, dim=-1).values                 # max_{j<=t}
    m_t = torch.maximum(fcum + m_in[..., None], fcum + m_intra)

    # intra-chunk decay matrix w[t, j] = exp(F_t - F_j + ĩ_j - m_t), j <= t
    n = q.shape[2]
    dmat = fcum[..., :, None] + g[..., None, :] - m_t[..., :, None]
    tri = torch.ones((n, n), dtype=torch.bool, device=q.device).tril()
    w = torch.where(tri, torch.exp(dmat), 0.0)               # (B, H, L, L)

    s_ = q @ k.transpose(-1, -2)                             # scores
    h_intra = (s_ * w) @ v
    n_intra = w @ k

    inter_w = torch.exp(fcum + m_in[..., None] - m_t)        # (B, H, L)
    h_inter = (q @ c_in) * inter_w[..., None]
    n_inter = (q @ n_in[..., None])[..., 0] * inter_w

    den = torch.abs((q * n_intra).sum(-1) + n_inter)
    h = (h_intra + h_inter) / torch.maximum(den, torch.exp(-m_t))[..., None]

    # state propagation to the chunk's end
    f_total = fcum[..., -1]                                  # (B, H)
    m_out = torch.maximum(f_total + m_in, f_total + m_intra[..., -1])
    carry_w = torch.exp(f_total + m_in - m_out)
    kv_w = torch.exp(f_total[..., None] + g - m_out[..., None])   # (B, H, L)
    c_out = carry_w[..., None, None] * c_in + (k * kv_w[..., None]).transpose(-1, -2) @ v
    n_out = carry_w[..., None] * n_in + (kv_w[..., None] * k).sum(-2)
    return h, (c_out, n_out, m_out)


def _mlstm_in(params, xi: torch.Tensor, xc: torch.Tensor, n_heads: int):
    """q, k, v (B, H, S, Dh) f32 (k scaled by Dh^-0.5) and the log input
    gate and the forget gate's pre-activation (B, S, H) f32, from the conv
    input ``xi`` and the conv output ``xc`` (B, S, D_inner) bf16."""
    b, s, d_inner = xi.shape
    dh = d_inner // n_heads

    def heads(t):
        return t.reshape(b, s, n_heads, dh).transpose(1, 2).float()

    q = heads(xc @ params["wq"])
    k = heads(xc @ params["wk"]) * (dh ** -0.5)
    v = heads(xi @ params["wv"])
    gif = (xc @ params["w_if"]).float() + params["if_bias"]
    return q, k, v, gif[..., :n_heads], gif[..., n_heads:]


def _mlstm_out(params, h: torch.Tensor, xc: torch.Tensor, z: torch.Tensor):
    """h (B, S, D_inner) f32 -> (B, S, Dm): the skip, the output gate, the
    down projection, in bf16."""
    h = h.to(COMPUTE_DTYPE) + params["skip_scale"].to(COMPUTE_DTYPE) * xc
    return (h * _silu_bf16(z)) @ params["w_down"]


def mlstm_apply(params, x: torch.Tensor, *, n_heads: int, chunk: int = 256,
                return_state: bool = False):
    """Training and prefill.  x (B, S, Dm) -> (B, S, Dm) [, the decode
    state after x]."""
    b, s, _ = x.shape
    xz = x @ params["w_up"]
    d_inner = xz.shape[-1] // 2
    xi, z = xz[..., :d_inner], xz[..., d_inner:]
    xc, conv_state = _causal_conv(xi, params["conv_w"])
    xc = _silu_bf16(xc)
    dh = d_inner // n_heads
    q, k, v, li, lf_pre = _mlstm_in(params, xi, xc, n_heads)
    li = li.transpose(1, 2)                                  # (B, H, S)
    lf = F.logsigmoid(lf_pre.transpose(1, 2))

    nc = -(-s // chunk)
    pad = nc * chunk - s
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
        lf = F.pad(lf, (0, pad))
        li = F.pad(li, (0, pad), value=-1e30)   # padded steps contribute nothing
    state = (torch.zeros((b, n_heads, dh, dh), dtype=torch.float32, device=x.device),
             torch.zeros((b, n_heads, dh), dtype=torch.float32, device=x.device),
             torch.zeros((b, n_heads), dtype=torch.float32, device=x.device))
    hs = []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        h, state = _mlstm_chunk(q[:, :, sl], k[:, :, sl], v[:, :, sl], lf[..., sl],
                                li[..., sl], state)
        hs.append(h)
    h = torch.cat(hs, dim=2)[:, :, :s].transpose(1, 2).reshape(b, s, d_inner)
    out = _mlstm_out(params, h, xc, z)
    if return_state:
        c_f, n_f, m_f = state
        return out, {"c": c_f, "n": n_f, "m": m_f, "conv": conv_state.to(COMPUTE_DTYPE)}
    return out


def mlstm_decode(params, x: torch.Tensor, state: dict, *, n_heads: int):
    """One token per row.  x (B, 1, Dm); state {"c": (B, H, Dh, Dh), "n":
    (B, H, Dh), "m": (B, H), "conv": (B, 3, D_inner)}.  Returns (out (B, 1,
    Dm), the new state).  The memory update ``f C + i k v^T`` is one scale
    and one in-place ``addcmul_`` over C."""
    b = x.shape[0]
    xz = x @ params["w_up"]
    d_inner = xz.shape[-1] // 2
    xi, z = xz[..., :d_inner], xz[..., d_inner:]
    xc, conv_state = _causal_conv(xi, params["conv_w"], state["conv"])
    xc = _silu_bf16(xc)
    q, k, v, li, lf_pre = _mlstm_in(params, xi, xc, n_heads)
    q, k, v = q[:, :, 0], k[:, :, 0], v[:, :, 0]              # (B, H, Dh)
    li, lf = li[:, 0], F.logsigmoid(lf_pre[:, 0])             # (B, H)

    m_new = torch.maximum(lf + state["m"], li)
    f_w = torch.exp(lf + state["m"] - m_new)
    i_w = torch.exp(li - m_new)
    c = (state["c"] * f_w[..., None, None]).addcmul_((i_w[..., None] * k)[..., :, None],
                                                     v[..., None, :])
    n = f_w[..., None] * state["n"] + i_w[..., None] * k
    num = (q[..., None, :] @ c)[..., 0, :]
    den = torch.abs((q * n).sum(-1))
    h = num / torch.maximum(den, torch.exp(-m_new))[..., None]
    out = _mlstm_out(params, h.reshape(b, 1, d_inner), xc, z)
    return out, {"c": c, "n": n, "m": m_new, "conv": conv_state}


# ---------------------------------------------------------------------------
# sLSTM (xLSTM scalar memory; sequential)
# ---------------------------------------------------------------------------

def slstm_init(gen: torch.Generator, d_model: int, n_heads: int) -> dict:
    dh = d_model // n_heads
    dev = gen.device
    return {
        "w_gates": dense_init(gen, d_model, 4 * d_model),    # z i f o from x
        "r_gates": (_normal(gen, (n_heads, dh, 4 * dh)) * (1.0 / dh) ** 0.5
                    ).to(COMPUTE_DTYPE),                     # block-diagonal recurrence
        "gate_bias": torch.cat([
            torch.zeros((2 * d_model,), dtype=torch.float32, device=dev),
            torch.full((d_model,), 3.0, dtype=torch.float32, device=dev),   # f bias
            torch.zeros((d_model,), dtype=torch.float32, device=dev)]),
    }


def slstm_apply(params, x: torch.Tensor, *, n_heads: int, state: dict | None = None):
    """x (B, S, D), one position after another from ``state`` ({"c", "n",
    "h", "m"} each (B, D) f32; None: the cold state).  Returns (y (B, S, D)
    bf16, the state after x); decode calls it with S = 1."""
    b, s, d = x.shape
    dh = d // n_heads
    wx = (x @ params["w_gates"]).float()
    if state is None:
        zeros = torch.zeros((b, d), dtype=torch.float32, device=x.device)
        state = {"c": zeros, "n": zeros + 1e-6, "h": zeros, "m": zeros}
    r = params["r_gates"].float()
    c, n, h, m = state["c"], state["n"], state["h"], state["m"]
    hs = []
    for t in range(s):
        rec = torch.einsum("bhd,hde->bhe", h.reshape(b, n_heads, dh), r).reshape(b, 4 * d)
        zp, ip, fp, op = (wx[:, t] + rec + params["gate_bias"]).split(d, dim=-1)
        lf = F.logsigmoid(fp)
        m_new = torch.maximum(lf + m, ip)
        i_w = torch.exp(ip - m_new)
        f_w = torch.exp(lf + m - m_new)
        c = f_w * c + i_w * torch.tanh(zp)
        n = f_w * n + i_w
        h = torch.sigmoid(op) * c / torch.clamp(n, min=1e-6)
        m = m_new
        hs.append(h)
    return torch.stack(hs, dim=1).to(COMPUTE_DTYPE), {"c": c, "n": n, "h": h, "m": m}
