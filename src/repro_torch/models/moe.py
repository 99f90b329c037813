"""Mixture-of-Experts FFN: top-k routing with capacity-factor dispatch.

Port of ``repro.models.moe`` with the JAX package's
semantics to the letter:

  * routing in f32: ``x.float() @ router``, softmax, top-k, the k gates
    renormalised by their sum (floored at 1e-9);
  * each batch row is its own dispatch group: it routes its S tokens (S as
    padded) into ``cap = max(4, int(S * k * capacity_factor / E))`` slots
    per expert; slots go by a cumulative count over the flattened
    (token, rank) order, and a choice whose slot is ``>= cap`` is dropped
    (it contributes 0; the token keeps its residual stream);
  * the expert SwiGLU in bf16 with SiLU in f32; the combine multiplies each
    expert output by its bf16-cast gate and sums the k outputs.

The JAX package scans over chunks of ``group_chunk`` rows only to bound the
dispatch buffer's memory; every row is its own group either way, so here all
rows dispatch in one batched step.  ``moe_decode`` computes every expert on
the B decode tokens and combines through the scattered gate mask in f32, as
the JAX package does (no sparse gather of the top-k experts' weights).
"""

from __future__ import annotations

import functools

import torch

from repro_torch.models.layers import (COMPUTE_DTYPE, _normal, contiguous_grad,
                                       dense_init, hint, rows_local)


def moe_init(gen: torch.Generator, d_model: int, d_ff: int, n_experts: int) -> dict:
    scale_in = (1.0 / d_model) ** 0.5
    scale_out = (1.0 / d_ff) ** 0.5
    return {
        "router": dense_init(gen, d_model, n_experts, dtype=torch.float32),
        "w_gate": _normal(gen, (n_experts, d_model, d_ff)).mul_(scale_in).to(COMPUTE_DTYPE),
        "w_up": _normal(gen, (n_experts, d_model, d_ff)).mul_(scale_in).to(COMPUTE_DTYPE),
        "w_down": _normal(gen, (n_experts, d_ff, d_model)).mul_(scale_out).to(COMPUTE_DTYPE),
    }


def route(params, x: torch.Tensor, top_k: int):
    """The f32 router: x (..., D) -> (logits (..., E), probs, gate values
    (..., k) renormalised, gate indices (..., k))."""
    logits = x.float() @ params["router"]
    probs = torch.softmax(logits, dim=-1)
    gate_v, gate_i = torch.topk(probs, top_k, dim=-1)
    gate_v = gate_v / torch.clamp(gate_v.sum(-1, keepdim=True), min=1e-9)
    return logits, probs, gate_v, gate_i


def _experts(params, buf: torch.Tensor) -> torch.Tensor:
    """Every expert's SwiGLU: buf (E, R, D) (each expert its own rows) or
    (R, D) (every expert the same rows) -> (E, R, D)."""
    h_g = buf @ params["w_gate"]
    h_u = buf @ params["w_up"]
    hf = h_g.float()
    h = (hf * torch.sigmoid(hf)).to(buf.dtype) * h_u      # jax.nn.silu in f32
    return h @ params["w_down"]


def _dispatch(ef, slot, keep, x, *, e: int, cap: int, k: int):
    """The rows' expert buffers (B, E, C, D): each kept choice's token in its
    (expert, slot) cell; a dropped one adds zero to its expert's last slot,
    as in JAX (no boolean indexing: that would sync with the host)."""
    b, _, d = x.shape
    rows = torch.arange(b, device=x.device)[:, None].expand_as(ef)
    xf = x.repeat_interleave(k, dim=1)                          # (B, S*k, D)
    buf = x.new_zeros((e, b, cap, d))
    buf.index_put_((ef, rows, slot), torch.where(keep[..., None], xf, 0).to(x.dtype),
                   accumulate=True)
    return buf.transpose(0, 1)


def _combine(ef, slot, gate, out, *, k: int):
    """Each choice's expert output (out (B, E, C, D)), gated, summed over
    its token's k choices: (B, S, D)."""
    b, sk = ef.shape
    rows = torch.arange(b, device=out.device)[:, None].expand_as(ef)
    yf = out[rows, ef, slot] * gate[..., None]                  # (B, S*k, D)
    return yf.reshape(b, sk // k, k, -1).sum(dim=2)


def moe_apply(params, x: torch.Tensor, *, n_experts: int, top_k: int,
              capacity_factor: float = 1.25):
    """x (B, S, D) -> (y (B, S, D), aux) with aux = {lb_loss, z_loss,
    drop_frac}, each a 0-d f32 tensor on x's device (no host sync)."""
    b, s, d = x.shape
    e, k = n_experts, top_k
    cap = max(4, int(s * k * capacity_factor / e))
    logits, probs, gate_v, gate_i = route(params, x, k)

    # aux losses (Switch Transformer load balance + z-loss)
    me = probs.mean(dim=(0, 1))
    ce = torch.nn.functional.one_hot(gate_i[..., 0], e).float().mean(dim=(0, 1))
    lb_loss = e * (me * ce).sum()
    z_loss = (torch.logsumexp(logits, dim=-1) ** 2).mean()

    # per-row dispatch: slot = the choice's rank among the row's choices of
    # its expert, in (token, rank) order
    ef = gate_i.reshape(b, s * k)
    gf = gate_v.reshape(b, s * k)
    onehot = torch.nn.functional.one_hot(ef, e)                 # (B, S*k, E)
    my_pos = ((onehot.cumsum(dim=1) - 1) * onehot).sum(-1)      # (B, S*k)
    keep = my_pos < cap
    slot = torch.where(keep, my_pos, cap - 1)
    # the hints take JAX's (groups, E, C, D) layout: expert-shard here ...
    # (contiguous: a no-op on one device; a DTensor's shard may come back
    # transposed, which its reshape cannot view)
    buf = rows_local(functools.partial(_dispatch, e=e, cap=cap, k=k), ef, slot, keep, x)
    buf = hint(buf, "moe_dispatch").transpose(0, 1).contiguous()
    out = contiguous_grad(_experts(params, buf.reshape(e, b * cap, d)).reshape(e, b, cap, d))
    out = hint(out.transpose(0, 1), "moe_return")                # ... back to rows

    gate = torch.where(keep, gf, 0.0).to(out.dtype)
    y = rows_local(functools.partial(_combine, k=k), ef, slot, gate, out)
    aux = {"lb_loss": lb_loss, "z_loss": z_loss,
           "drop_frac": (~keep).sum().float() / (b * s * k)}
    return y, aux


def moe_decode(params, x: torch.Tensor, *, n_experts: int, top_k: int) -> torch.Tensor:
    """One token per row, x (B, 1, D) -> (B, 1, D): every expert computes the
    B tokens (the expert weights stream from memory once either way) and
    the outputs combine through the gate mask in f32."""
    b = x.shape[0]
    _, _, gate_v, gate_i = route(params, x[:, 0], top_k)
    mask = gate_v.new_zeros((b, n_experts))
    mask.scatter_(1, gate_i, gate_v)
    out = _experts(params, x[:, 0])                             # (E, B, D)
    y = torch.einsum("ebd,be->bd", out.float(), mask)
    return y[:, None].to(x.dtype)
