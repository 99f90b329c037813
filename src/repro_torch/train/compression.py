"""int8 gradient compression with error feedback, over a process group.

Port of ``repro.train.compression``.  Each rank quantizes its gradient (plus
the residual it carried) to int8 with one f32 scale per tensor, keeps what
the quantization lost as the next residual [Seide et al. 2014; Karimireddy
et al. 2019], and the group sums the int8 values as int32 (int8 would
overflow past 127 ranks) and takes the largest scale; the sum times that
scale is the reduced gradient.

The arithmetic is the JAX package's under ``jit``, on the CPU and on the
card alike: IEEE f32 divisions, rounding half to even (``torch.round``, as
``jnp.round``), a clip to [-127, 127], and the residual rounded once, as
XLA's fused multiply-add rounds it.  The values are summed as int32, so the
all-reduce moves 4 bytes per element, as an f32 all-reduce does: the 4x
saving holds for the stored int8 values, not for these wire bytes.  Under
gloo the collectives of device tensors go through host memory
(``launch.mesh.all_reduce``).
"""

from __future__ import annotations

import torch

__all__ = ["compress_tree", "compressed_all_reduce", "dequantize_int8", "quantize_int8",
           "zeros_residuals"]


def quantize_int8(x: torch.Tensor):
    """Symmetric per-tensor int8 quantization.  Returns (q int8, scale, a
    0-d f32 tensor).  The divisor 127 is a tensor on ``x``'s device: CUDA
    PyTorch divides by a host scalar as a product with its f32 reciprocal,
    an ulp off the IEEE quotient for some maxima."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().max(), 1e-12) / torch.full((), 127.0, device=xf.device)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _residual(g_comp: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``g_comp - q * scale`` rounded once to f32, as XLA computes it under
    ``jit`` (a fused multiply-add).  Through f64 both steps are exact: the
    product has at most 31 significant bits, and the difference, at most
    half a scale, spans at most 26 bits (the input's ulp is at least
    scale / 2^25 wherever q is not 0, and where q is 0 it is the input)."""
    return (g_comp.double() - q.double() * scale.double()).float()


def compressed_all_reduce(g: torch.Tensor, group, residual: torch.Tensor):
    """int8 all-reduce of one gradient leaf over ``group`` with error
    feedback.  Returns (reduced f32, new residual): the int32 sum of every
    rank's int8 values times the largest of their scales."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import all_reduce

    g_comp = g.float() + residual
    q, scale = quantize_int8(g_comp)
    new_residual = _residual(g_comp, q, scale)
    summed = all_reduce(q.to(torch.int32), dist.ReduceOp.SUM, group)
    scale_max = all_reduce(scale.clone(), dist.ReduceOp.MAX, group)
    return summed.float() * scale_max, new_residual


def _map2(fn, a, b):
    """Leaves of two trees of one structure (nested dicts and lists) through
    ``fn``, as a pair of trees."""
    if isinstance(a, dict):
        pairs = {k: _map2(fn, a[k], b[k]) for k in a}
        return {k: v[0] for k, v in pairs.items()}, {k: v[1] for k, v in pairs.items()}
    if isinstance(a, (list, tuple)):
        pairs = [_map2(fn, x, y) for x, y in zip(a, b, strict=True)]
        return [p[0] for p in pairs], [p[1] for p in pairs]
    return fn(a, b)


def compress_tree(grads, group, residuals):
    """``compressed_all_reduce`` over a gradient tree (nested dicts and
    lists of tensors) and its residuals: (reduced tree, new residuals)."""
    return _map2(lambda g, r: compressed_all_reduce(g, group, r), grads, residuals)


def zeros_residuals(grads):
    """An f32 zero residual of each leaf's shape, on its device."""
    if isinstance(grads, dict):
        return {k: zeros_residuals(v) for k, v in grads.items()}
    if isinstance(grads, (list, tuple)):
        return [zeros_residuals(v) for v in grads]
    return torch.zeros(grads.shape, dtype=torch.float32, device=grads.device)
