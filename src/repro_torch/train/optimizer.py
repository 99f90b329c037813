"""AdamW with mixed-precision master weights, leaf by leaf and in place.

Port of ``repro.train.optimizer`` with its arithmetic: f32 master, m and v
per parameter; the global norm of the gradients (reported before the clip)
scales every gradient by ``min(1, clip_norm / max(norm, 1e-9))``; the
learning rate and the bias corrections are 0-d f32 tensors computed as the
JAX package computes them (Python constants meet f32 values as weak types,
so every product is an f32 product).

A tree is a dict of tensors keyed by parameter name, or a module whose
``named_parameters()`` give them (``models.model.ParamTree``).  The update
walks the leaves one at a time and writes master, m and v in place, then
copies the master back into the compute parameter (``copy_`` rounds f32 to
bf16 as ``astype`` does): no whole-tree temporary (at phi3-mini-3.8b's 3.8 B
parameters an f32 copy of the gradients is 15 GB).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn


class OptState(NamedTuple):
    step: torch.Tensor      # () int32
    master: dict            # f32 copy of each parameter
    m: dict                 # f32 first moment
    v: dict                 # f32 second moment


def leaves(tree) -> dict:
    """A tree's leaves by name: a module's ``named_parameters()``, or the
    dict itself."""
    return dict(tree.named_parameters()) if isinstance(tree, nn.Module) else tree


def adamw_init(params) -> OptState:
    ps = leaves(params)
    device = next(iter(ps.values())).device
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        master={n: p.detach().to(torch.float32, copy=True) for n, p in ps.items()},
        m={n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for n, p in ps.items()},
        v={n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for n, p in ps.items()},
    )


def _cos(x: torch.Tensor) -> torch.Tensor:
    """f32 cosine, correctly rounded (through f64), as XLA's f32 ``cos``
    is at almost every step; ``torch.cos`` in f32 is an ulp off at some."""
    return torch.cos(x.double()).float()


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """IEEE (correctly rounded) f32 sqrt, as XLA's and CUDA's are.  PyTorch's
    CPU f32 sqrt is an ulp off on about 0.7 % of inputs, so there it goes
    through f64 (exact after rounding back)."""
    return torch.sqrt(x) if x.is_cuda else torch.sqrt(x.double()).float()


def cosine_schedule(base_lr: float, warmup: int, total: int, min_frac: float = 0.1):
    """Linear warm-up to ``base_lr``, then cosine decay to ``min_frac *
    base_lr`` at ``total``; ``lr(step)`` takes and returns 0-d tensors."""
    def lr(step):
        step = step.to(torch.float32)
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * (min_frac + (1 - min_frac) * 0.5 * (1 + _cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)
    return lr


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares."""
    total = None
    for g in leaves(tree).values():
        sq = torch.square(g.float()).sum()
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(grads, opt: OptState, params, *, lr_fn, b1=0.9, b2=0.95,
                 eps=1e-8, weight_decay=0.1, clip_norm=1.0):
    """Returns (params, the new OptState, stats {"grad_norm" (pre-clip),
    "lr"}).  ``params`` and the state's master, m and v are updated in
    place; ``grads`` (bf16 or f32, by the parameters' names) are read."""
    step = opt.step + 1
    lr = lr_fn(step)
    gn = global_norm(grads)
    scale = torch.clamp(clip_norm / torch.clamp(gn, min=1e-9), max=1.0)
    t = step.to(torch.float32)
    bc1 = 1 - b1 ** t
    bc2 = 1 - b2 ** t
    gs = leaves(grads)
    for name, p in leaves(params).items():
        g = gs[name].float() * scale
        m, v, master = opt.m[name], opt.v[name], opt.master[name]
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        u = (m / bc1) / (_sqrt(v / bc2) + eps)
        master.sub_(lr * (u + weight_decay * master))
        p.copy_(master)
    return params, opt._replace(step=step), {"grad_norm": gn, "lr": lr}
