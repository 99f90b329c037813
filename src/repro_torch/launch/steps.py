"""The training step: loss -> gradients -> AdamW, on one device.

Port of ``repro.launch.steps.build_train_step`` without a mesh (the port
runs one device; ``sharding.py`` and the prefill/serve step bundles are not
ported).  The step takes and returns ``(params, opt_state, metrics)`` like
the JAX one; here ``params`` and the optimizer state are updated in place.

Gradient accumulation over ``microbatches`` A takes JAX's rows: the batch
is reshaped to (B/A, A, ...) and microbatch i is minor index i, rows
``i::A``.  Each microbatch's gradients are added in f32, divided by A, into
one f32 tree (as large as the master weights); loss and metrics are
averaged the same way.  With A = 1 the parameters' own (bf16) ``.grad``
feed the update, as JAX's grads do.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.configs.base import ShapeSpec
from repro_torch.models.model import Model
from repro_torch.train import optimizer as opt_mod

METRIC_KEYS = ("lb_loss", "z_loss", "drop_frac", "ce_loss")


class StepBundle(NamedTuple):
    fn: Callable          # fn(params, opt_state, batch) -> (params, opt_state, metrics)


def build_train_step(model: Model, shape: ShapeSpec, *, lr: float = 3e-4,
                     warmup: int = 100, total_steps: int = 10000,
                     microbatches: int = 1) -> StepBundle:
    """The training step with gradient accumulation over ``microbatches``.
    Its metrics: ``lb_loss``, ``z_loss``, ``drop_frac``, ``ce_loss``,
    ``loss`` (the total), ``grad_norm`` (before the clip) and ``lr``, each a
    0-d f32 tensor on the parameters' device (no host sync)."""
    if shape.global_batch % microbatches:
        raise ValueError(f"batch {shape.global_batch} is not a multiple of "
                         f"{microbatches} microbatches")
    lr_fn = opt_mod.cosine_schedule(lr, warmup, total_steps)
    a = microbatches

    def train_step(params, opt_state, batch_in):
        params.requires_grad_(True)
        named = dict(params.named_parameters())
        if a == 1:
            loss, metrics = model.loss(params, batch_in)
            loss.backward()
            grads = {n: p.grad for n, p in named.items()}
        else:
            grads = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for n, p in named.items()}
            device = next(iter(grads.values())).device
            loss = torch.zeros((), dtype=torch.float32, device=device)
            metrics = dict.fromkeys(METRIC_KEYS, loss)
            for i in range(a):
                l_i, m_i = model.loss(params, {k: v[i::a] for k, v in batch_in.items()})
                l_i.backward()
                for n, p in named.items():
                    grads[n] += p.grad.float() / a
                    p.grad = None
                loss = loss + l_i.detach() / a
                metrics = {k: metrics[k] + m_i[k].detach() / a for k in metrics}
        params, opt_state, stats = opt_mod.adamw_update(grads, opt_state, params,
                                                        lr_fn=lr_fn)
        for p in named.values():
            p.grad = None
        metrics = {k: v.detach() for k, v in metrics.items()}
        return params, opt_state, dict(metrics, loss=loss.detach(), **stats)

    return StepBundle(train_step)
