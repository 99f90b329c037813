"""Train, prefill and serve step builders, on one device.

Port of ``repro.launch.steps`` without a mesh (the port runs one device;
``sharding.py`` is not ported):

  build_train_step   — loss -> gradients -> AdamW, params updated in place
  build_prefill_step — forward + KV/state cache materialization
  build_serve_step   — one decode token against the cache (greedy: argmax)

Each returns a ``StepBundle``: the step function and its abstract inputs,
meta-device tensors of the cell's shapes (``configs.specs``), which the dry
run traces the step against, as the JAX bundle's ``abstract_args`` are
lowered.  ``bundle_for`` dispatches on the shape's kind.

The training step takes and returns ``(params, opt_state, metrics)`` like
the JAX one; here ``params`` and the optimizer state are updated in place.
Gradient accumulation over ``microbatches`` A takes JAX's rows: the batch
is reshaped to (B/A, A, ...) and microbatch i is minor index i, rows
``i::A``.  Each microbatch's gradients are added in f32, divided by A, into
one f32 tree (as large as the master weights); loss and metrics are
averaged the same way.  With A = 1 the parameters' own (bf16) ``.grad``
feed the update, as JAX's grads do.

The serve step is ``model.decode_step`` (plus an argmax when greedy) over a
contiguous cache, as JAX's is: it reaches no paged-attention kernel.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.configs import specs as spec_mod
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.models.model import Model, make_model
from repro_torch.train import optimizer as opt_mod

METRIC_KEYS = ("lb_loss", "z_loss", "drop_frac", "ce_loss")


class StepBundle(NamedTuple):
    fn: Callable          # the step
    abstract_args: tuple  # meta tensors of its inputs: fn(*abstract_args) traces it


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

    params = spec_mod.abstract_params(model)
    abstract = (params, opt_mod.adamw_init(params),
                spec_mod.train_batch_specs(model.cfg, shape))
    return StepBundle(train_step, abstract)


def build_prefill_step(model: Model, shape: ShapeSpec) -> StepBundle:
    """``model.prefill``: (params, batch) -> (last logits, cache)."""
    return StepBundle(model.prefill, (spec_mod.abstract_params(model),
                                      spec_mod.prefill_batch_specs(model.cfg, shape)))


def build_serve_step(model: Model, shape: ShapeSpec, *, greedy: bool = False) -> StepBundle:
    """One decode step: (params, tokens (B, 1), cache, cur_len) -> (logits
    (B, V) f32, or with ``greedy`` the argmax tokens (B,) int32; cache)."""
    def serve_step(params, tokens, cache, cur_len):
        logits, cache = model.decode_step(params, tokens, cache, cur_len)
        if greedy:
            return torch.argmax(logits, -1).to(torch.int32), cache
        return logits, cache

    return StepBundle(serve_step, (spec_mod.abstract_params(model),
                                   *spec_mod.decode_specs(model, shape)))


def default_microbatches(cfg: ArchConfig) -> int:
    n = cfg.analytic_param_count()
    if n > 2e10:
        return 16
    if n > 5e9:
        return 8
    return 4


def bundle_for(arch_cfg: ArchConfig, shape: ShapeSpec, *, microbatches: int | None = None,
               greedy: bool = False) -> StepBundle:
    """Dispatch on the shape kind (train/prefill/decode); the batch is the
    shape's ``global_batch``."""
    model = make_model(arch_cfg)
    if shape.kind == "train":
        mb = microbatches if microbatches is not None else default_microbatches(arch_cfg)
        return build_train_step(model, shape, microbatches=mb)
    if shape.kind == "prefill":
        return build_prefill_step(model, shape)
    return build_serve_step(model, shape, greedy=greedy)
