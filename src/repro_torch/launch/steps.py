"""Train, prefill and serve step builders, on one device or on a mesh.

Port of ``repro.launch.steps``:

  build_train_step   — loss -> gradients -> AdamW, params updated in place
  build_prefill_step — forward + KV/state cache materialization
  build_serve_step   — one decode token against the cache (greedy: argmax)

Each returns a ``StepBundle``: the step function and its abstract inputs,
meta-device tensors of the cell's shapes (``configs.specs``), which the dry
run traces the step against, as the JAX bundle's ``abstract_args`` are
lowered.  ``bundle_for`` dispatches on the shape's kind.

``mesh`` (keyword-only) is None for one device, or a ``DeviceMesh`` inside
its process group; the JAX builders' ``in_shardings``/``out_shardings``
become DTensor placements:

* parameters are DTensors laid out by ``param_spec`` (``place_params``: a
  ``ParamTree`` of DTensor parameters), and AdamW's f32 master, m and v
  take their parameter's placements (``adamw_init`` of that tree); the step
  counter is a plain tensor, the same on every rank.  The model reads them
  gathered over the batch axes (FSDP, per call or microbatch;
  ``launch.sharding.gather_fsdp``) and still sharded over 'model', so each
  row's math is one device's, and each gradient comes back reduce-scattered;
* the batch comes as this rank's rows (``launch.sharding.local_batch``:
  the block of the batch axes per ``batch_shardings``); the step makes the
  global DTensor of it.  Microbatch i is the global rows ``i::A``: local
  rows ``i::A`` on every rank where each rank's block holds a multiple of A
  rows, so every microbatch stays sharded as the batch.  Where a block is
  not a multiple of A rows (pod2's train_4k: 8 rows a rank, 16
  microbatches), the step
  gathers the batch (token ids: a few MB) and lays each microbatch over
  ``launch.sharding.microbatch_axes`` ('data' for 16 rows on pod2),
  replicated over the other batch axes, with the hints laid out the same
  way; the ranks that hold the same rows compute the same partial
  gradients, and DTensor sums the distinct ones into the full-batch
  gradient;
* the model runs on DTensors with ``make_hints`` registered for the call
  only (``models.layers.sharding_hints``) and plain tensors taken as
  replicated (``implicit_replication``: positions, masks, constants);
* each gradient is laid out as its parameter before the update; metrics
  come back as plain 0-d tensors, the same on every rank; prefill's logits
  and cache and the serve step's are laid out by ``logits_sharding`` and
  ``cache_shardings`` (greedy tokens by the batch axes).

On a mesh the abstract inputs are meta DTensors: the dry run builds the
bundle on a ``launch.mesh.fake_mesh``.

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

import contextlib
from typing import Callable, NamedTuple

import torch

from repro_torch.configs import specs as spec_mod
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.launch import sharding as shd
from repro_torch.models import layers as layers_mod
from repro_torch.models.model import Model, ParamTree, make_model
from repro_torch.train import optimizer as opt_mod

METRIC_KEYS = ("lb_loss", "z_loss", "drop_frac", "ce_loss")


class StepBundle(NamedTuple):
    fn: Callable          # the step
    abstract_args: tuple  # meta tensors of its inputs: fn(*abstract_args) traces it
    mesh: object = None   # the DeviceMesh it runs on; None: one device


def _device_mesh(mesh):
    """``mesh`` when it is a ``DeviceMesh`` (None stays None)."""
    if mesh is None:
        return None
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"a step on a mesh needs a DeviceMesh inside its process group, "
                        f"got {mesh!r} (launch.mesh.fake_mesh gives one to trace on)")
    return mesh


def place_params(cfg: ArchConfig, mesh, params) -> ParamTree:
    """``params`` (every rank the same values) as a frozen ``ParamTree`` of
    DTensor parameters laid out by ``param_spec`` on ``mesh``."""
    return ParamTree(shd.distribute_params(cfg, mesh, params))


@contextlib.contextmanager
def _on_mesh(cfg: ArchConfig, mesh):
    """The model's DTensor context on ``mesh``: ``make_hints`` registered,
    plain tensors taken as replicated.  Nothing on one device."""
    if mesh is None:
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication

    with layers_mod.sharding_hints(shd.make_hints(cfg, mesh)), \
            implicit_replication():
        yield


def _global(cfg: ArchConfig, mesh, batch: dict, batch_size: int, rows=None) -> dict:
    """This rank's rows of a batch as the global DTensors (``batch_size``
    rows, per ``batch_shardings``; ``rows`` as there); a batch on one device
    as it is."""
    if mesh is None:
        return batch
    specs = shd.batch_shardings(cfg, mesh, batch, batch_size, rows)
    out = {}
    for k, v in batch.items():
        shape = (batch_size, *v.shape[1:]) if specs[k] and specs[k][0] else tuple(v.shape)
        out[k] = layers_mod.from_local(v, mesh, shd.placements(specs[k], mesh), shape)
    return out


def _laid_out(x, mesh, spec):
    """The DTensor ``x`` redistributed to ``spec`` (as it is on one device)."""
    if mesh is None:
        return x
    pl = shd.placements(spec, mesh)
    return x if tuple(x.placements) == pl else x.redistribute(mesh, pl)


def _tree_laid_out(tree, mesh, specs):
    if isinstance(tree, dict):
        return {k: _tree_laid_out(v, mesh, specs[k]) for k, v in tree.items()}
    return _laid_out(tree, mesh, specs)


def _read(mesh, params):
    """The parameters as the model reads them: on a mesh gathered over the
    batch axes (``launch.sharding.gather_fsdp``), every row's math then as
    on one device; the ``ParamTree`` itself on one device."""
    return params if mesh is None else shd.gather_fsdp(mesh, params)


def _plain(x):
    """A metric as a plain detached tensor: a DTensor's full value."""
    x = x.detach()
    return x.full_tensor() if layers_mod.is_dtensor(x) else x


def _abstract_params(model: Model, mesh):
    params = spec_mod.abstract_params(model)
    return params if mesh is None else place_params(model.cfg, mesh, params)


def _abstract_batch(mesh, batch: dict, batch_size: int) -> dict:
    return batch if mesh is None else shd.local_batch(mesh, batch, batch_size)


def build_train_step(model: Model, shape: ShapeSpec, *, mesh=None, lr: float = 3e-4,
                     warmup: int = 100, total_steps: int = 10000,
                     microbatches: int = 1) -> StepBundle:
    """The training step with gradient accumulation over ``microbatches``.
    Its metrics: ``lb_loss``, ``z_loss``, ``drop_frac``, ``ce_loss``,
    ``loss`` (the total), ``grad_norm`` (before the clip) and ``lr``, each a
    0-d f32 tensor on the parameters' device (no host sync)."""
    mesh = _device_mesh(mesh)
    cfg, b = model.cfg, shape.global_batch
    if b % microbatches:
        raise ValueError(f"batch {b} is not a multiple of {microbatches} microbatches")
    a = microbatches
    ba = shd._if_div(mesh, shd.batch_axes(mesh), b) if mesh is not None else None
    # a rank's block of the batch is not a multiple of A rows: each
    # microbatch is laid over the batch axes that divide it
    spread = shd.microbatch_axes(mesh, b // a) if ba and (
        b // shd._axis_size(mesh, ba)) % a else None
    lr_fn = opt_mod.cosine_schedule(lr, warmup, total_steps)

    def microbatch(batch_in, i):
        """Microbatch i (global rows ``i::A``) and the hints to run it with."""
        if spread is None:
            return (_global(cfg, mesh, {k: v[i::a] for k, v in batch_in.items()}, b // a),
                    contextlib.nullcontext())
        rows = {k: v[i::a] for k, v in batch_in.items()}
        return (_global(cfg, mesh, shd.local_batch(mesh, rows, b // a, spread), b // a,
                        spread),
                layers_mod.sharding_hints(shd.make_hints(cfg, mesh, spread)))

    def grad_of(p):
        """``p.grad`` laid out as ``p`` (a DTensor's may come back Partial)."""
        g = p.grad
        if mesh is None or tuple(g.placements) == tuple(p.placements):
            return g
        return g.redistribute(mesh, p.placements)

    def train_step(params, opt_state, batch_in):
        with _on_mesh(cfg, mesh):
            params.requires_grad_(True)
            named = dict(params.named_parameters())
            if a == 1:
                loss, metrics = model.loss(_read(mesh, params), _global(cfg, mesh, batch_in, b))
                loss.backward()
                grads = {n: grad_of(p) for n, p in named.items()}
            else:
                grads = {n: torch.zeros_like(p, dtype=torch.float32)
                         for n, p in named.items()}
                device = next(iter(named.values())).device
                loss = torch.zeros((), dtype=torch.float32, device=device)
                metrics = dict.fromkeys(METRIC_KEYS, loss)
                if spread is not None:      # every row of the batch, on every rank
                    batch_in = {k: v.full_tensor()
                                for k, v in _global(cfg, mesh, batch_in, b).items()}
                for i in range(a):
                    mb, hints = microbatch(batch_in, i)
                    with hints:
                        l_i, m_i = model.loss(_read(mesh, params), mb)
                        l_i.backward()
                    for n, p in named.items():
                        grads[n] += grad_of(p).float() / a
                        p.grad = None
                    loss = loss + l_i.detach() / a
                    metrics = {k: metrics[k] + m_i[k].detach() / a for k in metrics}
            params, opt_state, stats = opt_mod.adamw_update(grads, opt_state, params,
                                                            lr_fn=lr_fn)
            for p in named.values():
                p.grad = None
            metrics = {k: _plain(v) for k, v in metrics.items()}
            return params, opt_state, dict(metrics, loss=_plain(loss), **stats)

    params = _abstract_params(model, mesh)
    abstract = (params, opt_mod.adamw_init(params),
                _abstract_batch(mesh, spec_mod.train_batch_specs(cfg, shape), b))
    return StepBundle(train_step, abstract, mesh)


def build_prefill_step(model: Model, shape: ShapeSpec, *, mesh=None) -> StepBundle:
    """``model.prefill``: (params, batch) -> (last logits, cache); on a mesh
    laid out by ``logits_sharding`` and ``cache_shardings``."""
    mesh = _device_mesh(mesh)
    cfg, b = model.cfg, shape.global_batch
    batch = spec_mod.prefill_batch_specs(cfg, shape)
    if mesh is None:
        return StepBundle(model.prefill, (spec_mod.abstract_params(model), batch))

    def prefill_step(params, batch_in):
        with _on_mesh(cfg, mesh):
            logits, cache = model.prefill(_read(mesh, params), _global(cfg, mesh, batch_in, b))
            return (_laid_out(logits, mesh, shd.logits_sharding(cfg, mesh, b)),
                    _tree_laid_out(cache, mesh, shd.cache_shardings(cfg, mesh, cache, b)))

    return StepBundle(prefill_step, (_abstract_params(model, mesh),
                                     shd.local_batch(mesh, batch, b)), mesh)


def build_serve_step(model: Model, shape: ShapeSpec, *, mesh=None,
                     greedy: bool = False) -> StepBundle:
    """One decode step: (params, tokens (B, 1), cache, cur_len) -> (logits
    (B, V) f32, or with ``greedy`` the argmax tokens (B,) int32; cache).  On
    a mesh the tokens are this rank's rows, the cache DTensors laid out by
    ``cache_shardings`` (``launch.sharding.distribute_tree``), and so are
    the outputs."""
    mesh = _device_mesh(mesh)
    cfg, b = model.cfg, shape.global_batch
    tokens, cache, cur_len = spec_mod.decode_specs(model, shape)

    def serve_step(params, tokens, cache, cur_len):
        with _on_mesh(cfg, mesh):
            tokens = _global(cfg, mesh, {"tokens": tokens}, b)["tokens"]
            logits, cache = model.decode_step(_read(mesh, params), tokens, cache, cur_len)
            if mesh is not None:
                logits = _laid_out(logits, mesh, shd.logits_sharding(cfg, mesh, b))
                cache = _tree_laid_out(cache, mesh, shd.cache_shardings(cfg, mesh, cache, b))
            if greedy:
                out = torch.argmax(logits, -1).to(torch.int32)
                if mesh is not None:
                    out = _laid_out(out, mesh, shd.logits_sharding(cfg, mesh, b)[:1])
                return out, cache
            return logits, cache

    if mesh is not None:
        cache = shd.distribute_tree(mesh, cache, shd.cache_shardings(cfg, mesh, cache, b))
        tokens = shd.local_batch(mesh, {"tokens": tokens}, b)["tokens"]
    return StepBundle(serve_step, (_abstract_params(model, mesh), tokens, cache, cur_len),
                      mesh)


def default_microbatches(cfg: ArchConfig) -> int:
    n = cfg.analytic_param_count()
    if n > 2e10:
        return 16
    if n > 5e9:
        return 8
    return 4


def bundle_for(arch_cfg: ArchConfig, shape: ShapeSpec, *, mesh=None,
               microbatches: int | None = None, greedy: bool = False) -> StepBundle:
    """Dispatch on the shape kind (train/prefill/decode); the batch is the
    shape's ``global_batch``."""
    model = make_model(arch_cfg)
    if shape.kind == "train":
        mb = microbatches if microbatches is not None else default_microbatches(arch_cfg)
        return build_train_step(model, shape, mesh=mesh, microbatches=mb)
    if shape.kind == "prefill":
        return build_prefill_step(model, shape, mesh=mesh)
    return build_serve_step(model, shape, mesh=mesh, greedy=greedy)
