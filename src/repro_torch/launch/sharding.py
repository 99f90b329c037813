"""Per-tensor sharding rules: TP over 'model', FSDP over 'data', DP over pods.

Port of ``repro.launch.sharding``.  The rules are the JAX package's, by
name and shape: column-parallel weights (input -> expansion) shard their
output dim over 'model' and their input dim over 'data' (ZeRO-3 style);
row-parallel weights (contraction -> output) the reverse, so the FFN pair is
the canonical TP pattern (local matmul, then a sum over 'model').  A dim that
does not divide its axis stays replicated (hymba's vocab 32001).  KV caches
shard KV heads over 'model' when they divide it, else the sequence dim
(split-KV decode); batch 1 shards the sequence over everything.

A spec is a tuple with the entries of JAX's ``PartitionSpec``: per tensor
dim an axis name, a tuple of names, or None (``P()`` is ``()``).  The rules
read only the mesh's axis sizes, so they run on a ``MeshShape``, on a JAX
mesh and on a ``DeviceMesh`` alike; ``placements`` turns a spec into one
DTensor placement per mesh dim, and ``distribute_params`` places a
parameter tree on a ``DeviceMesh``.  ``make_hints`` is the activation
hint the step builders register on a mesh (``models.layers.hint``):
``hint_spec`` gives each tag's spec, JAX's rule for JAX's tags.
"""

from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.mesh import AXIS_DATA, AXIS_MODEL, axis_names, axis_sizes, batch_axes

__all__ = ["COL_NAMES", "EMBED_NAMES", "MOE_REPLICATE_BYTES", "REPLICATED_NAMES",
           "ROW_NAMES", "batch_shardings", "cache_shardings", "distribute_params",
           "distribute_tree", "gather_fsdp", "hint_spec", "kv_cache_spec", "local_batch",
           "local_shard", "logits_sharding", "make_hints", "microbatch_axes",
           "moe_experts_replicated", "param_placements", "param_spec", "placements",
           "tree_key_paths"]

COL_NAMES = {"wq", "wk", "wv", "w_gate", "w_up", "w_in", "w_dt", "w_gates",
             "w_if", "w_bc"}

# experts smaller than this per layer are replicated over 'model' instead of
# expert-parallel (the dispatch-collective tradeoff; see param_spec)
MOE_REPLICATE_BYTES = 1024 * 2**20


def moe_experts_replicated(cfg) -> bool:
    if cfg.ffn != "moe":
        return False
    per_layer = cfg.n_experts * 3 * cfg.d_model * cfg.d_ff * 2  # bf16
    return per_layer < MOE_REPLICATE_BYTES


ROW_NAMES = {"wo", "w_down", "w_out"}
EMBED_NAMES = {"embed", "lm_head"}
REPLICATED_NAMES = {"scale", "bias", "dt_bias", "if_bias", "gate_bias",
                    "d_skip", "skip_scale", "fuse_a", "fuse_m", "meta",
                    "router", "r_gates"}


def _axis_size(mesh, axis) -> int:
    sizes = axis_sizes(mesh)
    if isinstance(axis, tuple):
        n = 1
        for a in axis:
            n *= sizes[a]
        return n
    return sizes.get(axis, 1)


def _if_div(mesh, axis, dim: int):
    """axis if dim divides its size (axis may be a tuple), else None."""
    return axis if axis and dim % _axis_size(mesh, axis) == 0 else None


def _spec(*entries) -> tuple:
    """A spec as ``tuple(PartitionSpec(*entries))``: a one-axis tuple entry
    becomes the axis name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in entries)


def param_spec(cfg: ArchConfig, mesh, path, leaf) -> tuple:
    """The spec of one parameter leaf (``path``: its tuple of dict keys;
    ``leaf``: anything with ``shape``).  A leaf of one layer gives the spec
    of the JAX package's stacked leaf without its leading stack dims."""
    name = path[-1]
    shape = tuple(leaf.shape)
    nd = len(shape)
    sizes = axis_sizes(mesh)
    tp = AXIS_MODEL if AXIS_MODEL in sizes else None
    fsdp = AXIS_DATA if AXIS_DATA in sizes else None

    def pad(*tail):
        return _spec(*(None,) * (nd - len(tail)), *tail)

    if name in REPLICATED_NAMES or nd == 0:
        return ()
    if name in EMBED_NAMES:
        return pad(_if_div(mesh, tp, shape[-2]), _if_div(mesh, fsdp, shape[-1]))
    if cfg.ffn == "moe" and "mlp" in path and name in {"w_gate", "w_up", "w_down"}:
        e = shape[-3]
        # replicating small experts over 'model' keeps the MoE dispatch
        # local to the batch shard (no all-gather of the token buffers)
        expert_tp = tp if not moe_experts_replicated(cfg) else None
        if name == "w_down":  # (E, F, D)
            return pad(_if_div(mesh, expert_tp, e), None, _if_div(mesh, fsdp, shape[-1]))
        return pad(_if_div(mesh, expert_tp, e), _if_div(mesh, fsdp, shape[-2]), None)
    if name in COL_NAMES:
        return pad(_if_div(mesh, fsdp, shape[-2]), _if_div(mesh, tp, shape[-1]))
    if name in ROW_NAMES:
        return pad(_if_div(mesh, tp, shape[-2]), _if_div(mesh, fsdp, shape[-1]))
    if name == "conv_w":  # (K, D) depthwise
        return pad(None, _if_div(mesh, tp, shape[-1]))
    if name == "a_log":  # (D, N)
        return pad(_if_div(mesh, tp, shape[-2]), None)
    return ()


def batch_shardings(cfg: ArchConfig, mesh, batch_specs: dict, batch_size: int,
                    rows: tuple | None = None) -> dict:
    """The spec of each leaf of a train or prefill batch: batch over the
    batch axes when they divide it (``rows``: over those axes instead, as
    ``microbatch_axes`` gives them)."""
    ba = _if_div(mesh, batch_axes(mesh) if rows is None else rows, batch_size)
    return {k: _spec(ba, *([None] * (len(v.shape) - 1))) for k, v in batch_specs.items()}


def kv_cache_spec(cfg: ArchConfig, mesh, batch_size: int, name: str, leaf) -> tuple:
    """The spec of a decode-cache leaf.

    Attention K/V (L, B, S, KVH, Dh): batch over the batch axes when they
    divide it; KV heads over 'model' when they divide it, else the sequence
    over 'model' (split-KV).  Batch 1: the sequence over (batch axes +
    'model').  Recurrent states: the batch dim over the batch axes, the
    last dim over 'model' when it divides it and is at least 128."""
    tp = AXIS_MODEL if AXIS_MODEL in axis_sizes(mesh) else None
    ba = _if_div(mesh, batch_axes(mesh), batch_size)
    shape = tuple(leaf.shape)
    nd = len(shape)

    if name in ("k", "v", "xk", "xv") and nd == 5:
        _l, _b, s, kvh, _dh = shape
        head_tp = _if_div(mesh, tp, kvh) if kvh >= _axis_size(mesh, tp or "x") else None
        if ba is None:
            seq_axes = tuple(a for a in (*batch_axes(mesh), tp) if a) if head_tp is None \
                else batch_axes(mesh)
            return _spec(None, None, _if_div(mesh, seq_axes, s), head_tp, None)
        if head_tp is not None:
            return _spec(None, ba, None, head_tp, None)
        return _spec(None, ba, _if_div(mesh, tp, s), None, None)

    if nd >= 3:
        spec = [None] * nd
        # the batch dim: xLSTM states lead with (G, g-1, B, ...) or (G, B, ...)
        bdim = next((i for i, sz in enumerate(shape) if sz == batch_size and i < nd - 1),
                    None)
        if bdim is not None and ba is not None:
            spec[bdim] = ba
        if tp and shape[-1] % _axis_size(mesh, tp) == 0 and shape[-1] >= 128:
            spec[-1] = tp
        return _spec(*spec)
    return ()


def cache_shardings(cfg: ArchConfig, mesh, cache_specs, batch_size: int):
    """``kv_cache_spec`` of every leaf of a cache tree (nested dicts), each
    named by its last key."""
    def walk(t, name=None):
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        return kv_cache_spec(cfg, mesh, batch_size, name, t)

    return walk(cache_specs)


def logits_sharding(cfg: ArchConfig, mesh, batch_size: int) -> tuple:
    ba = _if_div(mesh, batch_axes(mesh), batch_size)
    tp = AXIS_MODEL if AXIS_MODEL in axis_sizes(mesh) else None
    return _spec(ba, _if_div(mesh, tp, cfg.vocab_size))


def microbatch_axes(mesh, rows: int) -> tuple:
    """The batch axes a microbatch of ``rows`` rows is laid over when a
    rank's block of the batch is not a multiple of the microbatch count:
    the longest tail of the batch axes whose size divides ``rows`` (so
    'pod', the outer axis, is dropped first); the rows are replicated over
    the axes left out.  Every rank of those axes then holds as many rows of
    the microbatch."""
    ba = batch_axes(mesh)
    return next(ba[k:] for k in range(len(ba) + 1) if rows % _axis_size(mesh, ba[k:]) == 0)


def hint_spec(cfg: ArchConfig, mesh, tag: str, shape, rows: tuple | None = None) -> tuple | None:
    """The spec ``make_hints`` lays an activation of ``shape`` out by, or
    None where the tag pins nothing; the batch dim goes over the batch axes
    where they divide it (``rows``: over those axes instead, a microbatch's
    ``microbatch_axes``).  JAX's tags:

      act          — (B, S, D) residual stream: batch over the batch axes
                     where they divide it, the rest replicated;
      logits       — (..., V): batch-sharded, vocab over 'model' if it
                     divides;
      moe_dispatch, moe_return — (gc, E, C, D) expert buffers: gc over the
                     batch axes, experts over 'model' unless
                     ``moe_experts_replicated``.

    and the port's own, where a DTensor needs a layout GSPMD finds itself:
      heads        — (B, S, n·Dh) q/k/v projection or attention output:
                     batch-sharded, the last dim over 'model' only when the
                     n heads divide it (hymba's 5 heads over 2 stay whole);
      loss_logits  — the cross-entropy's logits chunk: batch-sharded with
                     whole vocab rows (its gather and logsumexp read a
                     row)."""
    ba = batch_axes(mesh) if rows is None else rows
    tp = AXIS_MODEL if AXIS_MODEL in axis_sizes(mesh) else None
    nd = len(shape)
    if tag == "act" and nd >= 2:
        return _spec(_if_div(mesh, ba, shape[0]), *([None] * (nd - 1)))
    if tag == "logits":
        return _spec(_if_div(mesh, ba, shape[0]), *([None] * (nd - 2)),
                     _if_div(mesh, tp, shape[-1]))
    if tag in ("moe_dispatch", "moe_return") and nd == 4:
        etp = None if moe_experts_replicated(cfg) else _if_div(mesh, tp, shape[1])
        return _spec(_if_div(mesh, ba, shape[0]), etp, None, None)
    if tag == "heads" and nd >= 2 and shape[-1] % cfg.head_dim == 0:
        n = shape[-1] // cfg.head_dim
        whole = tp if tp and n % _axis_size(mesh, tp) == 0 else None
        return _spec(_if_div(mesh, ba, shape[0]), *([None] * (nd - 2)), whole)
    if tag == "loss_logits" and nd >= 1:
        return _spec(_if_div(mesh, ba, shape[0]), *([None] * (nd - 1)))
    return None


def _pin():
    """The autograd Function of a hint: the value redistributed to the
    placements, and its gradient too on the way back, as a sharding
    constraint in JAX constrains the cotangent (DTensor would otherwise
    carry a pending sum over 'model' into the backward's matmuls and run
    them on every rank of the axis)."""
    import torch

    class Pin(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, mesh, want):
            ctx.mesh, ctx.want = mesh, want
            return x.redistribute(mesh, want) if tuple(x.placements) != want \
                else x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            if tuple(g.placements) != ctx.want:
                g = g.redistribute(ctx.mesh, ctx.want)
            return g, None, None

    return Pin


def make_hints(cfg: ArchConfig, mesh, rows: tuple | None = None):
    """The activation hint of a step on the ``DeviceMesh`` ``mesh``
    (registered with ``models.layers.set_sharding_hints``): a DTensor and
    its gradient are redistributed to its tag's ``hint_spec`` (a pending
    sum is reduced there; ``rows`` as there); a plain tensor, or a tag with
    no spec, is left as it is.  The rules read the activation's own leading
    dim, so JAX's ``batch_size`` argument, which its rules never read, is
    dropped."""
    from torch.distributed.tensor import DTensor

    pin = _pin()

    def hint(x, tag):
        if not isinstance(x, DTensor):
            return x
        spec = hint_spec(cfg, mesh, tag, tuple(x.shape), rows)
        if spec is None:
            return x
        want = placements(spec, mesh)
        if tuple(x.placements) == want and not x.requires_grad:
            return x
        return pin.apply(x, mesh, want)

    return hint


# ---------------------------------------------------------------------------
# Specs as DTensor placements
# ---------------------------------------------------------------------------

def placements(spec: tuple, mesh) -> tuple:
    """One DTensor placement per mesh dim, in mesh order: ``Shard(i)`` where
    tensor dim ``i`` of ``spec`` names that axis (alone or in a tuple) and
    the axis is wider than one device, ``Replicate()`` where no dim does.
    A tuple entry must list its axes in mesh order, since DTensor splits a
    dim over several mesh dims in that order."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    sizes = axis_sizes(mesh)
    out = []
    for name in names:
        dims = [i for i, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        if len(dims) > 1:
            raise ValueError(f"spec {spec} shards dims {dims} over one axis {name!r}")
        # an axis of one device holds the whole dim: DTensor cannot merge a
        # dim it counts as sharded into another (a view), even over one device
        out.append(Shard(dims[0]) if dims and sizes[name] > 1 else Replicate())
    for e in spec:
        if isinstance(e, tuple) and list(e) != sorted(e, key=names.index):
            raise ValueError(f"spec entry {e} is not in mesh order {names}")
    return tuple(out)


def tree_key_paths(tree, path=()):
    """``(key path, leaf)`` of every leaf of a parameter tree (nested dicts
    or lists, or a ``ParamTree``), the key path its dict keys only: the
    JAX package's path of the stacked leaf it is a layer of."""
    from torch import nn

    if isinstance(tree, nn.ModuleList) or isinstance(tree, (list, tuple)):
        for x in tree:
            yield from tree_key_paths(x, path)
    elif isinstance(tree, nn.Module):
        for name, p in tree._parameters.items():
            yield (*path, name), p
        for name, m in tree._modules.items():
            yield from tree_key_paths(m, (*path, name))
    elif isinstance(tree, dict):
        for name, v in tree.items():
            yield from tree_key_paths(v, (*path, name))
    else:
        yield path, tree


def _map_tree(tree, fn, path=()):
    """``tree`` with every leaf replaced by ``fn(key path, leaf)``, as
    nested dicts and lists (a ``ParamTree`` becomes a dict)."""
    from torch import nn

    if isinstance(tree, nn.ModuleList) or isinstance(tree, (list, tuple)):
        return [_map_tree(x, fn, path) for x in tree]
    if isinstance(tree, nn.Module):
        out = {name: fn((*path, name), p) for name, p in tree._parameters.items()}
        out.update({name: _map_tree(m, fn, (*path, name)) for name, m in tree._modules.items()})
        return out
    if isinstance(tree, dict):
        return {name: _map_tree(v, fn, (*path, name)) for name, v in tree.items()}
    return fn(path, tree)


def param_placements(cfg: ArchConfig, mesh, params):
    """The placements of every leaf of the port's parameter tree, by its
    JAX key path (nested dicts and lists)."""
    return _map_tree(params, lambda path, p: placements(param_spec(cfg, mesh, path, p), mesh))


def distribute_params(cfg: ArchConfig, mesh, params):
    """``params`` placed on the ``DeviceMesh`` ``mesh`` by ``param_spec``:
    a tree of DTensors (nested dicts and lists).  Every rank passes the same
    global values and keeps its block (``local_shard``; no communication,
    so meta tensors place too)."""
    from repro_torch.models.layers import from_local

    def place(path, p):
        pl = placements(param_spec(cfg, mesh, path, p), mesh)
        t = p.detach()
        return from_local(local_shard(t, mesh, pl), mesh, pl, t.shape, t.stride())

    return _map_tree(params, place)


def gather_fsdp(mesh, params):
    """The parameter tree as a step reads it on ``mesh``: each DTensor
    gathered over the batch axes (FSDP: 'data' shards a weight only at rest,
    ZeRO-3 style), still sharded over 'model' (nested dicts and lists).
    Differentiable: each gradient goes back reduce-scattered into its
    parameter's layout."""
    from torch.distributed.tensor import Replicate

    ba = set(batch_axes(mesh))
    names = axis_names(mesh)

    def gathered(path, p):
        want = tuple(Replicate() if names[i] in ba else pl for i, pl in enumerate(p.placements))
        return p if tuple(p.placements) == want else p.redistribute(mesh, want)

    return _map_tree(params, gathered)


def local_shard(t, mesh, pl):
    """This rank's block of the full tensor ``t`` under the placements
    ``pl`` on the ``DeviceMesh`` ``mesh``, as ``distribute_tensor`` lays it
    out (``torch.chunk`` along each sharded dim, mesh dims in order), with
    no communication: every rank holds ``t``."""
    import torch

    coord = mesh.get_coordinate()
    for i, p in enumerate(pl):
        if p.is_shard():
            chunks = torch.chunk(t, mesh.size(i), p.dim)
            t = chunks[coord[i]] if coord[i] < len(chunks) else t.narrow(p.dim, 0, 0)
    return t


def distribute_tree(mesh, tree, specs):
    """The nested dicts ``tree`` of full tensors, equal on every rank, as
    DTensors on ``mesh`` laid out by ``specs`` (the same nesting; e.g.
    ``cache_shardings``), each rank keeping its block with no
    communication."""
    from repro_torch.models.layers import from_local

    if isinstance(tree, dict):
        return {k: distribute_tree(mesh, v, specs[k]) for k, v in tree.items()}
    pl = placements(specs, mesh)
    return from_local(local_shard(tree, mesh, pl), mesh, pl, tree.shape, tree.stride())


def local_batch(mesh, batch: dict, batch_size: int, rows: tuple | None = None) -> dict:
    """This rank's rows of a global batch (a dict of arrays or tensors with
    ``batch_size`` rows), per ``batch_shardings`` (``rows`` as there): the
    block of the batch axes' coordinate (pod major) when those axes divide
    the batch, else every row."""
    ba = _if_div(mesh, batch_axes(mesh) if rows is None else rows, batch_size)
    if ba is None:
        return dict(batch)
    coord = dict(zip(axis_names(mesh), mesh.get_coordinate()))
    sizes = axis_sizes(mesh)
    idx, n = 0, 1
    for a in ba:
        idx, n = idx * sizes[a] + coord[a], n * sizes[a]
    rows = batch_size // n
    return {k: v[idx * rows:(idx + 1) * rows] for k, v in batch.items()}
