"""A step's FLOPs, bytes and memory, counted while it runs on meta tensors.

The counterpart of ``repro.roofline.hlo_stats``, which parses XLA's HLO:
PyTorch gives no such program, so the step runs once on the meta device
(shapes and dtypes only, nothing allocated) under one dispatch mode that
counts, per op:

  * flops — ``torch.utils.flop_counter.FlopCounterMode``'s formulas (its
    ``flop_registry``): 2·m·n·k for every matmul (``mm``, ``addmm``,
    ``bmm``, ``baddbmm``, einsums through them) and the convolutions'
    products; elementwise work is not counted, as ``hlo_stats`` counts
    dots only.
  * bytes — every op's operand and result bytes (an expanded operand at
    its stored size), summed.  Views (``is_view`` ops: ``view``,
    ``expand``, ``transpose``, slices), ``_unsafe_view`` and the
    allocation ops are free, as ``hlo_stats``'s ``_FREE_OPS`` are.  Eager
    PyTorch writes every op's result to device memory and reads it back,
    where XLA fuses elementwise chains, so this is an UPPER BOUND on the
    step's HBM traffic, not what a fused program would move.
  * memory — parameter, gradient and optimizer-state bytes from the
    inputs; the peak of saved-activation bytes alive at once
    (``torch.autograd.graph.saved_tensors_hooks``, parameters excluded);
    and the peak of the storages alive over every op's results
    (``peak_live_bytes``: gradients, activations, temporaries and caches
    the step makes, beside what its inputs hold), against the device's 80
    GB.

On a mesh the step runs on meta DTensors over a process group that moves
nothing (``launch.mesh.fake_mesh``): the counter lets DTensor turn each op
into its local ops and collectives first, so every count is per device
(this rank's shards), each local op counted once; the collectives
(``_c10d_functional``'s all-gather, reduce-scatter, all-reduce and
all-to-all) add their result bytes to ``collective_bytes``, by kind, as the
JAX package's ``collective_bytes_per_device`` sums HLO result bytes, and
nothing to FLOPs or bytes.

On the CPU, these counts are what the step would do on the card: the same
Python runs on either (``launch/dryrun.py``).
"""

from __future__ import annotations

import dataclasses
import math
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.models.layers import local
from repro_torch.roofline.analysis import HBM_BYTES

_aten = torch.ops.aten
META = torch.device("meta")
_FREE = {_aten._unsafe_view, _aten.empty, _aten.empty_like, _aten.empty_strided,
         _aten.lift_fresh, _aten.detach, _aten.alias}
# collectives by their functional op's name (``_coalesced`` forms join theirs)
COLLECTIVES = ("all_gather_into_tensor", "reduce_scatter_tensor", "all_reduce",
               "all_to_all_single")


@dataclasses.dataclass(frozen=True)
class _Meta:
    """A memoized result's metadata (not a tuple: pytrees recurse into those)."""
    shape: tuple
    stride: tuple
    dtype: torch.dtype


def _wrappers() -> tuple:
    """The tensor subclasses a count looks through: DTensor and the
    functional collectives' result (empty without torch.distributed)."""
    if not torch.distributed.is_available():
        return ()
    from torch.distributed._functional_collectives import AsyncCollectiveTensor
    from torch.distributed.tensor import DTensor

    return DTensor, AsyncCollectiveTensor


def tensor_bytes(t: torch.Tensor) -> int:
    """The bytes ``t`` spans in memory: an expanded (stride 0) axis once (a
    DTensor: its shard's)."""
    t = local(t)
    return t.element_size() * math.prod(n for n, st in zip(t.shape, t.stride()) if st)


class _Live:
    """Bytes of the storages registered and still alive, and their peak.
    A storage, not a tensor: an alias (``detach``, a view) keeps its
    storage alive after the tensor that made it is gone."""

    def __init__(self):
        self.now = 0
        self.peak = 0
        self._held = {}

    def add(self, storage) -> None:
        key = id(storage)
        if key in self._held:
            return
        n = storage.nbytes()
        self._held[key] = n
        weakref.finalize(storage, self._drop, key)
        self.now += n
        self.peak = max(self.peak, self.now)

    def _drop(self, key) -> None:
        self.now -= self._held.pop(key, 0)


def _tensors(x):
    """The tensors in an op's (nested) arguments or results."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _spec(x):
    """What a meta kernel reads of an argument: a tensor's metadata, the
    value of anything else."""
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.stride(), x.dtype, x.device.type)
    if isinstance(x, (list, tuple)):
        return tuple(_spec(v) for v in x)
    return x


def _pure(func) -> bool:
    """An op that writes no argument and returns no alias of one."""
    schema = func._schema
    return not schema.is_mutable and all(r.alias_info is None for r in schema.returns)


def _meta_of(t):
    return None if t is None else _Meta(tuple(t.shape), t.stride(), t.dtype)


def _from_meta(m):
    return None if m is None else torch.empty_strided(m.shape, m.stride, dtype=m.dtype,
                                                      device=META)


class _Counter(TorchDispatchMode):
    """Sums every op's FLOPs (``FlopCounterMode``'s formulas, by its
    ``flop_registry``) and operand and result bytes, and tracks the bytes
    alive.

    With ``memo``, a pure op on meta tensors whose operands' metadata it has
    seen before returns fresh meta tensors of the results' recorded shapes,
    strides and dtypes instead of running PyTorch's meta kernel again (most
    of them are Python, about 0.1-0.2 ms per call; a recurrent loop repeats
    the same few ops at every position)."""

    def __init__(self, memo: bool = True):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.collectives = dict.fromkeys(COLLECTIVES, 0)
        self.collective_calls = dict.fromkeys(COLLECTIVES, 0)
        self._through = _wrappers()
        self.live = _Live()
        self.memo = {} if memo else None
        self._kind = {}       # func -> (free, memoizable, flop formula)

    def _classify(self, func):
        kind = self._kind.get(func)
        if kind is None:
            free = func.is_view or func.overloadpacket in _FREE
            # a free op may alias its input without saying so in its schema
            # (``_unsafe_view``): only a computing op is answered from the memo
            kind = (free, self.memo is not None and not free and _pure(func),
                    flop_registry.get(func.overloadpacket))
            self._kind[func] = kind
        return kind

    def _run(self, func, args, kwargs, ins, memoizable):
        # only an op on meta operands is answered from the memo (a factory's
        # device is in its arguments)
        if not memoizable or not ins or any(t.device.type != "meta" for t in ins):
            return func(*args, **kwargs)
        try:
            key = (func, _spec(args), _spec(tuple(sorted(kwargs.items()))))
            hit = self.memo.get(key)
        except TypeError:                  # an argument that does not hash
            return func(*args, **kwargs)
        if hit is not None:
            return _from_meta(hit) if isinstance(hit, _Meta) else tuple(map(_from_meta, hit))
        out = func(*args, **kwargs)
        if isinstance(out, torch.Tensor):
            self.memo[key] = _meta_of(out)
        elif isinstance(out, tuple) and all(isinstance(t, torch.Tensor) or t is None
                                            for t in out):
            self.memo[key] = tuple(map(_meta_of, out))
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, self._through) for t in types):
            return NotImplemented       # DTensor runs first: its local ops come back here
        kwargs = kwargs or {}
        if func.namespace == "_c10d_functional":
            out = func(*args, **kwargs)
            kind = func.overloadpacket.__name__.removesuffix("_coalesced")
            if kind in self.collectives:
                self.collectives[kind] += sum(map(tensor_bytes, _tensors(out)))
                self.collective_calls[kind] += 1
            return out
        free, memoizable, flops = self._classify(func)
        ins = list(_tensors((args, kwargs)))
        out = self._run(func, args, kwargs, ins, memoizable)
        outs = list(_tensors(out))
        if free or all(t.device.type != "meta" for t in ins + outs):
            # host arithmetic (a constant, DTensor's own index sums) is no
            # device work
            return out
        self.ops += 1
        if flops is not None:
            self.flops += flops(*args, **kwargs, out_val=out)
        self.bytes += sum(map(tensor_bytes, ins)) + sum(map(tensor_bytes, outs))
        fresh = {id(t.untyped_storage()) for t in ins}
        for t in outs:                     # results, not inputs written in place
            st = t.untyped_storage()
            if id(st) not in fresh:
                self.live.add(st)
        return out


def _storage(t: torch.Tensor):
    return local(t).untyped_storage()


def _tree_bytes(tree) -> int:
    if isinstance(tree, torch.nn.Module):
        return sum(tensor_bytes(p) for p in tree.parameters())
    if isinstance(tree, torch.Tensor):
        return tensor_bytes(tree)
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(v) for v in tree)
    return 0


def count_step(fn, args, *, params=None, opt_state=None, microbatches: int = 1) -> dict:
    """Run ``fn(*args)`` (meta tensors) once under the counters.  ``params``
    and ``opt_state`` name the inputs that are model state, for the memory
    record: ``total_bytes`` is what the inputs hold (parameters, optimizer
    state, batch or cache) plus the peak of what the step makes
    (``peak_live_bytes``); ``grad_bytes`` (bf16 gradients and, with
    ``microbatches`` > 1, their f32 accumulator) and
    ``saved_activation_bytes`` are parts of that peak."""
    params_ids = ({id(_storage(p)) for p in params.parameters()}
                  if params is not None else set())
    saved = _Live()

    def pack(t):
        st = _storage(t)
        if id(st) not in params_ids:
            saved.add(st)
        return t

    counter = _Counter()
    with counter, torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn(*args)
    param_bytes = _tree_bytes(params)
    opt_bytes = _tree_bytes(opt_state)
    grad_bytes = 0
    if opt_state is not None:
        n_params = sum(local(p).numel() for p in params.parameters())
        grad_bytes = param_bytes + (4 * n_params if microbatches > 1 else 0)
    memory = {
        "param_bytes": param_bytes, "optimizer_bytes": opt_bytes,
        "input_bytes": _tree_bytes(args) - param_bytes - opt_bytes,
        "grad_bytes": grad_bytes,
        "saved_activation_bytes": saved.peak,
        "peak_live_bytes": counter.live.peak,
        "device_bytes": HBM_BYTES,
    }
    memory["total_bytes"] = (param_bytes + opt_bytes + memory["input_bytes"]
                             + counter.live.peak)
    memory["fits"] = memory["total_bytes"] <= HBM_BYTES
    return {"flops": float(counter.flops), "bytes": float(counter.bytes),
            "collective_bytes": float(sum(counter.collectives.values())),
            "collectives": {**counter.collectives, "_counts": counter.collective_calls},
            "ops": counter.ops, "memory": memory}
