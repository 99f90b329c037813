"""Meshes: the production meshes, the sharded cache's, and their processes.

Port of ``repro.launch.mesh``.  Importing this module touches no device and
starts no process group.

Production meshes (the JAX package's TPU pods of 256 chips):
  single-pod:  (data=16, model=16)
  multi-pod:   (pod=2, data=16, model=16), 512 chips.
A batch shards over ('pod', 'data'), tensor parallelism over 'model', FSDP
parameter sharding over 'data'.  ``make_production_mesh`` and
``make_debug_mesh`` give a ``torch.distributed`` ``DeviceMesh`` of that
shape when a process group of that size exists, and otherwise a
``MeshShape``: the record of the axes that the sharding rules
(``launch/sharding.py``) read, which allocates nothing.  ``fake_mesh``
gives a ``DeviceMesh`` of any shape in this one process, over a process
group whose collectives do nothing: the dry run traces a sharded step on it
on meta tensors.

The sharded cache uses a flat ``"cache"`` axis.  ``CacheMesh`` holds its D
shards as D logical shards in one process on one device (the counterpart of
the JAX package's fake-device mesh); ``ProcessCacheMesh`` holds one shard per
rank of a process group.  Both exchange send buffers with ``all_to_all``:
the transpose of the stacked buffers in one process, ``all_to_all_single``
across processes.  ``ProcessCacheMesh(n)`` is the cache over the first
``n`` ranks of the default group (a subgroup made once per size): a rank
past ``n`` holds no shard, takes part in no exchange, and receives what
the group gathers from its rank 0, so that every rank of the world keeps
the same host state.  A resized cache is another such mesh.  The backend
of a process group is the caller's choice: ``nccl`` passes device tensors
and needs one card per rank (NCCL does not put two ranks on one card);
``gloo`` stages every exchange through host buffers
(pinned when CUDA is present), which lets D ranks share one card, and times
that staging apart from the exchange.  ``run_on_ranks`` spawns the ranks.

DTensor's collectives (the functional ``_c10d_functional`` ops) on CUDA
tensors over a gloo group crash the process at their wait in PyTorch 2.11
(a segmentation fault), where the same collectives called directly work.
``HostStagedCollectives`` runs them through host memory instead, for the
block it covers, and counts what it moves: gloo ranks sharing one card run
the sharded step inside it.
"""

from __future__ import annotations

import contextlib
import datetime
import gc
import math
import os
import queue
import socket
import time
import traceback
from collections.abc import Mapping

import torch

__all__ = ["AXIS_DATA", "AXIS_MODEL", "AXIS_POD", "CacheMesh", "HostStagedCollectives",
           "MeshShape", "ProcessCacheMesh", "all_reduce", "axis_names", "axis_sizes", "batch_axes",
           "fake_mesh", "make_cache_mesh", "make_debug_mesh", "make_production_mesh",
           "run_on_ranks"]

AXIS_POD = "pod"
AXIS_DATA = "data"
AXIS_MODEL = "model"


class MeshShape:
    """A mesh as the record of its axes: ``shape`` maps each axis name to
    its size, as a JAX mesh's ``shape`` does.  It allocates nothing."""

    def __init__(self, shape, axes):
        if len(shape) != len(axes):
            raise ValueError(f"mesh shape {tuple(shape)} for axes {tuple(axes)}")
        self.shape = dict(zip(axes, (int(n) for n in shape)))
        self.axis_names = tuple(axes)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self) -> str:
        return f"MeshShape({self.shape})"


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a mesh whose ``shape`` is a mapping (a
    ``MeshShape``, a JAX mesh, a test's stand-in) or of a ``DeviceMesh``."""
    if isinstance(mesh.shape, Mapping):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_names(mesh) -> tuple:
    """The mesh's axis names in mesh order."""
    names = getattr(mesh, "mesh_dim_names", None) or getattr(mesh, "axis_names", None)
    return tuple(names) if names else tuple(axis_sizes(mesh))


def _mesh(shape, axes, device_type):
    """A ``DeviceMesh`` of ``shape`` when the default process group has
    exactly that many ranks, else a ``MeshShape``."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() == math.prod(shape):
        from torch.distributed.device_mesh import init_device_mesh

        return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))
    return MeshShape(shape, axes)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = (AXIS_POD, AXIS_DATA, AXIS_MODEL) if multi_pod else (AXIS_DATA, AXIS_MODEL)
    return _mesh(shape, axes, device_type)


def make_debug_mesh(shape=(1, 1), axes=(AXIS_DATA, AXIS_MODEL), device_type: str = "cuda"):
    """A small mesh for tests: a ``DeviceMesh`` inside a process group of
    its size, a ``MeshShape`` outside one."""
    return _mesh(tuple(shape), tuple(axes), device_type)


@contextlib.contextmanager
def fake_mesh(mesh):
    """A ``DeviceMesh`` with ``mesh``'s axes (a ``MeshShape``) over a process
    group of that many ranks in this process, of which this process is rank
    0, with PyTorch's ``fake`` backend: every collective returns at once and
    moves nothing.  A step traced on meta DTensors over it issues the
    collectives it would issue on the mesh.  The group is destroyed on exit;
    no other default group may exist."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_mesh: a default process group exists already")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=mesh.size)
    try:
        yield init_device_mesh("cpu", tuple(mesh.shape.values()),
                               mesh_dim_names=tuple(mesh.shape))
    finally:
        dist.destroy_process_group()


def batch_axes(mesh) -> tuple:
    """Mesh axes the global batch shards over."""
    sizes = axis_sizes(mesh)
    return tuple(a for a in (AXIS_POD, AXIS_DATA) if a in sizes)


# ---------------------------------------------------------------------------
# The sharded cache's "cache" axis
# ---------------------------------------------------------------------------

class CacheMesh:
    """D logical shards of the ``"cache"`` axis on ``device``, in one
    process.

    ``shape["cache"]`` is D, as on a JAX mesh; ``rank`` is None: this
    process holds every shard.  ``all_to_all`` exchanges the per-peer send
    buffers of all D shards at once."""

    rank = None

    def __init__(self, ndev: int, device):
        if ndev < 1:
            raise ValueError(f"a cache mesh needs at least one shard, got {ndev}")
        self.shape = {"cache": int(ndev)}
        self.device = torch.device(device)

    @property
    def ndev(self) -> int:
        return self.shape["cache"]

    def all_to_all(self, send: torch.Tensor) -> torch.Tensor:
        """``send`` (D_src, D_dst, k, planes) int32: shard ``s`` sends
        ``send[s, d]`` to shard ``d``.  Returns the (D_dst, D_src, k,
        planes) stack each shard receives: ``recv[d, s] = send[s, d]``, the
        ``all_to_all(split_axis=0, concat_axis=0, tiled=True)`` of every
        shard at once."""
        d = self.ndev
        if send.shape[0] != d or send.shape[1] != d:
            raise ValueError(f"send buffers {tuple(send.shape)} on a mesh of {d} shards")
        return send.transpose(0, 1).contiguous()

    def __repr__(self) -> str:
        return f"CacheMesh(cache={self.ndev}, device={self.device})"


def make_cache_mesh(n_devices: int | None = None, device="cuda") -> CacheMesh:
    """A mesh of ``n_devices`` logical cache shards on ``device`` (the card
    unless the caller asks for the CPU).  ``None`` gives one shard per
    visible card (one on the CPU), as the JAX mesh takes every device."""
    from repro_torch.core import resolve_device

    device = resolve_device(device)
    if n_devices is None:
        n_devices = torch.cuda.device_count() if device.type == "cuda" else 1
    return CacheMesh(n_devices, device)


class _HostStage:
    """Host buffers for a gloo collective of device tensors, one per
    (role, shape, dtype), pinned when CUDA is present; the copies in and out
    are timed into ``seconds``, the collectives into ``wire_seconds``, and
    ``exchanges`` counts the ``all_to_all`` calls.  A resized cache mesh
    keeps its predecessor's stage, so the counts run on across a reshard."""

    def __init__(self):
        self._buffers: dict = {}
        self.seconds = 0.0
        self.wire_seconds = 0.0
        self.exchanges = 0

    def buffer(self, role, shape, dtype) -> torch.Tensor:
        key = (role, tuple(shape), dtype)
        buf = self._buffers.get(key)
        if buf is None:
            buf = torch.empty(shape, dtype=dtype, pin_memory=torch.cuda.is_available())
            self._buffers[key] = buf
        return buf

    def copy(self, dst: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
        """A blocking copy (a pinned buffer is reused only after it)."""
        t = time.perf_counter()
        dst.copy_(src)
        self.seconds += time.perf_counter() - t
        return dst


def all_reduce(t: torch.Tensor, op, group=None) -> torch.Tensor:
    """``dist.all_reduce`` of ``t`` in place over ``group``: device tensors
    directly under NCCL, through a host copy under gloo.  Returns ``t``."""
    import torch.distributed as dist

    if dist.get_backend(group) == "nccl" or t.device.type == "cpu":
        dist.all_reduce(t, op=op, group=group)
        return t
    host = t.cpu()
    dist.all_reduce(host, op=op, group=group)
    return t.copy_(host)


class ProcessCacheMesh:
    """The ``"cache"`` axis over a process group: group rank ``r`` holds
    shard ``r``, its ``s_local`` table rows and its slab of each batch.

    ``shape["cache"]`` is the group's size and ``all_to_all`` the exchange
    of this rank's send stack, as on ``CacheMesh``.  Under gloo the
    exchange goes through host buffers (``stage_seconds`` accumulates the
    copies to and from them, ``wire_seconds`` the collective itself,
    ``exchanges`` counts the calls).

    ``ProcessCacheMesh(n)`` is the cache over the first ``n`` ranks of the
    default group (all of them when ``n`` is None).  Every rank of the
    world makes it, with the same ``n``: the subgroup of the first ``n``
    ranks is made once per size (``dist.new_group`` is collective over the
    world).  ``rank`` is -1 on the ranks past ``n``: they hold no rows and
    make no exchange, and ``all_gather`` hands them what the group gathered
    (``outside`` lists them).  Every rank of the world then calls
    ``all_gather``, ``broadcast`` and ``share_object`` in the same order.
    Raises ``ValueError`` past the world's size: a running cache cannot
    spawn processes."""

    def __init__(self, n: int | None = None, device="cuda", *,
                 stage: _HostStage | None = None):
        import torch.distributed as dist

        from repro_torch.core import resolve_device

        self.world_size = dist.get_world_size()
        n = self.world_size if n is None else int(n)
        if not 1 <= n <= self.world_size:
            raise ValueError(f"a cache of {n} shards on a world of {self.world_size} ranks")
        self.group = _first_ranks(n)
        self.rank = dist.get_rank(self.group)
        self.shape = {"cache": n}
        # a subgroup inherits the default group's backend
        self.backend = dist.get_backend(self.group if self.rank >= 0 else None)
        self.device = resolve_device(device)
        if self.backend == "nccl" and self.device.type != "cuda":
            raise ValueError("an nccl group exchanges device tensors: pass a CUDA device")
        # the world ranks past the first n
        self.outside = range(n, self.world_size)
        self._stage = stage if stage is not None else _HostStage()

    @property
    def ndev(self) -> int:
        return self.shape["cache"]

    @property
    def stage_seconds(self) -> float:
        return self._stage.seconds

    @property
    def wire_seconds(self) -> float:
        return self._stage.wire_seconds

    @property
    def exchanges(self) -> int:
        return self._stage.exchanges

    def resized(self, n: int) -> "ProcessCacheMesh":
        """The cache over the first ``n`` ranks of the world on this mesh's
        device, its transport counts carried on."""
        return ProcessCacheMesh(n, self.device, stage=self._stage)

    def all_to_all(self, send: torch.Tensor) -> torch.Tensor:
        """``send`` (D, k, planes): ``send[d]`` goes to rank ``d``.  Returns
        the (D, k, planes) stack this rank receives, ``recv[s]`` what rank
        ``s`` sent it: ``all_to_all(split_axis=0, concat_axis=0,
        tiled=True)``."""
        import torch.distributed as dist

        if send.shape[0] != self.ndev:
            raise ValueError(f"send buffers {tuple(send.shape)} on a mesh of "
                             f"{self.ndev} ranks")
        send = send.contiguous()
        st = self._stage
        st.exchanges += 1
        if self.backend == "nccl":
            recv = torch.empty_like(send)
            t = time.perf_counter()
            dist.all_to_all_single(recv, send, group=self.group)
            st.wire_seconds += time.perf_counter() - t
            return recv
        h_send = st.copy(st.buffer("send", send.shape, send.dtype), send)
        h_recv = st.buffer("recv", send.shape, send.dtype)
        t = time.perf_counter()
        dist.all_to_all_single(h_recv, h_send, group=self.group)
        st.wire_seconds += time.perf_counter() - t
        return st.copy(torch.empty_like(send), h_recv)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every shard's ``x`` (the same shape on each), concatenated along
        dim 0 in rank order, on this rank's device.  A rank outside the
        group passes a tensor of that shape and receives the result from
        group rank 0."""
        import torch.distributed as dist

        x = x.contiguous()
        if self.rank < 0:
            out = x.new_empty((self.ndev * x.shape[0], *x.shape[1:]))
        elif self.backend == "nccl":
            parts = [torch.empty_like(x) for _ in range(self.ndev)]
            dist.all_gather(parts, x, group=self.group)
            out = torch.cat(parts)
        else:
            parts = [torch.empty_like(x, device="cpu") for _ in range(self.ndev)]
            dist.all_gather(parts, x.cpu(), group=self.group)
            out = torch.cat(parts).to(x.device)
        return self.broadcast(out, 0) if self.outside else out

    def broadcast(self, x: torch.Tensor, shard: int) -> torch.Tensor:
        """``x`` of shard ``shard`` (world rank ``shard``) on every rank of
        the world; the others pass a tensor of its shape.  Device tensors
        under NCCL, host tensors under gloo; returned on ``x``'s device."""
        import torch.distributed as dist

        buf = x.to(self.device if self.backend == "nccl" else "cpu", copy=True)
        dist.broadcast(buf, shard)
        return buf.to(x.device)

    def share_object(self, obj=None):
        """``obj`` of world rank 0 (pickled), returned on every rank of the
        world: how a driving rank hands its calls to the others."""
        import torch.distributed as dist

        box = [obj]
        dist.broadcast_object_list(box, 0)
        return box[0]

    def __repr__(self) -> str:
        return (f"ProcessCacheMesh(cache={self.ndev}, rank={self.rank}, "
                f"backend={self.backend}, device={self.device})")


# the default group's subgroups of its first n ranks, made once per size:
# ``dist.new_group`` is collective over the world, so every rank makes the
# same ones in the same order
_FIRST_RANKS: dict = {"world": None, "groups": {}}


def _first_ranks(n: int):
    """The group of the default group's first ``n`` ranks (the default
    group itself when ``n`` is its size)."""
    import torch.distributed as dist

    if _FIRST_RANKS["world"] is not dist.group.WORLD:
        _FIRST_RANKS["world"], _FIRST_RANKS["groups"] = dist.group.WORLD, {}
    groups = _FIRST_RANKS["groups"]
    if n not in groups:
        groups[n] = (dist.group.WORLD if n == dist.get_world_size()
                     else dist.new_group(ranks=list(range(n))))
    return groups[n]


class HostStagedCollectives:
    """DTensor's functional collectives on ``dispatch_key`` tensors (CUDA
    by default) through host memory, inside the ``with`` block: each of
    ``all_reduce``, ``all_gather_into_tensor``, ``reduce_scatter_tensor``,
    ``all_to_all_single`` and ``broadcast`` copies its input to the host,
    runs the blocking collective of its process group there (gloo), and
    copies the result back, so that its wait has nothing left to do.
    ``calls``, ``bytes`` (each collective's result, by kind) and
    ``seconds`` (the whole of each call) count what went through it.  An
    ``avg`` reduction is a sum divided by the group's size."""

    KINDS = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
             "all_to_all_single", "broadcast")

    def __init__(self, dispatch_key: str = "CUDA"):
        self.key = dispatch_key
        self.calls = dict.fromkeys(self.KINDS, 0)
        self.bytes = dict.fromkeys(self.KINDS, 0)
        self.seconds = 0.0
        self._lib = None

    def __enter__(self):
        self._lib = torch.library.Library("_c10d_functional", "IMPL")
        for kind in self.KINDS:
            self._lib.impl(kind, self._staged(kind), self.key)
        return self

    def __exit__(self, *exc):
        self._lib._destroy()
        self._lib = None

    def _staged(self, kind):
        import torch.distributed as dist
        from torch.distributed.distributed_c10d import _resolve_process_group

        ops = {"sum": dist.ReduceOp.SUM, "avg": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
               "min": dist.ReduceOp.MIN, "product": dist.ReduceOp.PRODUCT}

        def reduced(h, reduce_op, pg):
            return h.div_(pg.size()) if reduce_op == "avg" else h

        def run(x, *args):
            t = time.perf_counter()
            pg = _resolve_process_group(args[-1])
            h = x.detach().to("cpu", copy=True, memory_format=torch.contiguous_format)
            if kind == "all_reduce":
                dist.all_reduce(h, ops[args[0]], group=pg)
                out = reduced(h, args[0], pg)
            elif kind == "all_gather_into_tensor":
                out = h.new_empty((args[0] * h.shape[0], *h.shape[1:]))
                dist.all_gather_into_tensor(out, h, group=pg)
            elif kind == "reduce_scatter_tensor":
                out = h.new_empty((h.shape[0] // args[1], *h.shape[1:]))
                dist.reduce_scatter_tensor(out, h, ops[args[0]], group=pg)
                out = reduced(out, args[0], pg)
            elif kind == "all_to_all_single":
                outs, ins = (list(args[0]) or None), (list(args[1]) or None)
                out = h.new_empty((sum(outs) if outs else h.shape[0], *h.shape[1:]))
                dist.all_to_all_single(out, h, outs, ins, group=pg)
            else:
                dist.broadcast(h, args[0], group=pg)
                out = h
            out = out.to(x.device)
            self.calls[kind] += 1
            self.bytes[kind] += out.numel() * out.element_size()
            self.seconds += time.perf_counter() - t
            return out

        return run


# ---------------------------------------------------------------------------
# Spawning the ranks
# ---------------------------------------------------------------------------

RANK_TIMEOUT_S = 600


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _release_groups():
    """Drop this module's references to process groups and collect the
    cycles that hold others (the meshes and clients a rank function made),
    so that each group's native threads (gloo's pair loop and workers) end
    now and not at interpreter exit."""
    _FIRST_RANKS.update(world=None, groups={})
    gc.collect()


def _rank_main(fn, rank, world, backend, device, port, args, results):
    import torch.distributed as dist

    done = False
    try:
        # ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        if torch.device(device).type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        timeout = datetime.timedelta(seconds=RANK_TIMEOUT_S)
        store = dist.TCPStore("127.0.0.1", port, is_master=False, timeout=timeout)
        dist.init_process_group(backend, store=store, world_size=world, rank=rank,
                                timeout=timeout)
        del store
        results.put((rank, True, fn(*args)))
        done = True
    except Exception:
        # report to the parent, then fail this process as well
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        # an ordered teardown: every rank past its last collective before
        # any rank takes its group down (after a failure the parent kills
        # the ranks instead), the groups and their threads gone before the
        # interpreter exits, the result flushed to the parent
        if dist.is_initialized():
            if done:
                dist.barrier()
            dist.destroy_process_group()
        _release_groups()
        results.close()
        results.join_thread()


def run_on_ranks(fn, world: int, backend: str = "gloo", device="cuda", args: tuple = (),
                 timeout: float = RANK_TIMEOUT_S) -> list:
    """Run ``fn(*args)`` on ``world`` spawned processes, each rank ``r`` of
    one default process group (``backend``; its rendezvous store is served
    by this process, on a localhost port the system picks, so that
    concurrent calls cannot meet on one port) with its card set (rank ``r``
    on card ``r mod count``) when ``device`` is CUDA.  ``fn`` and ``args``
    are pickled: a module-level function and plain or numpy values.
    Returns every rank's result (also pickled), in rank order.

    Each rank takes an equal share of the host's cores for its torch
    threads.  Raises if any rank raised (with its traceback), exited
    without a result, or ran past ``timeout`` seconds; the other ranks are
    killed then, since they may wait on the failed one in a collective."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend {backend!r}: gloo or nccl")
    if backend == "nccl" and world > torch.cuda.device_count():
        raise ValueError(f"nccl needs one card per rank: {world} ranks, "
                         f"{torch.cuda.device_count()} cards")
    import torch.distributed as dist

    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    store = dist.TCPStore("127.0.0.1", 0, is_master=True, wait_for_workers=False,
                          timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world, backend, str(device), store.port, args, results))
             for r in range(world)]
    for p in procs:
        p.start()
    done, errors = {}, {}
    deadline = time.monotonic() + timeout
    try:
        while len(done) < world and not errors:
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue.Empty:
                for r, p in enumerate(procs):
                    if r not in done and p.exitcode not in (None, 0):
                        errors[r] = f"rank {r} exited with code {p.exitcode}"
                if time.monotonic() > deadline:
                    errors[-1] = f"ranks still running after {timeout} s"
                continue
            (done if ok else errors)[rank] = payload
    finally:
        for p in procs:
            p.join(timeout=5 if errors else 60)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        del store
    for r, p in enumerate(procs):
        if not errors and p.exitcode != 0:
            errors[r] = f"rank {r} exited with code {p.exitcode} after its result"
    if errors:
        raise RuntimeError("run_on_ranks: " + "\n".join(
            f"[rank {r}] {msg}" for r, msg in sorted(errors.items())))
    return [done[r] for r in range(world)]
