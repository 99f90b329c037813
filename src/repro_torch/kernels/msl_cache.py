"""CUDA kernels for the batched multi-step LRU access op, and their plain
PyTorch versions.

Port of ``repro.kernels.msl_cache``.  The kernels live in
``csrc/msl_cache.cu`` (CUDA C++ for sm_90a; the source's head note says
what bounds each one and what its design does about it).  ``build.py``
compiles it with ``nvcc`` at first use and loads it with ctypes.

* ``msl_access_kernel_call`` — one stateless transition per pre-gathered
  row, a group of W lanes per row (W the power of two at or above A), so a
  warp holds 32 / W rows (4 at A = 8) and its instructions are not spent
  on idle lanes; replaces the Pallas ``msl_access_kernel_call``.  Plain
  version: ``msl_access_plain`` (= ``ref.msl_access_ref``).
* ``msl_onepass_kernel_call`` — conflict-aware single pass over queries
  sorted by set id: a warp per chain head walks its whole same-set chain
  with the row in registers, resolving each run of equal queries with one
  transition once the row stops changing; replaces the Pallas
  ``msl_onepass_kernel_call``.
  Plain version: ``chain_resolve_plain``, the rank-by-rank loop of the JAX
  package's ``_chain_body`` over the whole sorted batch.
* ``msl_seq_kernel_call`` — the sequential engine: one warp walks the
  whole query stream in order, each query one transition of its set's row,
  the table updated in place; replaces no Pallas kernel, but the JAX
  package's jitted ``lax.scan`` (``make_sequential_engine``).  Plain
  version: ``msl_seq_plain``, one ``row_apply_ev`` per query.

Each wrapper runs the plain version for tensors on the CPU and the kernel
for tensors on a CUDA device; it never falls back from one to the other.
``LAUNCHES`` counts the kernel launches of each wrapper.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.core.multistep import OP_ACCESS, MSLRUConfig, row_apply_ev
from repro_torch.kernels.build import load_library
from repro_torch.kernels.ref import msl_access_ref

__all__ = [
    "LAUNCHES",
    "MAX_ASSOC",
    "MAX_PLANES",
    "SOURCE",
    "msl_access_kernel_call",
    "msl_onepass_kernel_call",
    "msl_seq_kernel_call",
    "msl_access_plain",
    "chain_resolve_plain",
    "msl_seq_plain",
]

# Kernel launches per wrapper, counted where each launch is made.
LAUNCHES = {"msl_access": 0, "msl_onepass": 0, "msl_seq": 0}

MAX_ASSOC = 32      # a set row is held by at most one warp: a lane per way
MAX_PLANES = 8      # planes per lane the kernels are built for (kMaxPlanes)

SOURCE = Path(__file__).resolve().parent / "csrc" / "msl_cache.cu"

_P = ctypes.c_void_p
_I = ctypes.c_int


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C launchers' signatures on a library built from SOURCE."""
    lib.msl_access_launch.argtypes = [_P] * 11 + [_I] * 9 + [_P]
    lib.msl_access_launch.restype = _I
    lib.msl_onepass_launch.argtypes = [_P] * 13 + [_I] * 9 + [_P]
    lib.msl_onepass_launch.restype = _I
    lib.msl_seq_launch.argtypes = [_P] * 11 + [_I] * 9 + [_P]
    lib.msl_seq_launch.restype = _I
    return lib


@functools.lru_cache(maxsize=None)
def _library():
    return _bind(load_library(SOURCE))


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _check_cuda(cfg: MSLRUConfig, rows, named):
    """Validate the operands a kernel reads; raise on what it cannot take."""
    if rows.device.type != "cuda":
        raise ValueError(f"msl_cache kernels run on CUDA tensors, got {rows.device}")
    b, a, c = rows.shape
    if (a, c) != (cfg.assoc, cfg.planes):
        raise ValueError(f"rows {tuple(rows.shape)} do not match the config "
                         f"(A={cfg.assoc}, C={cfg.planes})")
    if a > MAX_ASSOC:
        raise ValueError(f"A = {a} > {MAX_ASSOC}: the kernels hold one set row "
                         "per warp")
    if c > MAX_PLANES:
        raise ValueError(f"C = {c} > {MAX_PLANES} planes per lane")
    for name, (t, shape) in {"rows": (rows, (b, a, c)), **named}.items():
        if t is None:
            continue
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 tensor")
        if t.device != rows.device or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {shape} on {rows.device}, got "
                             f"{tuple(t.shape)} on {t.device}")


def _outputs(cfg: MSLRUConfig, rows):
    b = rows.shape[0]
    new = functools.partial(torch.empty, dtype=torch.int32, device=rows.device)
    return (new(rows.shape), new((b,)), new((b,)),
            new((b, max(cfg.value_planes, 1))), new((b, cfg.planes)))


def _geometry(cfg: MSLRUConfig):
    return (cfg.assoc, cfg.planes, cfg.key_planes, cfg.value_planes, cfg.m,
            cfg.p, cfg.cost_planes, int(cfg.policy == "set_lru"))


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _query_shapes(cfg, b, qkeys, qvals, ops, chain_live, costs):
    return {"qkeys": (qkeys, (b, cfg.key_planes)),
            "qvals": (qvals, (b, cfg.value_planes)),
            "ops": (ops, (b,)), "chain_live": (chain_live, (b,)),
            "costs": (costs, (b,))}


# ---------------------------------------------------------------------------
# msl_access: one transition per pre-gathered row
# ---------------------------------------------------------------------------

def msl_access_plain(rows, qkeys, qvals, ops=None, chain_live=None, costs=None,
                     *, cfg: MSLRUConfig):
    """Plain PyTorch version of ``msl_access_kernel_call`` (any device)."""
    return msl_access_ref(rows, qkeys, qvals, cfg, ops, chain_live, costs)


def msl_access_kernel_call(rows, qkeys, qvals, ops=None, chain_live=None,
                           costs=None, *, cfg: MSLRUConfig):
    """Fused multi-step LRU op over pre-gathered rows.

    The kernel gives each row a group of W lanes, W the power of two at or
    above A, so one warp takes 32 / W rows; it launches ceil(B / (32 / W))
    warps, sized from the shapes alone.

    rows (B, A, C) int32; qkeys (B, KP); qvals (B, V); ops (B,) optional
    opcodes (None = all OP_ACCESS); chain_live (B,) optional int32 execute
    mask for chain rows (requires ops); costs (B,) optional int32 insert
    costs.  Returns (new_rows, hit (B,) int32, pos (B,), value (B, V),
    ev (B, C)), bit-equal to ``msl_access_plain``.  CPU tensors run the
    plain version; CUDA tensors launch the kernel.
    """
    if chain_live is not None and ops is None:
        raise ValueError("chain_live requires ops")
    if rows.device.type == "cpu":
        return msl_access_plain(rows, qkeys, qvals, ops, chain_live, costs, cfg=cfg)
    b = rows.shape[0]
    _check_cuda(cfg, rows, _query_shapes(cfg, b, qkeys, qvals, ops, chain_live, costs))
    out = _outputs(cfg, rows)
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream().cuda_stream
        LAUNCHES["msl_access"] += 1
        err = _library().msl_access_launch(
            *map(_ptr, (rows, qkeys, qvals, ops, chain_live, costs, *out)),
            b, *_geometry(cfg), stream)
    _raise_on(err, "msl_access")
    new_rows, hit, pos, val, ev = out
    return new_rows, hit, pos, val[:, :cfg.value_planes], ev


# ---------------------------------------------------------------------------
# msl_onepass: same-set chains over queries sorted by set id
# ---------------------------------------------------------------------------

def chain_resolve_plain(rows, qkeys, qvals, ops, sids, lrank, served,
                        chain_live=None, costs=None, *, cfg: MSLRUConfig):
    """Plain PyTorch version of ``msl_onepass_kernel_call`` (same arguments).

    The JAX package's ``_chain_body`` loop over the whole sorted batch: at
    step r every query of chain rank r applies its transition (identity when
    not served) to the row handed on by rank r-1 and commits it.  The ranks
    carry the chain structure, so ``sids`` is not read.  Returns
    (rows_after, hit int32, pos, value (B, V), ev (B, C)); an unserved
    query reports hit 0, pos -1, value 0, ev 0.
    """
    b = rows.shape[0]
    served = served.to(torch.bool)
    cur = after = rows
    hit = torch.zeros((b,), dtype=torch.int32, device=rows.device)
    pos = torch.full((b,), -1, dtype=torch.int32, device=rows.device)
    val = torch.zeros((b, cfg.value_planes), dtype=torch.int32, device=rows.device)
    ev = torch.zeros((b, cfg.planes), dtype=torch.int32, device=rows.device)
    # a chain with no served query hands its head's row on untouched: only
    # the chains with one take rounds (the invalid rows of a routed batch,
    # one long chain on the dummy row, take none)
    n_rounds = 0
    if b:
        head = torch.arange(b, device=rows.device) - lrank.to(torch.int64)
        chain = torch.cumsum((lrank == 0).to(torch.int64), 0) - 1
        busy = torch.zeros((int(chain[-1]) + 1,), dtype=torch.int64, device=rows.device)
        busy = busy.index_add_(0, chain, served.to(torch.int64))[chain] > 0
        after = torch.where(busy[:, None, None], rows, rows[head])
        n_rounds = int(lrank[busy].max()) + 1 if bool(busy.any()) else 0
    for r in range(n_rounds):
        new_rows, h, p, v, e = msl_access_plain(cur, qkeys, qvals, ops,
                                                chain_live, costs, cfg=cfg)
        active = lrank == r
        act = active & served
        after = torch.where(active[:, None, None],
                            torch.where(act[:, None, None], new_rows, cur), after)
        hit = torch.where(act, h, hit)
        pos = torch.where(act, p, pos)
        val = torch.where(act[:, None], v, val)
        ev = torch.where(act[:, None], e, ev)
        cur = torch.where((lrank == r + 1)[:, None, None],
                          torch.roll(after, 1, dims=0), cur)
    return after, hit, pos, val, ev


def msl_onepass_kernel_call(rows, qkeys, qvals, ops, sids, lrank, served,
                            chain_live=None, costs=None, *, cfg: MSLRUConfig):
    """Conflict-aware single pass over queries sorted by set id.

    rows (B, A, C) int32 gathered set rows (only each chain head's row is
    read); qkeys (B, KP); qvals (B, V); ops (B,) opcodes or None (all
    OP_ACCESS); sids (B,) sorted set ids; lrank (B,) rank of each query in
    its run of equal set ids; served (B,) int32 (0 = the query passes the
    row on untouched); chain_live, costs (B,) optional, sorted with the
    queries.  Returns (rows_after, hit, pos, value (B, V), ev (B, C)) where
    rows_after[i] is the set's row after query i.  The kernel finds chain
    heads from ``sids`` and the plain version ranks from ``lrank``; the two
    agree when ``lrank`` ranks runs of equal ``sids``.
    """
    if chain_live is not None and ops is None:
        raise ValueError("chain_live requires ops")
    if rows.device.type == "cpu":
        return chain_resolve_plain(rows, qkeys, qvals, ops, sids, lrank, served,
                                   chain_live, costs, cfg=cfg)
    b = rows.shape[0]
    _check_cuda(cfg, rows, {
        **_query_shapes(cfg, b, qkeys, qvals, ops, chain_live, costs),
        "sids": (sids, (b,)), "served": (served, (b,))})
    out = _outputs(cfg, rows)
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream().cuda_stream
        LAUNCHES["msl_onepass"] += 1
        err = _library().msl_onepass_launch(
            *map(_ptr, (rows, qkeys, qvals, ops, chain_live, costs, sids, served,
                        *out)),
            b, *_geometry(cfg), stream)
    _raise_on(err, "msl_onepass")
    new_rows, hit, pos, val, ev = out
    return new_rows, hit, pos, val[:, :cfg.value_planes], ev


# ---------------------------------------------------------------------------
# msl_seq: the whole stream in order, one query at a time
# ---------------------------------------------------------------------------

def msl_seq_plain(table, sids, qkeys, qvals, ops=None, chain_live=None, costs=None,
                  *, cfg: MSLRUConfig):
    """Plain PyTorch version of ``msl_seq_kernel_call`` (same arguments and
    outputs): one ``row_apply_ev`` per query on its set's row, ``table``
    updated in place."""
    n, dev = qkeys.shape[0], table.device
    if ops is None:
        ops = torch.full((n,), OP_ACCESS, dtype=torch.int32, device=dev)
    new = functools.partial(torch.empty, dtype=torch.int32, device=dev)
    hit, pos, val, ev = new((n,)), new((n,)), new((n, cfg.value_planes)), new((n, cfg.planes))

    def at(x, q):
        return None if x is None else x[q]

    for i, s in enumerate(sids.tolist()):
        q = slice(i, i + 1)
        new_rows, res, ev[q] = row_apply_ev(cfg, table[s:s + 1], qkeys[q], qvals[q], ops[q],
                                            chain_live=at(chain_live, q), costs=at(costs, q))
        table[s:s + 1] = new_rows
        hit[q], pos[q], val[q] = res.hit, res.pos, res.value
    return table, hit, pos, val, ev


def msl_seq_kernel_call(table, sids, qkeys, qvals, ops=None, chain_live=None,
                        costs=None, *, cfg: MSLRUConfig):
    """The sequential engine over a whole query stream, in one launch.

    table (S, A, C) int32, updated in place; sids (N,) each query's set
    (``set_index_for``); qkeys (N, KP); qvals (N, V); ops (N,) opcodes or
    None (all OP_ACCESS); chain_live (N,) optional int32 execute mask for
    chain rows; costs (N,) optional insert costs.  Query i applies one
    transition to row sids[i] as queries 0..i-1 left it.  Returns (table,
    hit (N,) int32, pos (N,) int32, value (N, V) int32, evicted (N, C)
    int32) as ``msl_access_kernel_call`` does, bit-equal to
    ``msl_seq_plain``.  CPU tensors run the plain version; CUDA tensors
    launch the kernel: one warp walks the stream.
    """
    if chain_live is not None and ops is None:
        raise ValueError("chain_live requires ops")
    if table.device.type == "cpu":
        return msl_seq_plain(table, sids, qkeys, qvals, ops, chain_live, costs, cfg=cfg)
    n = qkeys.shape[0]
    _check_cuda(cfg, table, {**_query_shapes(cfg, n, qkeys, qvals, ops, chain_live, costs),
                             "sids": (sids, (n,))})
    new = functools.partial(torch.empty, dtype=torch.int32, device=table.device)
    hit, pos = new((n,)), new((n,))
    val, ev = new((n, max(cfg.value_planes, 1))), new((n, cfg.planes))
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        LAUNCHES["msl_seq"] += 1
        err = _library().msl_seq_launch(
            *map(_ptr, (table, sids, qkeys, qvals, ops, chain_live, costs,
                        hit, pos, val, ev)),
            n, *_geometry(cfg), stream)
    _raise_on(err, "msl_seq")
    return table, hit, pos, val[:, :cfg.value_planes], ev
