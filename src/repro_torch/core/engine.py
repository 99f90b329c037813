"""Query-stream engines for the multi-step LRU cache, in PyTorch.

Port of ``repro.core.engine``.  Two execution models, both built on the row
ops in multistep.py and bit-exact with each other and with the JAX package:

* ``sequential`` — one query at a time, in order: the oracle.  One CUDA
  kernel launch walks the whole stream for a table on the card, a plain
  loop for a table on the CPU.
* ``batched`` — B queries per call.  Queries to different sets commute;
  queries that collide on a set are serialized in batch order by one of
  two conflict schemes:

  - ``engine="rounds"`` — round r applies the r-th query of every set
    (one gather → access kernel → scatter per round); the oracle of
  - ``engine="onepass"`` — kernels/ops.py: sort by set id once, gather
    each distinct set's row once, resolve every same-set chain in one
    kernel launch, scatter once.

  Both run their CUDA kernel for a table on the card and the kernel's
  plain version for a table on the CPU.

The opcode table, the chain-segment contract (CHAIN_GET/CHAIN_PUT with
``chain_ids``), the cost-plane victim rule and the ``served`` / ``max_rounds``
reporting are those of the JAX package's engine module, unchanged: every
engine here returns the same (table, AccessResult) bit for bit.

A scatter whose indices repeat writes an unspecified winner on CUDA.  The
batched engines therefore send every write they discard to one dummy row
appended to the table (index S) and never read it back.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.invector import EMPTY_KEY
from repro_torch.core.multistep import (  # noqa: F401  (OP_* re-exported)
    AccessResult,
    MSLRUConfig,
    OP_ACCESS,
    OP_CHAIN_GET,
    OP_CHAIN_PUT,
    OP_DELETE,
    OP_GET,
    OP_LOOKUP,
    row_lookup,
    set_index_for,
)

__all__ = [
    "OP_ACCESS",
    "OP_GET",
    "OP_DELETE",
    "OP_LOOKUP",
    "OP_CHAIN_GET",
    "OP_CHAIN_PUT",
    "SeqOutputs",
    "make_sequential_engine",
    "make_batched_engine",
    "make_chunked_stream_runner",
    "make_conflict_update",
    "chain_exec_from_hits",
    "chain_live_mask",
    "group_offsets",
    "sorted_group_ranks",
    "batched_rounds_update",
    "batched_rounds_update_",
    "engine_from_update",
    "pad_dummy_row",
    "as_i32",
]


class SeqOutputs(NamedTuple):
    hit: torch.Tensor            # (N,) bool
    pos: torch.Tensor            # (N,) int32 flat lane of hit (-1 miss)
    value: torch.Tensor          # (N, V) value of the hit item (garbage on miss)
    evicted_key: torch.Tensor    # (N, KP)
    evicted_val: torch.Tensor    # (N, V)
    evicted_valid: torch.Tensor  # (N,) bool


def as_i32(x, device) -> torch.Tensor | None:
    """An optional per-query operand as an int32 tensor on ``device``."""
    if x is None:
        return None
    return torch.as_tensor(x, device=device).to(torch.int32)


def make_sequential_engine(cfg: MSLRUConfig, with_ops: bool = False):
    """Returns run(table, qkeys (N,KP), qvals (N,V) [, opcodes (N,),
    chain_ids=None, costs=None]) -> (table, SeqOutputs).

    One query at a time, each touching exactly one set row: the rendering
    of the paper's single-threaded loop and the oracle of every batched
    engine.  ``with_ops=True`` adds the opcode argument; the chain execute
    mask of ``chain_ids`` is computed against the start table, matching the
    batch-start probe of the batched engines.  The set ids are hashed once
    for the whole stream; then ``kernels.msl_cache.msl_seq_kernel_call``
    runs it on a clone of the table: one CUDA kernel launch for a table on
    the card (the counterpart of the JAX package's jitted ``lax.scan``),
    the plain loop of ``row_apply_ev`` for a table on the CPU.
    """

    kp, v = cfg.key_planes, cfg.value_planes

    def run(table, qkeys, qvals, opcodes=None, chain_ids=None, costs=None):
        from repro_torch.kernels.msl_cache import msl_seq_kernel_call  # kernels -> core

        dev = table.device
        qkeys, qvals = as_i32(qkeys, dev).contiguous(), as_i32(qvals, dev).contiguous()
        # an operand the stream does not carry stays None (all OP_ACCESS,
        # every chain row live, cost 0): the kernel then never reads it
        opcodes = as_i32(opcodes, dev) if with_ops else None
        live = None
        if opcodes is not None and chain_ids is not None:
            live = chain_live_mask(cfg, table, qkeys, opcodes, as_i32(chain_ids, dev))
        opcodes, live, costs = (None if x is None else as_i32(x, dev).contiguous()
                                for x in (opcodes, live, costs))
        table, hit, pos, val, ev = msl_seq_kernel_call(
            table.clone(), set_index_for(cfg, qkeys), qkeys, qvals, opcodes, live, costs,
            cfg=cfg)
        return table, SeqOutputs(hit=hit != 0, pos=pos, value=val,
                                 evicted_key=ev[:, :kp], evicted_val=ev[:, kp:kp + v],
                                 evicted_valid=ev[:, 0] != EMPTY_KEY)

    return run


def sorted_group_ranks(sorted_ids: torch.Tensor):
    """(firsts, offset) for an already-sorted id array.

    firsts[i] marks group heads; offset[i] (int32) is the rank within the
    group.  Shared by ``group_offsets`` and the one-pass prologue.
    """
    b = sorted_ids.shape[0]
    i = torch.arange(b, dtype=torch.int32, device=sorted_ids.device)
    firsts = torch.ones((b,), dtype=torch.bool, device=sorted_ids.device)
    firsts[1:] = sorted_ids[1:] != sorted_ids[:-1]
    group_start = torch.cummax(torch.where(firsts, i, -1), dim=0).values
    return firsts, (i - group_start).to(torch.int32)


def group_offsets(ids: torch.Tensor) -> torch.Tensor:
    """offset[i] = #{j < i : ids[j] == ids[i]} (rank within its id group)."""
    order = torch.sort(ids, stable=True).indices
    _, off_sorted = sorted_group_ranks(ids[order])
    out = torch.empty_like(off_sorted)
    out[order] = off_sorted
    return out


def chain_exec_from_hits(ops, chain_ids, raw_hit, valid=None):
    """(B,) bool execute mask for CHAIN_GET/CHAIN_PUT rows.

    raw_hit (B,) bool: batch-start membership of each query's key.  A
    CHAIN_GET row executes iff every CHAIN_GET row at or before it in its
    contiguous chain run was a valid raw hit (the longest-hit prefix); the
    o-th CHAIN_PUT row of a chain executes iff o >= the chain's hit length.
    ``chain_ids`` lie in [0, B).  An invalid chain row counts as a miss.

    The JAX package computes the prefix with a segmented ``associative_scan``;
    here two ``cummax`` passes give the same mask: a CHAIN_GET row is live
    iff the last bad row at or before it lies before its run's start.
    """
    b = ops.shape[0]
    dev = ops.device
    is_get = ops == OP_CHAIN_GET
    is_put = ops == OP_CHAIN_PUT
    if valid is None:
        valid = torch.ones((b,), dtype=torch.bool, device=dev)
    idx = torch.arange(b, dtype=torch.int64, device=dev)
    cids = chain_ids.to(torch.int64)
    # non-chain rows break runs (unique negative ids); invalid chain rows
    # keep their id so the run is not split around them
    cid = torch.where(is_get | is_put, cids, -1 - idx)
    firsts = torch.ones((b,), dtype=torch.bool, device=dev)
    firsts[1:] = cid[1:] != cid[:-1]
    run_start = torch.cummax(torch.where(firsts, idx, 0), dim=0).values
    bad = is_get & ~(raw_hit & valid)
    last_bad = torch.cummax(torch.where(bad, idx, -1), dim=0).values
    get_exec = is_get & valid & (last_bad < run_start)

    cid_c = cids.clamp(0, b - 1)
    hitlen = torch.zeros((b,), dtype=torch.int64, device=dev).index_add_(
        0, cid_c, get_exec.to(torch.int64))
    occ = group_offsets(torch.where(is_put, cid_c, b + idx))
    put_exec = is_put & valid & (occ >= hitlen[cid_c])
    return get_exec | put_exec


def chain_live_mask(cfg: MSLRUConfig, table, qkeys, ops, chain_ids, valid=None):
    """Longest-prefix scan on the device: probe + ``chain_exec_from_hits``.

    Exact because CHAIN_GET rows precede every membership-mutating row (the
    chain contract), so batch-start membership is at-execution membership.
    """
    sid = set_index_for(cfg, qkeys)
    raw_hit, _, _ = row_lookup(cfg, table[sid.to(torch.int64)], qkeys)
    return chain_exec_from_hits(ops, chain_ids, raw_hit, valid)


def access_result_zero(cfg: MSLRUConfig, b: int, device) -> AccessResult:
    """The result an unserved query reports: a plain miss, zero evictions."""
    z = torch.zeros((b,), dtype=torch.bool, device=device)
    return AccessResult(
        hit=z,
        value=torch.zeros((b, cfg.value_planes), dtype=torch.int32, device=device),
        pos=torch.full((b,), -1, dtype=torch.int32, device=device),
        evicted_key=torch.zeros((b, cfg.key_planes), dtype=torch.int32, device=device),
        evicted_val=torch.zeros((b, cfg.value_planes), dtype=torch.int32, device=device),
        evicted_valid=z,
    )


def pad_dummy_row(table: torch.Tensor) -> torch.Tensor:
    """A copy of ``table`` with one zero row appended (index S, the dummy)."""
    return torch.cat([table, table.new_zeros((1,) + tuple(table.shape[1:]))])


def batched_rounds_update_(cfg: MSLRUConfig, padded, gsid, valid, qkeys, qvals,
                           max_rounds: int | None = None, ops=None,
                           chain_live=None, costs=None):
    """``batched_rounds_update`` in place on ``padded``: the (S+1, A, C)
    table whose last row is the dummy that absorbs discarded writes.  Rows
    [0, S) are updated; returns (AccessResult, served)."""
    from repro_torch.kernels.ops import msl_access  # kernels -> core

    dev = padded.device
    s = padded.shape[0] - 1
    b = gsid.shape[0]
    kp, v = cfg.key_planes, cfg.value_planes
    idx = torch.arange(b, dtype=torch.int64, device=dev)
    gsid = torch.where(valid, gsid.to(torch.int64), s)        # sentinel group
    # invalid queries get unique ids so they never occupy a real rank
    offset = group_offsets(torch.where(valid, gsid, s + 1 + idx))
    n_rounds = int(torch.where(valid, offset, -1).max()) + 1 if b else 0
    if max_rounds is not None:
        n_rounds = min(n_rounds, max_rounds)

    acc = access_result_zero(cfg, b, dev)
    for r in range(n_rounds):
        new_rows, hit, pos, val, ev = msl_access(
            padded[gsid], qkeys, qvals, cfg=cfg, ops=ops, chain_live=chain_live,
            costs=costs)
        res = AccessResult(hit=hit != 0, value=val, pos=pos,
                           evicted_key=ev[:, :kp], evicted_val=ev[:, kp:kp + v],
                           evicted_valid=ev[:, 0] != EMPTY_KEY)
        sel = (offset == r) & valid
        padded[torch.where(sel, gsid, s)] = new_rows   # losers pile on the dummy
        acc = AccessResult(*(
            torch.where(sel.reshape((b,) + (1,) * (n.ndim - 1)), n, a)
            for a, n in zip(acc, res)))
    served = valid & (offset < n_rounds)
    acc = acc._replace(hit=acc.hit & served,
                       evicted_valid=acc.evicted_valid & served)
    return acc, served


def batched_rounds_update(cfg: MSLRUConfig, table, gsid, valid, qkeys, qvals,
                          max_rounds: int | None = None, ops=None,
                          chain_live=None, costs=None):
    """Exact multi-query update: serialize same-set queries across rounds.

    table (S, A, C); gsid (B,) set id per query (``valid`` False entries are
    ignored); ``ops`` (B,) optional opcodes (default all OP_ACCESS);
    ``chain_live`` (B,) optional execute mask for chain rows; ``costs`` (B,)
    optional insert costs.  Returns (table, AccessResult, served).
    Bit-exact w.r.t. processing the valid queries sequentially in batch
    order.  ``max_rounds`` drops queries ranked past the cap in their set
    (hit False, served False).

    Round r gathers every query's row, applies ``kernels.ops.msl_access``
    (the CUDA access kernel for a table on the card, its plain version on
    the CPU) and scatters back the rows of the queries ranked r.  The round
    count is read back to the host once per call.
    """
    padded = pad_dummy_row(table)
    res, served = batched_rounds_update_(cfg, padded, gsid, valid, qkeys, qvals,
                                         max_rounds, ops, chain_live, costs)
    return padded[:-1], res, served


def make_conflict_update(cfg: MSLRUConfig, engine: str = "rounds",
                         max_rounds: int | None = None, in_place: bool = False):
    """Bind the conflict scheme to ``update(table, gsid, valid, qkeys,
    qvals, ops=None, chain_live=None, costs=None) -> (table, AccessResult,
    served)``: the one dispatch point of the ``engine`` switch.

    ``in_place=True`` takes the (S+1, A, C) table with the dummy row
    appended, updates it in place and returns its (S, A, C) view; this
    spares a long-lived cache a copy of its table for every batch.
    """
    if engine == "onepass":
        from repro_torch.kernels.ops import onepass_update_ as update_
    elif engine == "rounds":
        update_ = batched_rounds_update_
    else:
        raise ValueError(f"unknown engine {engine!r}")

    def update(table, gsid, valid, qkeys, qvals, ops=None, chain_live=None,
               costs=None):
        padded = table if in_place else pad_dummy_row(table)
        res, served = update_(cfg, padded, gsid, valid, qkeys, qvals,
                              max_rounds, ops=ops, chain_live=chain_live,
                              costs=costs)
        return padded[:-1], res, served

    return update


def engine_from_update(cfg: MSLRUConfig, update):
    """run(table, qkeys (B,KP), qvals (B,V), ops=None, chain_ids=None,
    costs=None) -> (table, AccessResult) around a conflict ``update``.

    ``chain_ids`` (B,) enables the fused chain ops: the longest-prefix scan
    runs on the table's device before the update, with no host sync.  The
    table is whatever ``update`` takes: with ``in_place`` updates it carries
    the dummy row, which no query's set id reaches.
    """

    def run(table, qkeys, qvals, ops=None, chain_ids=None, costs=None):
        dev = table.device
        ops, costs = as_i32(ops, dev), as_i32(costs, dev)
        sids = set_index_for(cfg, qkeys)
        valid = torch.ones(sids.shape, dtype=torch.bool, device=dev)
        live = None
        if chain_ids is not None:
            if ops is None:
                raise ValueError("chain_ids requires an ops vector")
            live = chain_live_mask(cfg, table, qkeys, ops, as_i32(chain_ids, dev))
        table, res, _served = update(table, sids, valid, qkeys, qvals, ops,
                                     chain_live=live, costs=costs)
        return table, res

    return run


def make_batched_engine(cfg: MSLRUConfig, max_rounds: int | None = None,
                        engine: str = "rounds"):
    """Returns run(table, qkeys (B,KP), qvals (B,V), ops=None,
    chain_ids=None, costs=None) -> (table, AccessResult).

    Exact (sequential-equivalent) unless ``max_rounds`` caps the conflict
    serialization.  ``engine="rounds"`` applies the access kernel once per
    conflict round; ``engine="onepass"`` runs the single-pass pipeline,
    whose chain loop is the one-pass kernel.  A table on the card runs the
    CUDA kernels, a table on the CPU their plain versions.
    """
    return engine_from_update(cfg, make_conflict_update(cfg, engine, max_rounds))


def make_chunked_stream_runner(cfg: MSLRUConfig, batch: int,
                               engine: str = "rounds", **engine_kwargs):
    """Throughput runner: the batched engine over a stream in ``batch``
    chunks (a trailing partial chunk is dropped).  Returns
    run(table, qkeys, qvals, ops=None, costs=None) -> (table, total hits)."""
    run_batch = make_batched_engine(cfg, engine=engine, **engine_kwargs)

    def run(table, qkeys, qvals, ops=None, costs=None):
        n = qkeys.shape[0] // batch * batch
        hits = torch.zeros((), dtype=torch.int64, device=table.device)
        for i in range(0, n, batch):
            q = slice(i, i + batch)
            table, res = run_batch(table, qkeys[q], qvals[q],
                                   None if ops is None else ops[q],
                                   costs=None if costs is None else costs[q])
            hits += res.hit.sum()
        return table, hits

    return run
