"""Distributed multi-step LRU cache: sets sharded across the shards of a mesh.

Port of ``repro.core.sharded``.  The paper parallelizes across cores with
per-set locks; the JAX package shards the set table over the devices of a
mesh and routes each query to the shard that owns its set with an
``all_to_all``, the fixed-capacity dispatch of MoE token routing.  Shards
never contend: the set-associative independence argument of the paper's
fine-grained locks, lifted from cores to devices.

Shard ``d`` owns sets ``[d * s_local, (d + 1) * s_local)``.  Two meshes
(``launch/mesh.py``):

* ``CacheMesh``: D logical shards in one process on one device, the table
  one (D * s_local, A, C) tensor.  ``make_sharded_engine`` makes no exchange
  there: a shard takes its queries in arrival order (source slab, slot),
  which is caller order, so the route there and back changes no result.
  It ranks each query among its slab's queries to the same owner (a one-hot
  cumsum, as the JAX route ranks a send buffer's slots), sheds those ranked
  past ``cap``, and runs one conflict update over the whole table keyed by
  the global set id: the D per-shard updates, since shards own disjoint
  sets.
* ``ProcessCacheMesh``: one shard per rank of a process group; each rank
  holds its ``s_local`` rows and its slab of every batch, and
  ``make_sharded_engine`` runs the JAX route (``make_routed_engine``):
  send buffers of depth k per peer plus a sacrificial column k that catches
  every overflow row, one ``all_to_all`` there and one back (two more for
  the chain probe), the update on the local rows.  The route runs over a
  ``CacheMesh`` too, where its ``all_to_all`` is a transpose: the in-process
  check that it gives the direct engine's results.

``engine="rounds"`` runs the access kernel per conflict round,
``engine="onepass"`` the one-pass kernel once per call (the CUDA kernels
for a table on the card, their plain versions on the CPU).  Chain ops add a
membership pre-phase: a read-only probe of the batch-start table and the
longest-prefix scan over each slab's chains (``chain_exec_from_hits``;
chains never straddle slabs).  An optional ``order`` plane carries each
query's caller-order rank; the served rows are stably sorted by it before
the update, so the table is bit-equal to the local engine fed the queries
in rank order, however the caller packed them into slabs.

``ShardedCacheClient`` is the host-side backend of
``serving.prefix_cache.PrefixCache``: whole-chain (``load``/``roundrobin``)
or split placement onto shard slabs, the host shed pre-check that mirrors
the device ranks, the per-home-shard pressure EWMA that drives admission
throttling, degraded shards, injected route failures and live resharding.
Its placement is the JAX package's numpy code, unchanged, so every counter
and pressure comes out equal to the JAX client's.  Over a
``ProcessCacheMesh`` every rank runs the same placement on the same batch,
feeds its own slab and gathers every slab's results; a rank outside the
mesh's group (after a shrink) runs the placement too and receives the
results, so every rank of the world keeps the same host state.
``mark_degraded`` wipes the owning rank's rows and hands them to every rank
for the orphan list; ``reshard`` drains through the current group and
rebuilds on the first D' ranks (``ProcessCacheMesh.resized``).  Either
every rank calls the client (SPMD), or world rank 0 drives it inside
``leading()`` and the others replay its calls in ``follow()``: the
counterpart of the JAX package's single controller over D devices.
"""

from __future__ import annotations

import contextlib
import functools
import math

import numpy as np
import torch

from repro_torch.core.engine import (as_i32, chain_exec_from_hits,
                                     make_conflict_update, pad_dummy_row)
from repro_torch.core.invector import EMPTY_KEY
from repro_torch.core.multistep import (AccessResult, MSLRUConfig, OP_ACCESS,
                                        OP_CHAIN_GET, OP_CHAIN_PUT, OP_LOOKUP,
                                        init_table, row_lookup, set_index_for)

__all__ = ["make_routed_engine", "make_sharded_engine", "make_sharded_stream_runner",
           "shard_table", "gather_shards", "ShardedCacheClient", "per_peer_cap",
           "sets_per_shard"]

_INT32_MAX = 2**31 - 1


def sets_per_shard(num_sets: int, ndev: int) -> int:
    """Sets owned by each shard: ``ceil(num_sets / ndev)``.  The table is
    padded with EMPTY sets to ``ndev * s_local`` rows; ``owner = sid //
    s_local`` is exact and no key hashes into the padded tail."""
    return -(-num_sets // ndev)


def per_peer_cap(cap, q_local: int, ndev: int) -> int:
    """The per-peer send-buffer depth for a slab of ``q_local`` queries,
    shared by the engine's route and the client's shed pre-check.

    ``cap``: ``"full"`` — the whole slab (nothing sheds); a ``float`` — a
    multiplier over the expected per-peer load ``q_local / ndev``; an
    ``int`` — a fixed depth; ``None`` — 2x the expected load."""
    if cap == "full":
        return q_local
    if cap is None:
        return max(1, (2 * q_local) // ndev)
    if isinstance(cap, float):
        return max(1, math.ceil(cap * q_local / ndev))
    return max(1, int(cap))


def shard_table(table, mesh, axis: str = "cache", dummy: bool = False):
    """A (S, A, C) table (tensor or numpy) as the sharded table on the
    mesh's device: padded with EMPTY sets to ``ndev * s_local`` rows when
    ``ndev`` does not divide S (the padded sets live on the last shard and
    no key reaches them; host reads slice back to ``[:num_sets]``).  On a
    ``ProcessCacheMesh`` the rank's own ``s_local`` rows of it (none on a
    rank outside the mesh's group).  ``dummy=True`` appends the conflict
    engines' dummy row, for engines built with ``in_place=True``."""
    ndev = mesh.shape[axis]
    table = torch.as_tensor(table)
    s = table.shape[0]
    s_local = sets_per_shard(s, ndev)
    if mesh.rank is not None:
        lo = mesh.rank * s_local if mesh.rank >= 0 else 0
        hi = lo + s_local if mesh.rank >= 0 else 0
        table = table[lo:hi].to(mesh.device, torch.int32, copy=True)
        s, ndev = table.shape[0], int(mesh.rank >= 0)
    table = table.to(mesh.device, torch.int32)
    pad = ndev * s_local - s + (1 if dummy else 0)
    if pad:
        empty = table.new_zeros((pad,) + tuple(table.shape[1:]))
        empty[:, :, 0] = EMPTY_KEY
        table = torch.cat([table, empty])
    return table.contiguous()


def gather_shards(mesh, x: torch.Tensor) -> torch.Tensor:
    """What every shard holds, concatenated in shard order along dim 0 (a
    rank's table rows give the whole (ndev * s_local, A, C) table): ``x``
    itself on a ``CacheMesh``, every rank's ``x`` on a
    ``ProcessCacheMesh`` (a rank outside its group passes a tensor of the
    shape a shard passes, and receives the result)."""
    return x if mesh.rank is None else mesh.all_gather(x)


def make_sharded_engine(cfg: MSLRUConfig, mesh, axis: str = "cache", cap=None,
                        max_rounds: int | None = None, engine: str = "rounds",
                        in_place: bool = False):
    """Build ``run(table, qkeys, qvals, ops=None, chain_ids=None,
    order=None, costs=None)``: the direct engine below on a ``CacheMesh``,
    the route (``make_routed_engine``) on a ``ProcessCacheMesh``.

    table: (D * s_local, A, C) from ``shard_table`` (with ``in_place`` the
           table with the dummy row appended, updated in place); on a
           ``ProcessCacheMesh`` the rank's (s_local, A, C) rows.
    qkeys: (Q, KP), qvals: (Q, V): D contiguous slabs of Q / D queries, slab
           ``d`` the queries shard ``d`` holds; on a ``ProcessCacheMesh``
           the rank's slab.
    ops:   (Q,) optional opcodes.
    chain_ids: (Q,) optional chain segment ids for CHAIN_GET/CHAIN_PUT rows
           (requires ``ops``), slab-local in [0, Q / D) with every chain in
           one slab; adds the membership pre-phase and the evicted planes.
    order: (Q,) optional caller-order rank (requires ``ops``): the served
           rows are stably sorted by it before the update.
    costs: (Q,) optional insert costs (needs ``cfg.cost_planes``).
    cap:   per-peer send-buffer depth (``per_peer_cap``).
    Returns (table, hit, val, served); chain mode appends (evicted_val
    (Q, max(V, 1)), evicted_valid (Q,)).  ``hit`` is False for misses and
    shed queries; ``served`` False only for shed queries, whose planes are
    all zero.  ``engine`` is the conflict scheme of the update.
    """
    if mesh.rank is not None:
        return make_routed_engine(cfg, mesh, axis, cap, max_rounds, engine, in_place)
    update = make_conflict_update(cfg, engine, max_rounds, in_place=True)
    ndev = mesh.shape[axis]
    s_local = sets_per_shard(cfg.num_sets, ndev)
    kp, v = cfg.key_planes, cfg.value_planes

    def _served(sid, q, k):
        """A query is served unless it ranks past ``k`` among its slab's
        queries to the same owner shard: the 1-based rank by a one-hot
        cumsum, as the JAX route ranks a send buffer's slots."""
        if k >= q:
            return torch.ones(sid.shape, dtype=torch.bool, device=sid.device)
        owner = sid.to(torch.int64).view(ndev, q, 1) // s_local
        onehot = (owner == torch.arange(ndev, device=sid.device).view(1, 1, ndev))
        slot = onehot.to(torch.int32).cumsum(1).gather(2, owner).view(-1)
        return slot <= k

    def run(table, qkeys, qvals, ops=None, chain_ids=None, order=None, costs=None):
        if order is not None and ops is None:
            raise ValueError("order requires an ops vector")
        if chain_ids is not None and ops is None:
            raise ValueError("chain_ids requires an ops vector")
        dev = table.device
        q_all = qkeys.shape[0]
        if q_all % ndev:
            raise ValueError(f"{q_all} queries do not split into {ndev} slabs")
        q = q_all // ndev
        padded = table if in_place else pad_dummy_row(table)
        qkeys = as_i32(qkeys, dev).reshape(q_all, kp)
        qvals = as_i32(qvals, dev).reshape(q_all, v)
        ops, chain_ids, order, costs = (as_i32(x, dev) for x in
                                        (ops, chain_ids, order, costs))
        sid = set_index_for(cfg, qkeys)
        served = _served(sid, q, per_peer_cap(cap, q, ndev))

        live = None
        if chain_ids is not None:
            # membership pre-phase: a read-only probe of the batch-start
            # table, then the longest-prefix scan over every slab's chains
            # (slab-local chain ids made global by the slab offset)
            probe, _, _ = row_lookup(cfg, padded[sid.to(torch.int64)], qkeys)
            slab = torch.arange(q_all, device=dev, dtype=torch.int32) // q * q
            live = chain_exec_from_hits(ops, chain_ids + slab, probe & served,
                                        valid=served)

        # Shards own disjoint sets, and a shard takes its queries in arrival
        # order (source slab, slot), which is caller order: every set sees
        # its served queries in caller order, so one update over the whole
        # table keyed by the global set id is the D per-shard updates, with
        # no exchange on one device.  With ``order``, the served rows are
        # stably sorted by caller-order rank first, shed rows last.
        perm = None
        if order is not None:
            perm = torch.sort(torch.where(served, order, _INT32_MAX), stable=True).indices

        def p(x):
            return x if x is None or perm is None else x[perm]

        _, res, _ = update(padded, p(sid), p(served), p(qkeys), p(qvals), p(ops),
                           chain_live=p(live), costs=p(costs))
        if perm is not None:
            inv = torch.empty_like(perm)
            inv[perm] = torch.arange(q_all, device=dev)
            res = AccessResult(*(x[inv] for x in res))
        # a shed row is a plain miss with all-zero planes
        zero = served[:, None]
        hit = res.hit & served
        val = (torch.where(zero, res.value, 0) if v
               else torch.zeros((q_all, 1), dtype=torch.int32, device=dev))
        if chain_ids is not None:
            ev_val = (torch.where(zero, res.evicted_val, 0) if v
                      else torch.zeros((q_all, 1), dtype=torch.int32, device=dev))
            return padded[:-1], hit, val, served, ev_val, res.evicted_valid & served
        return padded[:-1], hit, val, served

    return run


def make_routed_engine(cfg: MSLRUConfig, mesh, axis: str = "cache", cap=None,
                       max_rounds: int | None = None, engine: str = "rounds",
                       in_place: bool = False):
    """The JAX package's route over any mesh with ``all_to_all``:
    ``run(table, qkeys, qvals, ops=None, chain_ids=None, order=None,
    costs=None)`` with ``make_sharded_engine``'s operands and results, for
    the L shards this process holds (all D on a ``CacheMesh``, its own on a
    ``ProcessCacheMesh``): ``table`` their L * s_local rows, the queries their
    L slabs.

    Each slab packs its queries into (D, k + 1, planes) send buffers, slot =
    the query's rank among the slab's queries to the same owner (a one-hot
    cumsum); a query ranked past k is shed, and its scatter lands in the
    sacrificial column k, which the exchange leaves out, so it clobbers no
    admitted row.  The planes are the key, the values, then the opcode, the
    chain execute bit, the cost and the ``order`` rank when present.  Each
    owner updates its rows with what it received, in arrival order (source,
    slot) or stably sorted by ``order``, and the hit and value planes (chain
    mode: also the evicted ones) go back by the same slots.  Chain mode
    first routes the keys alone: the owners probe the batch-start table and
    the hits come back for the longest-prefix scan at the source."""
    update = make_conflict_update(cfg, engine, max_rounds, in_place=True)
    ndev = mesh.shape[axis]
    local = ndev if mesh.rank is None else 1
    s_local = sets_per_shard(cfg.num_sets, ndev)
    kp, v = cfg.key_planes, cfg.value_planes
    ve = max(v, 1)

    def exchange(send):
        """(L, D, k, planes) send stacks -> the L receive stacks."""
        return mesh.all_to_all(send) if mesh.rank is None else mesh.all_to_all(send[0])[None]

    def route(qkeys, planes, q, k):
        """Pack and exchange.  Returns the routed rows (L * D * k, planes),
        each query's (slab, owner, slot) address for the way back, and the
        served mask."""
        dev = qkeys.device
        owner = set_index_for(cfg, qkeys).to(torch.int64).view(local, q) // s_local
        onehot = owner[:, :, None] == torch.arange(ndev, device=dev)
        slot = onehot.to(torch.int32).cumsum(1).gather(2, owner[:, :, None])[:, :, 0] - 1
        served = slot < k
        payload = torch.cat([qkeys, *planes], dim=1).view(local, q, -1)
        send = torch.full((local, ndev, k + 1, payload.shape[-1]), EMPTY_KEY,
                          dtype=torch.int32, device=dev)
        slab = torch.arange(local, device=dev)[:, None].expand(local, q)
        send[slab, owner, torch.where(served, slot, k)] = payload
        recv = exchange(send[:, :, :k])
        back = (slab, owner, torch.where(served, slot, k - 1))   # shed rows: clamped
        return recv.reshape(local * ndev * k, -1), back, served.reshape(-1)

    def route_back(planes, back, k):
        """The routed rows' result planes back to their sources, unpacked to
        query order (a shed row reads a clamped slot, masked by the caller)."""
        out = torch.cat(planes, dim=1).view(local, ndev, k, -1)
        return exchange(out)[back].reshape(local * back[0].shape[1], -1)

    def run(table, qkeys, qvals, ops=None, chain_ids=None, order=None, costs=None):
        if order is not None and ops is None:
            raise ValueError("order requires an ops vector")
        if chain_ids is not None and ops is None:
            raise ValueError("chain_ids requires an ops vector")
        dev = table.device
        q_all = qkeys.shape[0]
        if q_all % local:
            raise ValueError(f"{q_all} queries do not split into {local} slabs")
        q = q_all // local
        k = per_peer_cap(cap, q, ndev)
        padded = table if in_place else pad_dummy_row(table)
        qkeys = as_i32(qkeys, dev).reshape(q_all, kp)
        qvals = as_i32(qvals, dev).reshape(q_all, v)
        ops, chain_ids, order, costs = (as_i32(x, dev) for x in
                                        (ops, chain_ids, order, costs))
        # a routed row's row in this process's table: its owner's local
        # index times s_local plus its set within the owner (padding rows,
        # EMPTY keys, land inside their receiving shard)
        rows_of = (torch.arange(local * ndev * k, device=dev) // (ndev * k)) * s_local

        def local_rows(keys):
            return rows_of + set_index_for(cfg, keys) % s_local

        live = None
        if chain_ids is not None:
            rq, back, served = route(qkeys, [], q, k)
            p_keys = rq[:, :kp]
            p_hit, _, _ = row_lookup(cfg, padded[local_rows(p_keys)], p_keys)
            p_hit = p_hit & (p_keys[:, 0] != EMPTY_KEY)
            home = route_back([p_hit.to(torch.int32)[:, None]], back, k)
            slab = torch.arange(q_all, device=dev, dtype=torch.int32) // q * q
            live = chain_exec_from_hits(ops, chain_ids + slab, (home[:, 0] != 0) & served,
                                        valid=served)

        planes = [qvals] + [x[:, None] for x in (ops, live, costs, order) if x is not None]
        rq, back, served = route(qkeys, planes, q, k)
        # the kernels take contiguous planes
        r_keys, r_vals = rq[:, :kp].contiguous(), rq[:, kp:kp + v].contiguous()
        valid = r_keys[:, 0] != EMPTY_KEY
        col = iter(range(kp + v, rq.shape[1]))

        def plane(x, fill):
            return None if x is None else torch.where(valid, rq[:, next(col)], fill)

        r_ops, r_live = plane(ops, OP_ACCESS), plane(live, 0)
        r_cost, r_ord = plane(costs, 0), plane(order, _INT32_MAX)
        lsid = local_rows(r_keys)
        perm = None
        if r_ord is not None:
            perm = torch.sort(r_ord, stable=True).indices

        def p(x):
            return x if x is None or perm is None else x[perm]

        _, res, _ = update(padded, p(lsid), p(valid), p(r_keys), p(r_vals), p(r_ops),
                           chain_live=p(r_live), costs=p(r_cost))
        if perm is not None:
            inv = torch.empty_like(perm)
            inv[perm] = torch.arange(perm.shape[0], device=dev)
            res = AccessResult(*(x[inv] for x in res))

        n = rq.shape[0]
        zeros = torch.zeros((n, 1), dtype=torch.int32, device=dev)
        out = [(res.hit & valid).to(torch.int32)[:, None], res.value if v else zeros]
        if chain_ids is not None:
            out += [res.evicted_val if v else zeros,
                    (res.evicted_valid & valid).to(torch.int32)[:, None]]
        home = route_back(out, back, k)
        # a shed row is a plain miss with all-zero planes
        zero = served[:, None]
        hit = (home[:, 0] != 0) & served
        val = torch.where(zero, home[:, 1:1 + ve], 0)
        if chain_ids is not None:
            ev_val = torch.where(zero, home[:, 1 + ve:1 + 2 * ve], 0)
            return padded[:-1], hit, val, served, ev_val, (home[:, 1 + 2 * ve] != 0) & served
        return padded[:-1], hit, val, served

    return run


def make_sharded_stream_runner(cfg: MSLRUConfig, mesh, axis: str = "cache",
                               cap=None, batch: int = 4096, engine: str = "rounds",
                               **engine_kwargs):
    """The sharded engine over a long stream: ``run(table, qkeys, qvals,
    ops=None, chain_ids=None, costs=None) -> (table, hits, served)``, one
    ``batch`` slice of every operand per step (a trailing partial batch is
    dropped), the counts 0-d tensors on the table's device.  ``served``
    counts the queries not shed, so ``1 - served / n`` is the shed rate.

    The counterpart of the JAX package's ``lax.scan``: the table is copied
    once (the dummy row appended), every batch updates it in place, and the
    loop itself makes no host sync (the rounds engine reads its round count
    once per batch, as it does everywhere).  On a ``ProcessCacheMesh`` every
    rank passes the whole stream and feeds its slab of each batch; one
    gather at the end sums the counts over the ranks."""
    eng = make_sharded_engine(cfg, mesh, axis, cap, engine=engine, in_place=True,
                              **engine_kwargs)
    ndev = mesh.shape[axis]
    if batch % ndev:
        raise ValueError(f"batch {batch} does not split into {ndev} slabs")
    q = batch // ndev
    lo, hi = (0, batch) if mesh.rank is None else (mesh.rank * q, (mesh.rank + 1) * q)

    def run(table, qkeys, qvals, ops=None, chain_ids=None, costs=None):
        if chain_ids is not None and ops is None:
            raise ValueError("chain_ids requires an ops vector")
        padded = pad_dummy_row(table)
        n = qkeys.shape[0] // batch * batch
        hits = torch.zeros((), dtype=torch.int64, device=padded.device)
        served = torch.zeros((), dtype=torch.int64, device=padded.device)
        for i in range(0, n, batch):
            sl = slice(i + lo, i + hi)
            out = eng(padded, qkeys[sl], qvals[sl],
                      None if ops is None else ops[sl],
                      None if chain_ids is None else chain_ids[sl],
                      costs=None if costs is None else costs[sl])
            hits += out[1].sum()
            served += out[3].sum()
        if mesh.rank is not None:
            hits, served = mesh.all_gather(torch.stack([hits, served])[None]).sum(0)
        return padded[:-1], hits, served

    return run


def _host_owners(cfg: MSLRUConfig, keys: np.ndarray, s_local: int) -> np.ndarray:
    """Each 1-plane key's owner shard, on the host."""
    sid = set_index_for(cfg, torch.from_numpy(np.ascontiguousarray(keys, np.int32)[:, None]))
    return sid.numpy() // s_local


def _replayed(method):
    """A client call that world rank 0 hands to the other ranks while it
    leads (``ShardedCacheClient.leading``), by name and arguments, before
    it runs the call itself; calls it makes inside another such call go
    with their caller."""
    name = method.__name__

    @functools.wraps(method)
    def call(self, *args, **kwargs):
        if self._leading and not self._in_call:
            self.mesh.share_object((name, args, kwargs))
        outer, self._in_call = self._in_call, True
        try:
            return method(self, *args, **kwargs)
        finally:
            self._in_call = outer

    return call


class ShardedCacheClient:
    """Host-side client exposing the sharded engine with the local
    ``MultiStepLRUCache`` access contract, so ``PrefixCache`` serves a
    sharded cache unchanged (one fused chain call per tick).

    Repacking: the sharded call splits the batch into ``ndev`` contiguous
    slabs and the chain scan is slab-local, so ``access`` deals whole
    chains onto slabs, renumbers chain ids slab-locally, pads every slab to
    a common power-of-two length with no-op LOOKUP rows on key 0, and
    unpacks the outputs to caller order.  Each packed row carries its
    caller index as the engine's ``order`` rank, so the table stays
    bit-equal to a local cache fed the same batch (``pos`` is not routed
    back: it is reported -1).

    Bounded caps: with ``cap != "full"`` a host pre-check mirrors the
    device route ranks (the same per-(slab, owner) counting in slab order)
    and sheds WHOLE groups, never half a chain; ``last_shed`` marks them in
    caller order and the engine's ``served`` mask must hold for every
    admitted row.  ``placement="load"`` places each group on the slab
    where its peak per-owner depth stays smallest; ``"roundrobin"`` deals;
    ``"split"`` (the default under a bounded cap) packs each chain as
    prefix-closed chunk fragments over several slabs and sheds only the
    un-placeable suffix.  Counters: ``sheds``, ``shed_groups``,
    ``split_chains``, ``partial_sheds``, ``slab_occupancy_peak``,
    ``degraded_sheds``, ``fault_sheds``; ``slab_pressure`` is a
    per-home-shard EWMA of buffer fill (1.0 for owners in capacity or
    degraded sheds), read by ``chain_pressure`` as the serving engine's
    admission-throttle signal.

    The placement is numpy on the host, the JAX package's code line for
    line; one ``access`` makes one host-to-device copy of the packed slabs
    and one device-to-host copy of the results.

    Over a ``ProcessCacheMesh`` every rank of the world holds a client and
    makes the same calls: each itself (SPMD), or world rank 0 inside
    ``leading()`` with the others in ``follow()``.  The calls that touch
    the table or the host state (``access``, ``note_chain``,
    ``inject_route_failures``, ``mark_degraded``, ``reshard``,
    ``gathered_table``, ``occupancy``) then run on every rank in the same
    order, and every rank ends each with the same results and host state.
    """

    batch_multiple = 1  # access() repacks internally; any B works
    self_padding = True  # callers need not pad; slabs are padded here

    def __init__(self, cfg: MSLRUConfig, mesh, axis: str = "cache",
                 engine: str = "onepass", cap="full", placement: str | None = None):
        if cfg.key_planes != 1:
            raise ValueError("ShardedCacheClient packs 1-plane keys (chunk "
                             "hashes); key_planes=2 is not supported here")
        if placement is None:
            placement = "split" if cap != "full" else "load"
        if placement not in ("load", "roundrobin", "split"):
            raise ValueError(f"unknown placement {placement!r}")
        self.cfg = cfg
        self.cap = cap
        self.placement = placement
        self._axis = axis
        self._engine_kwargs = dict(engine=engine)
        self._bind_mesh(mesh)
        self._padded = shard_table(init_table(cfg, mesh.device), mesh, axis, dummy=True)
        self.sheds = 0          # rows shed by the capacity pre-check
        self.shed_groups = 0    # groups (chains / plain rows) shed
        self.last_shed = None   # (n,) bool, caller order, of the last access
        self.route_shape = None  # (q, k_depth, payload planes) of the last call
        self.split_chains = 0   # chains placed as >= 2 fragments
        self.partial_sheds = 0  # suffix-only sheds (a prefix was served)
        self.slab_occupancy_peak = 0.0  # max per-(slab, owner) fill seen
        self._pressure_alpha = 0.4      # slab_pressure EWMA weight
        self.degraded: set[int] = set()   # shards treated as lost
        self.degraded_sheds = 0           # groups shed because of them
        self.fault_sheds = 0              # groups shed by injected faults
        self._transient_fail = None       # [calls_left, frac, rng]
        # chain registry: tuple(chain hashes) -> last-touch counter; the
        # serving tier notes every chain it serves so a reshard can drain
        # the table chain by chain
        self._chain_registry: dict[tuple, int] = {}
        self._touch = 0
        self.last_drain_stream: list[dict] = []   # reshard()'s re-insert batches
        self._leading = False   # world rank 0 hands its calls to the others
        self._in_call = False   # inside a replayed call

    @property
    def table(self) -> torch.Tensor:
        """The (ndev * s_local, A, C) sharded table (a view); on a
        ``ProcessCacheMesh`` this rank's (s_local, A, C) rows (none outside
        the mesh's group)."""
        return self._padded[:-1]

    def _rows(self) -> torch.Tensor:
        """This rank's share of a gather: its rows, or on a rank outside
        the mesh's group a stand-in of a shard's shape."""
        if self.mesh.rank is not None and self.mesh.rank < 0:
            return self._padded.new_zeros((self._s_local, *self._padded.shape[1:]))
        return self.table

    @_replayed
    def gathered_table(self) -> np.ndarray:
        """The whole (num_sets, A, C) table as numpy, on every rank."""
        whole = gather_shards(self.mesh, self._rows())
        return whole[: self.cfg.num_sets].cpu().numpy().copy()

    @contextlib.contextmanager
    def leading(self):
        """World rank 0 drives the cache of a ``ProcessCacheMesh`` inside the
        block: each replayed call goes first to the other ranks, which run
        ``follow()``; on leaving, they are told to stop."""
        if self.mesh.rank is None:
            raise ValueError("leading() drives the ranks of a ProcessCacheMesh")
        import torch.distributed as dist

        if dist.get_rank() != 0:
            raise ValueError("world rank 0 leads; the other ranks follow()")
        self._leading = True
        try:
            yield self
        finally:
            self._leading = False
            self.mesh.share_object((None, (), {}))

    def follow(self) -> int:
        """On a rank other than world rank 0: run each call world rank 0
        makes inside ``leading()``, in order, until it stops.  Returns the
        number of calls."""
        calls = 0
        while True:
            name, args, kwargs = self.mesh.share_object()
            if name is None:
                return calls
            getattr(self, name)(*args, **kwargs)
            calls += 1

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    def _bind_mesh(self, mesh):
        """(Re)bind the routing engine to ``mesh``."""
        self.mesh = mesh
        self.ndev = mesh.shape[self._axis]
        self._s_local = sets_per_shard(self.cfg.num_sets, self.ndev)
        # per-home-shard pressure EWMA; a new mesh starts cold
        self.slab_pressure = np.zeros(self.ndev)
        self._run = make_sharded_engine(self.cfg, mesh, axis=self._axis, cap=self.cap,
                                        in_place=True, **self._engine_kwargs)
        # full-cap engine for control-plane sweeps (drain); built lazily
        self._full_run = self._run if self.cap == "full" else None

    @_replayed
    def access(self, keys, vals=None, ops=None, chain_ids=None, costs=None):
        keys = np.asarray(keys, np.int32).reshape(-1)
        n = keys.shape[0]
        v = self.cfg.value_planes
        if vals is None:
            vals = np.zeros((n, v), np.int32)
        vals = np.asarray(vals, np.int32).reshape(n, v)
        if ops is None:
            ops = np.full(n, OP_ACCESS, np.int32)
        ops = np.asarray(ops, np.int32)
        chain_ids = (np.zeros(n, np.int32) if chain_ids is None
                     else np.asarray(chain_ids, np.int32))
        if costs is not None:
            costs = np.asarray(costs, np.int32).reshape(-1)

        # groups: contiguous runs of one chain id among chain rows; plain
        # rows are singleton groups
        groups: list[list[int]] = []
        is_chain = (ops == OP_CHAIN_GET) | (ops == OP_CHAIN_PUT)
        prev = None
        for i in range(n):
            key = ("c", int(chain_ids[i])) if is_chain[i] else ("p", i)
            if key != prev:
                groups.append([])
                prev = key
            groups[-1].append(i)
        # a chain appears as two runs (GET island, PUT island) of one id:
        # merge them so both land on the same slab
        merged: dict = {}
        order: list = []
        for g in groups:
            gk = ("c", int(chain_ids[g[0]])) if is_chain[g[0]] else ("p", g[0])
            if gk in merged:
                merged[gk].extend(g)
            else:
                merged[gk] = list(g)
                order.append(gk)
        # degraded shards neither host slabs nor answer probes
        healthy = [d for d in range(self.ndev) if d not in self.degraded]
        if not healthy:
            raise RuntimeError("every shard degraded; reshard() to a live mesh")
        owners = None
        if self.cap != "full" or self.degraded or self._transient_fail:
            owners = _host_owners(self.cfg, keys, self._s_local)
        placement = self.placement
        if placement == "split" and (owners is None or len(healthy) < 2):
            # split needs >= 2 live slabs and a reason to shed; else the
            # whole-chain load deal (round-robin on one slab)
            placement = "load"

        tf = self._transient_fail
        shed = np.zeros(n, bool)
        # slab-local chain ids segment on ``seg``: the caller's chain id,
        # or a unique fragment id under split placement
        seg = chain_ids.astype(np.int64, copy=True)
        counts2d = None
        hot = np.zeros(self.ndev, bool)   # owners implicated in sheds
        if placement == "split":
            slabs, q, k_depth, counts2d = self._place_split(
                order, merged, is_chain, keys, owners, n, healthy, tf, shed, seg, hot)
            self.sheds += int(shed.sum())
        else:
            slabs, q, k_depth, counts2d = self._place_whole(
                order, merged, is_chain, owners, n, healthy, placement, tf, shed, hot)
        self.last_shed = shed
        if tf is not None:
            tf[0] -= 1
            if tf[0] <= 0:
                self._transient_fail = None
        if owners is not None and counts2d is not None:
            self._note_pressure(counts2d, k_depth if self.cap != "full" else q, hot)
        bp = q * self.ndev
        k = np.zeros(bp, np.int32)
        vv = np.zeros((bp, v), np.int32)
        oo = np.full(bp, OP_LOOKUP, np.int32)          # padding: no-op probe
        cc = np.zeros(bp, np.int32)
        cst = None if costs is None else np.zeros(bp, np.int32)
        od = n + np.arange(bp, dtype=np.int32)         # padding ranks: last
        src = np.full(bp, -1, np.int64)                # row -> caller index
        for d, slab in enumerate(slabs):
            # slab-local segment ids: the first row of the segment (a whole
            # chain, or one fragment under split placement)
            local_first: dict = {}
            for r, i in enumerate(slab):
                row = d * q + r
                k[row] = keys[i]
                vv[row] = vals[i]
                oo[row] = ops[i]
                od[row] = i                            # caller-order rank
                src[row] = i
                if cst is not None:
                    cst[row] = costs[i]
                if is_chain[i]:
                    sk = int(seg[i])
                    local_first.setdefault(sk, r)
                    cc[row] = local_first[sk]
        # key + val + op + live [+ cost] + order
        self.route_shape = (q, k_depth, 1 + v + 3 + (0 if costs is None else 1))

        # one host-to-device copy of the packed slabs (on a process mesh,
        # this rank's), one fetch of every slab's results
        cols = [k[:, None], vv, oo[:, None], cc[:, None], od[:, None]]
        if cst is not None:
            cols.append(cst[:, None])
        x = np.concatenate(cols, axis=1)
        ve = max(v, 1)
        if self.mesh.rank is not None and self.mesh.rank < 0:
            # outside the mesh's group: no slab, the group's results
            out = torch.zeros((q, 3 + 2 * ve), dtype=torch.int32)
        else:
            if self.mesh.rank is not None:
                x = x[self.mesh.rank * q:(self.mesh.rank + 1) * q]
            x = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
            _, hit, val, served, ev_val, ev_ok = self._run(
                self._padded, x[:, :1], x[:, 1:1 + v], x[:, 1 + v], x[:, 2 + v],
                order=x[:, 3 + v], costs=None if cst is None else x[:, 4 + v])
            out = torch.cat([hit.to(torch.int32)[:, None], served.to(torch.int32)[:, None],
                             ev_ok.to(torch.int32)[:, None], val, ev_val], dim=1)
        out = gather_shards(self.mesh, out).cpu().numpy()
        hit_h, served_h, ev_ok_h = out[:, 0] != 0, out[:, 1] != 0, out[:, 2] != 0
        val_h, ev_val_h = out[:, 3:3 + ve], out[:, 3 + ve:]
        # the pre-check admits only rows that fit their per-peer buffer; a
        # violation means the host mirror and the device ranks drifted
        if not served_h[src >= 0].all():
            raise RuntimeError("client overflow: an admitted row was shed by the route")

        rows = np.nonzero(src >= 0)[0]
        idx = src[rows]
        hit_u = np.zeros(n, bool)
        hit_u[idx] = hit_h[rows]
        val_u = np.zeros((n, v), np.int32)
        if v:
            val_u[idx] = val_h[rows][:, :v]
        ev_ok_u = np.zeros(n, bool)
        ev_ok_u[idx] = ev_ok_h[rows]
        ev_val_u = np.zeros((n, v), np.int32)
        if v:
            ev_val_u[idx] = ev_val_h[rows][:, :v]
        ev_key = np.where(ev_ok_u[:, None], 0, EMPTY_KEY).astype(np.int32)
        ev_key = np.broadcast_to(ev_key, (n, self.cfg.key_planes))
        return AccessResult(hit=hit_u, value=val_u, pos=np.full(n, -1, np.int32),
                            evicted_key=ev_key, evicted_val=ev_val_u,
                            evicted_valid=ev_ok_u)

    # -- placement --------------------------------------------------------

    def _place_whole(self, order, merged, is_chain, owners, n, healthy,
                     placement, tf, shed, hot):
        """Whole-group placement (``load``/``roundrobin``) and the host shed
        pre-check: mirror the device's per-(slab, owner) rank counting in
        slab order at group granularity; a group any row of which would
        overflow its owner's depth sheds whole.  Degraded-owner groups and
        injected route failures shed the same way.  Mutates ``shed`` and
        ``hot``; returns ``(slabs, q, k_depth, counts2d)``."""
        slab_groups: list[list[list[int]]] = [[] for _ in range(self.ndev)]
        if owners is not None and placement == "load" and len(healthy) > 1:
            # greedy load-aware deal: each group on the slab where its peak
            # per-owner depth stays smallest (ties: fewer rows, then lower
            # index), under a slab row cap at the pow2 ceiling of the
            # balanced load, so q and the buffers stay an even deal's
            counts = np.zeros((self.ndev, self.ndev), np.int64)
            rows_ct = np.zeros(self.ndev, np.int64)
            balanced = (n + len(healthy) - 1) // len(healthy)
            cap_rows = 1 << max(0, balanced - 1).bit_length()
            for gk in order:
                g = merged[gk]
                gcnt = np.bincount(owners[g], minlength=self.ndev)
                touched = np.nonzero(gcnt)[0]
                if touched.size:
                    peaks = (counts[:, touched] + gcnt[touched]).max(axis=1)
                else:
                    peaks = np.zeros(self.ndev, np.int64)
                cands = [d for d in healthy if rows_ct[d] + len(g) <= cap_rows]
                if not cands:
                    cands = healthy
                best = min(cands, key=lambda d: (int(peaks[d]), int(rows_ct[d]), d))
                counts[best] += gcnt
                rows_ct[best] += len(g)
                slab_groups[best].append(g)
        else:
            for j, gk in enumerate(order):
                slab_groups[healthy[j % len(healthy)]].append(merged[gk])

        # q (and the per-peer depth) comes from the un-shed packing
        q = max(1, max(sum(len(g) for g in gs) for gs in slab_groups))
        q = 1 << (q - 1).bit_length()
        k_depth = per_peer_cap(self.cap, q, self.ndev)

        slabs: list[list[int]] = []
        counts2d = None
        dg = np.array(sorted(self.degraded), np.int64) if self.degraded else None
        if owners is not None:
            counts2d = np.zeros((self.ndev, self.ndev), np.int64)
            for di, gs in enumerate(slab_groups):
                counts = counts2d[di]          # accumulated in place
                rows: list[int] = []
                for g in gs:
                    gcnt = np.bincount(owners[g], minlength=self.ndev)
                    if dg is not None and gcnt[dg].any():
                        shed[g] = True
                        self.shed_groups += 1
                        self.degraded_sheds += 1
                        hot[dg[gcnt[dg] > 0]] = True
                        continue
                    if tf is not None and tf[2].random() < tf[1]:
                        shed[g] = True
                        self.shed_groups += 1
                        self.fault_sheds += 1
                        continue
                    if self.cap != "full" and np.any(counts + gcnt > k_depth):
                        shed[g] = True
                        self.shed_groups += 1
                        hot |= counts + gcnt > k_depth
                        continue
                    counts += gcnt
                    rows.extend(g)
                slabs.append(rows)
            self.sheds += int(shed.sum())
        else:
            slabs = [[i for g in gs for i in g] for gs in slab_groups]
        return slabs, q, k_depth, counts2d

    def _place_split(self, order, merged, is_chain, keys, owners, n,
                     healthy, tf, shed, seg, hot):
        """Greedy fragment packing (``placement="split"``): each chain
        becomes contiguous chunk-run fragments, each on the slab that
        extends the run furthest (ties: smallest per-owner peak, fewer slab
        rows, lowest index), against the per-(slab, owner) depth mirror.
        Only the un-placeable chunk suffix sheds.  Mutates ``shed``,
        ``seg`` (a fragment id per placed chain row) and ``hot``; returns
        ``(slabs, q, k_depth, counts2d)``."""
        nh = len(healthy)
        counts2d = np.zeros((self.ndev, self.ndev), np.int64)
        rows_ct = np.zeros(self.ndev, np.int64)
        balanced = (n + nh - 1) // nh
        cap_rows = 1 << max(0, balanced - 1).bit_length()
        k_depth = per_peer_cap(self.cap, cap_rows, self.ndev)
        slabs: list[list[int]] = [[] for _ in range(self.ndev)]
        next_seg = 0

        for gk in order:
            g = merged[gk]
            if tf is not None and tf[2].random() < tf[1]:
                shed[g] = True
                self.shed_groups += 1
                self.fault_sheds += 1
                continue
            if not is_chain[g[0]]:
                o = int(owners[g[0]])
                if o in self.degraded:
                    shed[g] = True
                    self.shed_groups += 1
                    self.degraded_sheds += 1
                    hot[o] = True
                    continue
                cands = [d for d in healthy
                         if counts2d[d, o] + len(g) <= k_depth
                         and rows_ct[d] + len(g) <= cap_rows]
                if not cands:
                    cands = [d for d in healthy if counts2d[d, o] + len(g) <= k_depth]
                if not cands:
                    shed[g] = True
                    self.shed_groups += 1
                    hot[o] = True
                    continue
                best = min(cands, key=lambda d: (int(counts2d[d, o]), int(rows_ct[d]), d))
                counts2d[best, o] += len(g)
                rows_ct[best] += len(g)
                slabs[best].extend(g)
                continue

            # chunk decomposition: a row's chunk is its key's first
            # occurrence (the GET island fixes the order; PUT rows pair by
            # key), so a shed boundary cuts the same suffix of both islands
            key_ord: dict[int, int] = {}
            for i in g:
                key_ord.setdefault(int(keys[i]), len(key_ord))
            nch = len(key_ord)
            ch_of = {i: key_ord[int(keys[i])] for i in g}
            ch_rows: list[list[int]] = [[] for _ in range(nch)]
            for i in g:
                ch_rows[ch_of[i]].append(i)
            ch_owner = [int(owners[ch_rows[t][0]]) for t in range(nch)]
            ch_n = [len(ch_rows[t]) for t in range(nch)]

            def extent(d, t, respect_rows):
                """Longest chunk run [t, e) that fits slab ``d``; returns
                (e, peak per-owner depth after placing it)."""
                add: dict[int, int] = {}
                radd = 0
                e = t
                while e < nch:
                    o_e = ch_owner[e]
                    if o_e in self.degraded:
                        break
                    if counts2d[d, o_e] + add.get(o_e, 0) + ch_n[e] > k_depth:
                        break
                    if respect_rows and rows_ct[d] + radd + ch_n[e] > cap_rows:
                        break
                    add[o_e] = add.get(o_e, 0) + ch_n[e]
                    radd += ch_n[e]
                    e += 1
                peak = max((int(counts2d[d, o]) + a for o, a in add.items()), default=0)
                return e, peak

            nfrag = 0
            t = 0
            while t < nch:
                if ch_owner[t] in self.degraded:
                    break                       # suffix from t sheds
                best = None
                for soft in (True, False):      # soft row cap only if stuck
                    for d in healthy:
                        e, peak = extent(d, t, soft)
                        if e == t:
                            continue
                        cand = ((-(e - t), peak, int(rows_ct[d]), d), d, e)
                        if best is None or cand[0] < best[0]:
                            best = cand
                    if best is not None:
                        break
                if best is None:
                    break                       # owner full on every slab
                _, d, e = best
                frag = [i for i in g if t <= ch_of[i] < e]
                for t2 in range(t, e):
                    counts2d[d, ch_owner[t2]] += ch_n[t2]
                rows_ct[d] += len(frag)
                seg[frag] = next_seg
                next_seg += 1
                slabs[d].extend(frag)
                nfrag += 1
                t = e
            if nfrag > 1:
                self.split_chains += 1
            if t < nch:
                rest = [i for i in g if ch_of[i] >= t]
                shed[rest] = True
                hot[ch_owner[t]] = True
                if ch_owner[t] in self.degraded:
                    self.degraded_sheds += 1
                if t == 0:
                    self.shed_groups += 1
                else:
                    self.partial_sheds += 1

        # q covers the estimate the mirror packed against and the largest
        # slab; the engine's depth only grows past the mirror's k_depth
        q = max(cap_rows, max((len(s) for s in slabs), default=1), 1)
        q = 1 << (q - 1).bit_length()
        k_depth = per_peer_cap(self.cap, q, self.ndev)
        return slabs, q, k_depth, counts2d

    def _note_pressure(self, counts2d, depth, hot) -> None:
        """Fold one call's admitted per-(slab, owner) counts into the
        per-home-shard pressure EWMA (owners in capacity or degraded sheds
        pin to 1.0) and the occupancy peak."""
        kd = max(1, int(depth))
        x = np.minimum(counts2d.max(axis=0) / kd, 1.0)
        x[hot] = 1.0
        if self.degraded:
            x[sorted(self.degraded)] = 1.0
        a = self._pressure_alpha
        self.slab_pressure = (1.0 - a) * self.slab_pressure + a * x
        self.slab_occupancy_peak = max(self.slab_occupancy_peak,
                                       float(counts2d.max() / kd))

    def home_shards(self, chain) -> np.ndarray:
        """Distinct home shards of ``chain``'s chunk hashes (sorted)."""
        h = np.asarray(list(chain), np.int32).reshape(-1)
        if h.size == 0:
            return np.zeros(0, np.int64)
        return np.unique(_host_owners(self.cfg, h, self._s_local))

    def chain_pressure(self, chain) -> float:
        """Max ``slab_pressure`` over ``chain``'s home shards: the serving
        engine's admission-throttle signal (0.0 for an empty chain)."""
        o = self.home_shards(chain)
        if o.size == 0:
            return 0.0
        return float(self.slab_pressure[o].max())

    # -- elasticity / fault tolerance -------------------------------------

    @_replayed
    def note_chain(self, chain) -> None:
        """Register a chain (chunk hashes) as live; ``reshard`` drains the
        registry in last-touch (LRU-first) order."""
        key = tuple(int(h) for h in np.asarray(chain).reshape(-1))
        if not key:
            return
        self._touch += 1
        self._chain_registry[key] = self._touch

    @_replayed
    def inject_route_failures(self, calls: int = 1, frac: float = 0.5,
                              seed: int = 0) -> None:
        """For the next ``calls`` access() calls each group sheds with
        probability ``frac`` (transient route loss), on top of the capacity
        and degraded checks."""
        self._transient_fail = [int(calls), float(frac), np.random.default_rng(seed)]

    @_replayed
    def mark_degraded(self, shard: int) -> list[int]:
        """Treat ``shard`` as lost: wipe its sets and shed every later group
        homing a chunk there (until a ``reshard``).  Returns the orphaned
        pages (value plane 0 of the shard's entries, each once).  On a
        ``ProcessCacheMesh`` the owning rank wipes its rows after handing
        them to every rank of the world, which all return the same list."""
        if not 0 <= shard < self.ndev:
            raise ValueError(f"shard {shard} outside [0, {self.ndev})")
        if shard in self.degraded:
            return []
        if len(self.degraded) + 1 >= self.ndev:
            raise RuntimeError("every shard degraded; reshard() to a live mesh")
        self.degraded.add(shard)
        kp = self.cfg.key_planes
        lo = shard * self._s_local
        hi = min((shard + 1) * self._s_local, self.cfg.num_sets)
        if self.mesh.rank is not None:
            # the owner's rows (a padded tail is EMPTY), wiped there below
            seg = self.mesh.broadcast(self._rows(), shard).cpu().numpy()
            lo, hi = 0, (self._s_local if self.mesh.rank == shard else 0)
        else:
            seg = self._padded[lo:hi].cpu().numpy()
        live = seg[:, :, 0] != EMPTY_KEY
        # each page once, first seen first: a caller releases every orphan,
        # and a split-placed chain's fragments may list one page twice
        orphans = (list(dict.fromkeys(int(p) for p in seg[:, :, kp][live]))
                   if self.cfg.value_planes else [])
        self._padded[lo:hi] = 0
        self._padded[lo:hi, :, 0] = EMPTY_KEY
        # the lost shard's buffers are gone: pin its pressure
        self.slab_pressure[shard] = 1.0
        return orphans

    def _full_engine(self):
        """A full-cap engine on the current mesh for the drain sweeps."""
        if self._full_run is None:
            self._full_run = make_sharded_engine(self.cfg, self.mesh, axis=self._axis,
                                                 cap="full", in_place=True,
                                                 **self._engine_kwargs)
        return self._full_run

    def _sweep_access(self, keys, vals, ops, chain_ids, costs=None):
        """access() with sheds disabled (full cap, no degraded shard, no
        injected fault): reshard()'s drain and re-insert sweeps.  With no
        owner mirror every chain deals whole, one segment each."""
        run, cap = self._run, self.cap
        degraded, tf = self.degraded, self._transient_fail
        self._run, self.cap = self._full_engine(), "full"
        self.degraded, self._transient_fail = set(), None
        try:
            return self.access(keys, vals, ops, chain_ids, costs=costs)
        finally:
            self._run, self.cap = run, cap
            self.degraded, self._transient_fail = degraded, tf

    @_replayed
    def reshard(self, new_ndev: int, drain_batch: int = 256) -> list[int]:
        """Live D -> D' reshard: drain every registered chain with batched
        CHAIN_GET sweeps, rebuild a cold table on ``new_ndev`` shards, and
        re-insert the surviving prefixes with CHAIN_PUT in last-touch
        order.  The rebuilt table is bit-equal to a cold sequential engine
        fed ``last_drain_stream``.  Returns the orphaned pages of entries no
        registered chain reaches (each once).

        On a ``ProcessCacheMesh`` the live map comes from the table
        gathered over the current group, the drain runs through it, and
        the table is rebuilt on the first ``new_ndev`` ranks of the world
        (grown or shrunk; past the world's size ``ValueError``)."""
        from repro_torch.launch.mesh import make_cache_mesh

        if new_ndev < 1:
            raise ValueError(f"new_ndev must be >= 1, got {new_ndev}")
        if self.mesh.rank is not None and new_ndev > self.mesh.world_size:
            raise ValueError(f"reshard to {new_ndev} shards on a world of "
                             f"{self.mesh.world_size} ranks: a running cache cannot "
                             "spawn processes")
        if self.cfg.value_planes < 1:
            raise ValueError("reshard drains (key, page) pairs; needs a value plane")
        kp = self.cfg.key_planes
        tbl = self.gathered_table()
        live = tbl[:, :, 0] != EMPTY_KEY
        live_map = {int(k): vv.astype(np.int32)
                    for k, vv in zip(tbl[live][:, 0], tbl[live][:, kp:])}
        chains = sorted(self._chain_registry, key=self._chain_registry.__getitem__)
        drained: list[tuple] = []
        reached: set[int] = set()
        batch: list[tuple] = []
        rows = 0

        def flush():
            nonlocal rows
            if not batch:
                return
            keys = np.concatenate([np.asarray(c, np.int32) for c in batch])
            ops = np.full(keys.size, OP_CHAIN_GET, np.int32)
            cids = np.concatenate([np.full(len(c), j, np.int32)
                                   for j, c in enumerate(batch)])
            hit = self._sweep_access(keys, None, ops, cids).hit
            off = 0
            for c in batch:
                h = hit[off: off + len(c)]
                off += len(c)
                hitlen = len(c) if h.all() else int(np.argmin(h))
                if hitlen:
                    drained.append(c[:hitlen])
                    reached.update(c[:hitlen])
            batch.clear()
            rows = 0

        for c in chains:
            if rows + len(c) > drain_batch and batch:
                flush()
            batch.append(c)
            rows += len(c)
        flush()
        orphans = list(dict.fromkeys(
            int(live_map[k][0]) for k in live_map if k not in reached))
        self.degraded.clear()
        self._bind_mesh(make_cache_mesh(new_ndev, device=self.device) if self.mesh.rank is None
                        else self.mesh.resized(new_ndev))
        self._padded = shard_table(init_table(self.cfg, self.device), self.mesh,
                                   self._axis, dummy=True)
        self.last_drain_stream = []
        self._chain_registry = {c: t for c, t in self._chain_registry.items()
                                if c and int(c[0]) in reached}
        batch2: list[tuple] = []
        rows = 0

        def flush2():
            nonlocal rows
            if not batch2:
                return
            keys = np.concatenate([np.asarray(c, np.int32) for c in batch2])
            planes = np.concatenate([np.stack([live_map[k] for k in c]) for c in batch2])
            # live_map rows are [value planes | cost plane]
            v = self.cfg.value_planes
            vals = planes[:, :v]
            costs = planes[:, v] if self.cfg.cost_planes else None
            ops = np.full(keys.size, OP_CHAIN_PUT, np.int32)
            cids = np.concatenate([np.full(len(c), j, np.int32)
                                   for j, c in enumerate(batch2)])
            self.last_drain_stream.append(dict(keys=keys, vals=vals, ops=ops,
                                               chain_ids=cids, costs=costs))
            self._sweep_access(keys, vals, ops, cids, costs=costs)
            batch2.clear()
            rows = 0

        for c in drained:
            if rows + len(c) > drain_batch and batch2:
                flush2()
            batch2.append(c)
            rows += len(c)
        flush2()
        return orphans

    @property
    def occupancy(self) -> float:
        """Share of live ways over the real sets (float64, as numpy's mean)."""
        return self._occupancy()

    @_replayed
    def _occupancy(self) -> float:
        live = (self.table[: self.cfg.num_sets, :, 0] != EMPTY_KEY).sum()
        return int(gather_shards(self.mesh, live[None]).sum()) / (self.cfg.num_sets
                                                                 * self.cfg.assoc)
