"""What the ranks of the port's gloo tests run, with torch and numpy only.

``repro_torch.launch.mesh.run_on_ranks`` spawns processes that import the
function they run by its module: these functions live here, apart from the
test files (which import JAX), so a rank starts with torch alone.  Each
takes plain and numpy arguments and returns numpy records.  ``run_engine``,
``run_stream`` and ``run_client`` take any cache mesh, so the parent builds
its one-process reference with the same code.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

import torch_sharded_cases as cases
from repro_torch.core import MSLRUConfig, init_table
from repro_torch.core.sharded import (ShardedCacheClient, gather_shards, make_sharded_engine,
                                      make_sharded_stream_runner, shard_table)
from repro_torch.launch.mesh import ProcessCacheMesh


def _gathered(mesh, x: torch.Tensor) -> np.ndarray:
    """Every shard's ``x`` as one numpy array (bools through int32)."""
    out = gather_shards(mesh, x.to(torch.int32) if x.dtype == torch.bool else x)
    return out.cpu().numpy().astype(bool) if x.dtype == torch.bool else out.cpu().numpy()


def _slab(mesh, x, q):
    if x is None or mesh.rank is None:
        return x
    return x[mesh.rank * q:(mesh.rank + 1) * q]


def run_engine(mesh, cfg_kw, cap, engine, batches, routed=False) -> dict:
    """``make_sharded_engine`` (``make_routed_engine`` with ``routed``) over
    ``batches`` of (keys, vals, ops, chain_ids, order, costs): every batch's
    outputs and the final table, gathered."""
    from repro_torch.core.sharded import make_routed_engine

    cfg = MSLRUConfig(**cfg_kw)
    make = make_routed_engine if routed else make_sharded_engine
    run = make(cfg, mesh, cap=cap, engine=engine)
    t = shard_table(init_table(cfg, mesh.device), mesh)
    outs = []
    for batch in batches:
        q = len(batch[0]) // mesh.ndev
        keys, vals, ops, cids, order, costs = (_slab(mesh, x, q) for x in batch)
        out = run(t, keys, vals, ops, cids, order=order, costs=costs)
        t = out[0]
        outs.append([_gathered(mesh, x) for x in out[1:]])
    return {"batches": outs, "table": _gathered(mesh, t)[: cfg.num_sets]}


def run_stream(mesh, cfg_kw, cap, batch, engine, stream) -> dict:
    """``make_sharded_stream_runner`` over ``stream`` (keys, vals, ops,
    chain_ids, costs): the gathered table and the summed counts."""
    cfg = MSLRUConfig(**cfg_kw)
    run = make_sharded_stream_runner(cfg, mesh, cap=cap, batch=batch, engine=engine)
    keys, vals, ops, cids, costs = (None if x is None else torch.from_numpy(x)
                                    for x in stream)
    t, hits, served = run(shard_table(init_table(cfg, mesh.device), mesh), keys, vals,
                          ops, cids, costs=costs)
    return {"table": _gathered(mesh, t)[: cfg.num_sets], "hits": int(hits),
            "served": int(served)}


def run_client(mesh, cap, placement, steps) -> dict:
    """``ShardedCacheClient`` through ``steps`` (``cases.drive_client``)."""
    cl = ShardedCacheClient(MSLRUConfig(**cases.CFG), mesh, cap=cap, placement=placement)
    return cases.drive_client(cl, steps, lambda c: _gathered(c.mesh, c.table))


def route_rank(engine_cases, stream_cases, client_cases) -> dict:
    """One rank of the process mesh: every case, what a process mesh
    refuses, and the mesh's exchange count."""
    mesh = ProcessCacheMesh(None, "cpu")
    rec = {"engine": [run_engine(mesh, *c) for c in engine_cases],
           "stream": [run_stream(mesh, *c) for c in stream_cases],
           "client": [run_client(mesh, *c) for c in client_cases]}
    cl = ShardedCacheClient(MSLRUConfig(**cases.CFG), mesh)
    rec["refused"] = []
    for call in (lambda: cl.mark_degraded(0), lambda: cl.reshard(1)):
        try:
            call()
        except NotImplementedError as e:
            rec["refused"].append(str(e))
    rec["exchanges"] = mesh.exchanges
    rec["rank"] = mesh.rank
    return rec


def fail_on_rank(bad: int) -> None:
    """Rank ``bad`` raises while the others wait for it in a collective."""
    if dist.get_rank() == bad:
        raise ValueError(f"rank {bad} fails on purpose")
    dist.barrier()


def compress_rank(grads, residuals, rounds: int) -> tuple:
    """``compress_tree`` of this rank's gradient tree ``rounds`` times,
    carrying the residuals: (every round's reduced tree, the residuals)."""
    from repro_torch.train.compression import compress_tree

    rank = dist.get_rank()
    g = {k: torch.from_numpy(v) for k, v in grads[rank].items()}
    r = {k: torch.from_numpy(v) for k, v in residuals[rank].items()}
    reduced = []
    for _ in range(rounds):
        out, r = compress_tree(g, None, r)
        reduced.append({k: v.numpy() for k, v in out.items()})
    return reduced, {k: v.numpy() for k, v in r.items()}


def distribute_rank(arch: str, seed: int, mesh_shape) -> dict:
    """``distribute_params`` of ``arch``'s smoke parameters on a
    ``DeviceMesh`` of ``mesh_shape`` ("data", "model"): each leaf's local
    shard against the block of the global tensor its spec gives this rank
    (a tuple entry splits a dim over its axes, the first the most
    significant).  Returns the leaves checked and sharded."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.sharding import distribute_params, param_spec, tree_key_paths
    from repro_torch.models.model import make_model

    cfg = get_config(arch, smoke=True)
    params = make_model(cfg).init(torch.Generator().manual_seed(seed))
    mesh = make_debug_mesh(mesh_shape, device_type="cpu")
    assert isinstance(mesh, DeviceMesh), mesh
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    placed = tree_key_paths(distribute_params(cfg, mesh, params))
    checked = sharded = 0
    for (path, p), (path2, d) in zip(tree_key_paths(params), placed, strict=True):
        assert path == path2, (path, path2)
        spec = param_spec(cfg, mesh, path, p)
        want = p.detach()
        for dim, e in enumerate(spec):
            if e is None:
                continue
            axes = e if isinstance(e, tuple) else (e,)
            n, idx = 1, 0
            for a in axes:
                n, idx = n * sizes[a], idx * sizes[a] + coord[a]
            size = p.shape[dim] // n
            want = want.narrow(dim, idx * size, size)
            sharded += 1
        assert torch.equal(d.to_local(), want), (path, spec, tuple(d.to_local().shape))
        checked += 1
    return {"checked": checked, "sharded_dims": sharded}
