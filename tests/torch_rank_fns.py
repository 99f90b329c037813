"""What the ranks of the port's gloo tests run, with torch and numpy only.

``repro_torch.launch.mesh.run_on_ranks`` spawns processes that import the
function they run by its module: these functions live here, apart from the
test files (which import JAX), so a rank starts with torch alone.  Each
takes plain and numpy arguments and returns numpy records.  ``run_engine``,
``run_stream`` and ``run_client`` take any cache mesh, so the parent builds
its one-process reference with the same code.
"""

from __future__ import annotations

import contextlib

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
    return cases.drive_client(cl, steps, lambda c: c.gathered_table())


def fault_calls(mesh) -> dict:
    """A client on ``mesh`` serves one chain tick of ``cases.client_steps``,
    then loses shard 0 and reshards to one shard: the orphans of each, the
    rebuilt table and the client's state."""
    cl = ShardedCacheClient(MSLRUConfig(**cases.CFG), mesh)
    _, chains, staged = next(s for s in cases.client_steps(0, mesh.ndev) if s[0] == "chains")
    keys, vals, ops, cids = cases.chain_batch(chains, staged)
    cl.access(keys, vals, ops=ops, chain_ids=cids)
    for c in chains:
        cl.note_chain(c)
    return {"degrade": cl.mark_degraded(0), "reshard": cl.reshard(1),
            "table": cl.gathered_table(), "state": cases.client_state(cl)}


def route_rank(engine_cases, stream_cases, client_cases) -> dict:
    """One rank of the process mesh: every case, ``fault_calls``, a
    reshard past the world's size (refused), and the mesh's exchange
    count."""
    mesh = ProcessCacheMesh(None, "cpu")
    rec = {"engine": [run_engine(mesh, *c) for c in engine_cases],
           "stream": [run_stream(mesh, *c) for c in stream_cases],
           "client": [run_client(mesh, *c) for c in client_cases],
           "faults": fault_calls(mesh)}
    try:
        ShardedCacheClient(MSLRUConfig(**cases.CFG), mesh).reshard(mesh.world_size + 1)
    except ValueError as e:
        rec["refused"] = str(e)
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


# ---------------------------------------------------------------------------
# The sharded step (test_torch_sharded_step.py): one record per (arch, mesh),
# made by the same code in the parent (mesh None: one device) and on the ranks
# ---------------------------------------------------------------------------

STEP_S = 32
# rows per train step by microbatches: every microbatch is 4 rows (one per
# rank of a 4-wide data axis), so both steps run ops of the same shapes,
# whose DTensor sharding plans (the costly part of a rank's first step)
# are then made once
TRAIN_ROWS = {1: 4, 2: 8}
STEP_B = 4                             # prefill and decode rows
PROMPT, MAX_LEN, DECODE_STEPS = 16, 32, 3


def step_batch(cfg, rows: int, seed: int = 0) -> dict:
    """A train batch, numpy: tokens and labels (rows, S), Whisper's frames."""
    rng = np.random.default_rng(seed)
    t = rng.integers(0, cfg.vocab_size, (rows, STEP_S + 1)).astype(np.int32)
    b = {"tokens": t[:, :-1], "labels": t[:, 1:]}
    if cfg.enc_dec:
        b["frames"] = rng.standard_normal((rows, cfg.enc_len, cfg.d_model)).astype(np.float32)
    return b


def prompt_batch(cfg, seed: int = 1) -> dict:
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (STEP_B, PROMPT)).astype(np.int32)}
    if cfg.enc_dec:
        b["frames"] = rng.standard_normal((STEP_B, cfg.enc_len, cfg.d_model)).astype(np.float32)
    return b


def params_numpy(params) -> dict:
    """A ``ParamTree``'s leaves by name as (f32 numpy, dtype name)."""
    return {n: (p.detach().float().numpy(), str(p.dtype).removeprefix("torch."))
            for n, p in params.named_parameters()}


def params_of(model, values: dict):
    """``model``'s parameters on the CPU with ``params_numpy``'s values."""
    params = model.init(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for n, p in params.named_parameters():
            p.copy_(torch.from_numpy(values[n][0]).to(getattr(torch, values[n][1])))
    return params


def _full(x) -> np.ndarray:
    x = x.detach()
    x = x.full_tensor() if hasattr(x, "full_tensor") else x
    return x.float().numpy()


class _Routing:
    """``moe.route`` recording its probabilities and own choices (full,
    call by call) and, with ``impose``, taking those choices instead (the
    gates from its own probabilities), as the JAX-held tests impose JAX's."""

    def __init__(self, impose=None):
        from repro_torch.models import moe

        self.moe, self.route, self.impose, self.log = moe, moe.route, impose, []

    def __enter__(self):
        self.moe.route = self._route
        return self

    def __exit__(self, *exc):
        self.moe.route = self.route

    def _route(self, params, x, top_k):
        logits, probs, gate_v, own = self.route(params, x, top_k)
        self.log.append((_full(probs), _full(own).astype(np.int64)))
        if self.impose is None:
            return logits, probs, gate_v, own
        gi = torch.from_numpy(self.impose[len(self.log) - 1])
        if hasattr(own, "placements"):
            from repro_torch.launch.sharding import distribute_tree

            gi = distribute_tree(own.device_mesh, gi, _spec_of(own))
        gv = probs.gather(-1, gi)
        return logits, probs, gv / torch.clamp(gv.sum(-1, keepdim=True), min=1e-9), gi


def _spec_of(x) -> tuple:
    """A DTensor's placements as a spec (each tensor dim: its mesh axes)."""
    names = x.device_mesh.mesh_dim_names
    spec = [[] for _ in range(x.dim())]
    for name, p in zip(names, x.placements):
        if p.is_shard():
            spec[p.dim].append(name)
    return tuple(None if not e else e[0] if len(e) == 1 else tuple(e) for e in spec)


def _install(cache, pcache):
    """prefill's cache into ``init_cache``'s, at its leading positions."""
    if isinstance(cache, dict):
        for k in cache:
            _install(cache[k], pcache[k])
    elif cache.shape == pcache.shape:
        cache.copy_(pcache)
    else:
        cache[:, :, :pcache.shape[2]] = pcache


class _UpdateInputs:
    """``optimizer.adamw_update`` keeping the gradients that reach it (the
    step's own tensors, call by call; read them after the step, so that
    reading a DTensor's in full adds no collective to the step)."""

    def __init__(self):
        from repro_torch.train import optimizer as opt_mod

        self.opt, self.update, self.grads = opt_mod, opt_mod.adamw_update, []

    def __enter__(self):
        self.opt.adamw_update = self._update
        return self

    def __exit__(self, *exc):
        self.opt.adamw_update = self.update

    def _update(self, grads, *args, **kw):
        self.grads.append(dict(self.opt.leaves(grads)))
        return self.update(grads, *args, **kw)


def redo_update(arch: str, values: dict, rec: dict) -> dict:
    """The one-device AdamW update of ``arch``'s smoke parameters
    ``values`` on a train record's own gradients, with its own global norm
    (a mesh sums the squares in another order) and ``build_train_step``'s
    schedule: the parameters, master, m and v the record must hold, by name,
    and the learning rate."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.model import make_model
    from repro_torch.train import optimizer as opt_mod

    params = params_of(make_model(get_config(arch, smoke=True)), values)
    kw = build_train_step.__kwdefaults__
    norm = torch.tensor(rec["metrics"]["grad_norm"], dtype=torch.float32)
    global_norm, opt_mod.global_norm = opt_mod.global_norm, lambda tree: norm
    try:
        _, st, stats = opt_mod.adamw_update(
            {n: torch.from_numpy(g) for n, g in rec["grads"].items()}, opt_mod.adamw_init(params),
            params, lr_fn=opt_mod.cosine_schedule(kw["lr"], kw["warmup"], kw["total_steps"]))
    finally:
        opt_mod.global_norm = global_norm
    return {"params": {n: _full(p) for n, p in params.named_parameters()},
            "master": {n: _full(x) for n, x in st.master.items()},
            "m": {n: _full(x) for n, x in st.m.items()},
            "v": {n: _full(x) for n, x in st.v.items()}, "lr": float(stats["lr"])}


def _full_tree(t):
    return {k: _full_tree(v) for k, v in t.items()} if isinstance(t, dict) else \
        (t.full_tensor() if hasattr(t, "full_tensor") else t)


def run_steps(arch: str, values: dict, mesh_shape=None, impose=None, feed=None,
              staged: bool = False, train_rows=None, axes=None, serve: bool = True) -> dict:
    """``_run_steps``; with ``staged``, its collectives through
    ``HostStagedCollectives`` (on the CPU here: the transport gloo ranks on
    one card use), which also counts them."""
    if not staged:
        return _run_steps(arch, values, mesh_shape, impose, feed, train_rows, axes, serve)
    from repro_torch.launch.mesh import HostStagedCollectives

    with HostStagedCollectives("CPU") as st:
        rec = _run_steps(arch, values, mesh_shape, impose, feed, train_rows, axes, serve)
    rec["staged_calls"] = st.calls
    return rec


def _run_steps(arch: str, values: dict, mesh_shape=None, impose=None, feed=None,
               train_rows=None, axes=None, serve: bool = True) -> dict:
    """``arch``'s smoke config with the parameters ``values``
    (``params_numpy``) on a ``DeviceMesh`` of ``mesh_shape`` over ``axes``
    (default (data, model); None: one device, no mesh): one train step at
    each microbatch count of ``train_rows`` (microbatches: rows; default
    TRAIN_ROWS) (metrics, the f32 gradients that reached AdamW, the
    updated parameters, master, m and v, all in full), ``prefill_step`` over
    ``prompt_batch`` (logits), then DECODE_STEPS serve steps (logits bundle
    and greedy bundle on twin caches) fed ``feed``'s tokens (None: the
    prompt's greedy token, then each step's; the record's ``fed``).
    ``impose``: MoE routing choices by call (``_Routing``); ``serve``
    False stops after the train steps.
    On a mesh the record adds, per train step, the leaves whose local shard
    is not the shape ``param_placements`` gives, and this rank's own copies
    of the replicated leaves (parameter, master, m and v)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.steps import (build_prefill_step, build_serve_step,
                                          build_train_step, place_params)
    from repro_torch.models.model import make_model
    from repro_torch.train.optimizer import adamw_init

    cfg = get_config(arch, smoke=True)
    model = make_model(cfg)
    mesh = None if mesh_shape is None else make_debug_mesh(
        mesh_shape, axes or ("data", "model"), device_type="cpu")

    def placed():
        p = params_of(model, values)
        return p if mesh is None else place_params(cfg, mesh, p)

    def rows(batch, b=STEP_B):
        batch = {k: torch.from_numpy(v) for k, v in batch.items()}
        return batch if mesh is None else shd.local_batch(mesh, batch, b)

    rec = {"train": {}, "routing": {}}
    with _Routing(None if impose is None else impose.get("train")) as routing, \
            _UpdateInputs() as seen:
        for a, b in (train_rows or TRAIN_ROWS).items():
            bundle = build_train_step(model, ShapeSpec("s", STEP_S, b, "train"), mesh=mesh,
                                      microbatches=a)
            params = placed()
            opt = adamw_init(params)
            params, opt, metrics = bundle.fn(params, opt, rows(step_batch(cfg, b), b))
            r = {"metrics": {k: float(v) for k, v in metrics.items()},
                 "grads": {n: _full(g) for n, g in seen.grads[-1].items()},
                 "params": {n: _full(p) for n, p in params.named_parameters()},
                 **{k: {n: _full(x) for n, x in getattr(opt, k).items()}
                    for k in ("master", "m", "v")}}
            if mesh is not None:
                r["bad_shards"] = _bad_shards(cfg, mesh, model, params)
                r["replicated"] = {
                    n: {"params": _full(p.to_local()),
                        **{k: _full(getattr(opt, k)[n].to_local()) for k in ("master", "m", "v")}}
                    for n, p in params.named_parameters()
                    if all(q.is_replicate() for q in p.placements)}
            rec["train"][a] = r
    rec["routing"]["train"] = routing.log

    if not serve:                       # the train steps only
        return rec
    pshape = ShapeSpec("p", PROMPT, STEP_B, "prefill")
    dshape = ShapeSpec("d", MAX_LEN, STEP_B, "decode")
    params = placed()
    with torch.no_grad(), _Routing(None if impose is None else impose.get("serve")) as routing:
        logits, pcache = build_prefill_step(model, pshape, mesh=mesh).fn(params,
                                                                       rows(prompt_batch(cfg)))
        rec["prefill"] = _full(logits)
        caches = []
        for _ in range(2):
            cache = model.init_cache(STEP_B, MAX_LEN, device="cpu")
            _install(cache, _full_tree(pcache))
            if mesh is not None:
                cache = shd.distribute_tree(mesh, cache,
                                            shd.cache_shardings(cfg, mesh, cache, STEP_B))
            caches.append(cache)
        sb = build_serve_step(model, dshape, mesh=mesh)
        gb = build_serve_step(model, dshape, mesh=mesh, greedy=True)
        tok = np.argmax(rec["prefill"], -1).astype(np.int32)
        rec["logits"], rec["greedy"], rec["fed"] = [], [], []
        for i in range(DECODE_STEPS):
            if feed is not None:
                tok = feed[i]
            rec["fed"].append(tok)
            t_in = rows({"t": tok[:, None]})["t"]
            lg, caches[0] = sb.fn(params, t_in, caches[0], PROMPT + i)
            g, caches[1] = gb.fn(params, t_in, caches[1], PROMPT + i)
            rec["logits"].append(_full(lg))
            rec["greedy"].append(_full(g).astype(np.int32))
            tok = rec["greedy"][-1]
    rec["routing"]["serve"] = routing.log
    return rec


def _bad_shards(cfg, mesh, model, params) -> list:
    """The leaves whose placements or local shard shape are not those their
    spec gives (``param_spec``, ``placements``, ``local_shard``)."""
    from repro_torch.configs.specs import abstract_params
    from repro_torch.launch.sharding import local_shard, param_spec, placements, tree_key_paths

    bad = []
    for (n, p), (path, leaf) in zip(params.named_parameters(),
                                    tree_key_paths(abstract_params(model)), strict=True):
        want = placements(param_spec(cfg, mesh, path, leaf), mesh)
        if tuple(p.placements) != want or \
                p.to_local().shape != local_shard(leaf, mesh, want).shape:
            bad.append(n)
    return bad


CKPT_ARGS = ["--arch", "phi3-mini-3.8b", "--smoke", "--seq-len", "32", "--global-batch", "4",
             "--steps", "10", "--device", "cpu"]


def _trainer(mesh, ckpt_dir=None):
    from repro_torch.launch import train

    args = CKPT_ARGS + (["--ckpt-dir", str(ckpt_dir)] if ckpt_dir else [])
    return train.build(train.parser().parse_args(args), mesh=mesh)


def trainer_state(tr) -> dict:
    """A trainer's parameters and AdamW state in full, by checkpoint key."""
    from repro_torch.train import checkpoint as ckpt_mod

    return ckpt_mod._host({"params": tr.params, "opt": tr.opt_state})[0]


def trainer_step(tr, data) -> dict:
    """One more step of ``tr``: its loss and norm, the full state after."""
    h = tr.run(data, 1, log_every=1)[-1]
    return {"loss": h["loss"], "grad_norm": h["grad_norm"], "state": trainer_state(tr)}


def resume(tr, ckpt_dir, step: int):
    """``tr`` (a fresh state) restored from ``ckpt_dir``'s step ``step``."""
    from repro_torch.train import checkpoint as ckpt_mod

    tr.init_state(resume=False)
    _, tr.step = ckpt_mod.restore(ckpt_dir, {"params": tr.params, "opt": tr.opt_state}, step)
    return tr


def checkpoint_rank(one_device_dir: str, sharded_dir: str) -> dict:
    """The launcher's trainer on a (2, 2) mesh (phi3-smoke, CKPT_ARGS): two
    steps with a checkpoint after each under ``sharded_dir`` (the state
    after step 1 in full, then step 2: the run that never stopped); a fresh
    sharded trainer resumed from ``sharded_dir``'s step 1, and one from
    ``one_device_dir``'s step 1 (a one-device run's), each one step on."""
    from repro_torch.launch.mesh import make_debug_mesh

    mesh = make_debug_mesh((2, 2), device_type="cpu")
    tr, data = _trainer(mesh, sharded_dir)
    tr.init_state(resume=False)
    tr.run(data, 1, log_every=1)
    rec = {"after_1": trainer_state(tr), "never_stopped": trainer_step(tr, data)}
    rec["resumed_sharded"] = trainer_step(resume(_trainer(mesh)[0], sharded_dir, 1), data)
    rec["resumed_one_device"] = trainer_step(resume(_trainer(mesh)[0], one_device_dir, 1), data)
    return rec


def sharded_step_rank(cases, one_device_dir=None, sharded_dir=None) -> dict:
    """One rank of a sharded-step test file: ``run_steps(*case)`` for each
    case, then (with the directories) ``checkpoint_rank``."""
    out = {"cases": [run_steps(*c) for c in cases]}
    if one_device_dir is not None:
        out["ckpt"] = checkpoint_rank(one_device_dir, sharded_dir)
    return out


# ---------------------------------------------------------------------------
# faults across processes: resharding, the client under faults, serving
# ---------------------------------------------------------------------------

def reshard_rank(pairs, seeds, engine: str = "onepass") -> dict:
    """One rank of a world that runs every (D, D') pair in turn, each from
    a client on the first D ranks: ``cases.drive_reshard`` per seed, with
    the client's ``s_local``, mesh rank and state after it; then a reshard
    past the world's size (refused)."""
    rec = {}
    for d, dp in pairs:
        for seed in seeds:
            cl = ShardedCacheClient(MSLRUConfig(**cases.RESHARD_CFG),
                                    ProcessCacheMesh(d, "cpu"), engine=engine)
            r = cases.drive_reshard(cl, seed, dp, lambda c: c.gathered_table())
            r.update(s_local=cl._s_local, mesh_rank=cl.mesh.rank,
                     state=cases.client_state(cl))
            rec[(d, dp, seed)] = r
    try:
        ShardedCacheClient(MSLRUConfig(**cases.RESHARD_CFG), ProcessCacheMesh(None, "cpu")
                           ).reshard(dist.get_world_size() + 1)
    except ValueError as e:
        rec["refused"] = str(e)
    return rec


def faults_rank(client_cases, lead: bool = False) -> list:
    """``cases.drive_client`` of each (cap, placement, steps) case on a
    client over every rank of the world: each rank driving its own client
    (SPMD), or with ``lead`` rank 0 driving inside ``leading()`` while the
    others ``follow()``.  Each case's record (a follower: its call count)
    and the client's state."""
    mesh = ProcessCacheMesh(None, "cpu")
    out = []
    for cap, placement, steps in client_cases:
        cl = ShardedCacheClient(MSLRUConfig(**cases.CFG), mesh, cap=cap, placement=placement)
        if lead and dist.get_rank():
            out.append({"calls": cl.follow()})
        else:
            with cl.leading() if lead else contextlib.nullcontext():
                out.append({"record": cases.drive_client(cl, steps,
                                                         lambda c: c.gathered_table())})
        out[-1]["state"] = cases.client_state(cl)
    return out


def serve_case_rank(case, params_np) -> dict:
    """One of ``cases.SERVE_CASES`` with the cache over every rank of the
    world: rank 0 serves phi3-mini-smoke (``params_np``, the JAX
    parameters as numpy) leading the client, the others follow.  Rank 0
    returns ``cases.summary``; every rank its client's state."""
    from repro_torch.configs import get_config
    from repro_torch.core import params_from_numpy
    from repro_torch.launch import elastic
    from repro_torch.models.model import make_model
    from repro_torch.serving.engine import Request, ServeEngine
    from repro_torch.serving.kv_cache import PagedKVPool
    from repro_torch.serving.prefix_cache import PrefixCache

    eng_kw, be_kw, plan = case
    be = ShardedCacheClient(MSLRUConfig(**cases.BACKEND_CFG), ProcessCacheMesh(None, "cpu"),
                            **be_kw)
    if dist.get_rank():
        return {"calls": be.follow(), "state": cases.client_state(be)}
    cfg = get_config(cases.ARCH, smoke=True)
    params = params_from_numpy(params_np, cfg, device="cpu")
    pc = PrefixCache(chunk_tokens=16, backend=be)
    pool = PagedKVPool(cfg, n_pages=cases.N_PAGES, page_tokens=16, device="cpu")
    eng = ServeEngine(make_model(cfg), params, prefix_cache=pc, pool=pool, **cases.ENGINE,
                      **eng_kw)
    for i, p in enumerate(cases.prompts(cfg)):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=cases.MAX_NEW))
    with be.leading():
        eng.run_until_done(fault_plan=cases.fault_plan(elastic.FaultEvent, elastic.FaultPlan,
                                                       plan))
        summary = cases.summary(eng, be.gathered_table())
    summary["rest"]["finished"] = len(eng.finished)
    return {"summary": summary, "state": cases.client_state(be)}


def staggered_rank(delays, out_dir) -> list:
    """Three objects shared from world rank 0 over a ``ProcessCacheMesh``
    of the world (which caches the world group in ``launch.mesh``), then a
    return after this rank's delay, ``delays[rank]`` seconds.  At
    interpreter exit the rank writes the names of the native threads it
    still has to ``out_dir/rank<r>.txt``.  Returns what it was shared."""
    import atexit
    import os
    import time

    rank = dist.get_rank()

    def note_threads():
        names = []
        for t in os.listdir("/proc/self/task"):
            try:
                with open(f"/proc/self/task/{t}/comm") as f:
                    names.append(f.read().strip())
            except OSError:
                pass
        with open(os.path.join(out_dir, f"rank{rank}.txt"), "w") as f:
            f.write("\n".join(names))

    atexit.register(note_threads)
    mesh = ProcessCacheMesh(None, "cpu")
    got = [mesh.share_object(("call", i) if rank == 0 else None) for i in range(3)]
    time.sleep(delays[rank])
    return got
