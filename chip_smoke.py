#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the multi-step LRU cache on one NVIDIA GPU.

Run from the root of a checkout, with one card visible:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. the card: ``torch.cuda.is_available()``; name and power limit;
2. build both CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc;
3. the access kernel against its plain version at B = 8192 on eight
   geometries, with no opcodes, mixed opcodes and a chain execute mask;
4. the one-pass kernel against its plain version on four Zipf batches of
   the main configuration over a warmed table, then the opcode, chain and
   cost variants on small configurations;
5. the main path: ``MultiStepLRUCache(device=DEVICE)`` with 2**21 sets of
   M=2 x P=4 ways, 32-bit keys and 64-bit values (C = 3 planes, 201 MB),
   fed a scrambled YCSB Zipf 0.99 stream over 100M keys of twice the
   capacity in 8192-query batches; the first half warms, the second half
   is timed; the profiler splits a batch's device time by kernel.  Then
   the one-pass engine against the rounds engine (the access kernel) on
   four batches past the stream, and against ``access_seq`` on a
   4096-query prefix of a small configuration;
6. each kernel's launches on the path that runs it (the one-pass stream
   for the one-pass kernel, the rounds cross-check for the access kernel),
   its time per launch, its plain version's time and its bound, as one
   JSON line.

Every comparison is bit-exact (all state is int32).  The last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate
# No int32 entry in the published tables: Hopper issues 64 int32
# operations per clock per SM; 132 SMs at 1.98 GHz.
INT32_OPS_PER_S = 64 * 132 * 1.98e9
DEVICE = "cuda"
MAIN_SETS = 2**21
BATCH = 8192
WARM_BATCHES = 512          # phase 4 warms its table on this many batches
CHECK_BATCHES = 4           # batches after the stream for the engine cross-check
N_KEYS = 100_000_000
ZIPF_ALPHA = 0.99
SEED = 0
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/msl_cache.cu"


def log(*args):
    print(*args, flush=True)


def phase(name):
    log(f"== {name}")


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------

def random_rows_case(torch, cfg, b, gen):
    """Random gathered rows and queries: distinct keys per row, a quarter of
    the lanes empty, half the queries a key of their own row, opcodes,
    chain execute mask and costs at random (costs tie often)."""
    from repro_torch.core import EMPTY_KEY

    dev = DEVICE
    a, c, kp, v = cfg.assoc, cfg.planes, cfg.key_planes, cfg.value_planes

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    rows = ints(-1000, 1000, (b, a, c))
    lane_keys = torch.arange(a, device=dev, dtype=torch.int32) * 100_003
    keys = lane_keys + ints(1, 100_000, (b, a))
    empty = torch.rand((b, a), generator=gen, device=dev) < 0.25
    rows[:, :, 0] = torch.where(empty, EMPTY_KEY, keys)
    if cfg.cost_planes:
        rows[:, :, -1] = ints(0, 3, (b, a))
    lane = torch.randint(0, a, (b,), generator=gen, device=dev)
    own = rows[torch.arange(b, device=dev), lane, :kp]
    fresh = torch.cat([ints(200_000, 300_000, (b, 1)), ints(0, 50, (b, kp - 1))], 1)
    use_own = (torch.rand((b,), generator=gen, device=dev) < 0.5) & (own[:, 0] != EMPTY_KEY)
    qk = torch.where(use_own[:, None], own, fresh).contiguous()
    qv = ints(-500, 500, (b, v))
    ops = ints(0, 6, (b,))
    live = ints(0, 2, (b,))
    costs = ints(0, 5, (b,))
    return rows, qk, qv, ops, live, costs


def max_abs_err(torch, want, got):
    err = 0
    for w, g in zip(want, got):
        if w.shape != g.shape:
            raise AssertionError(f"shape {tuple(g.shape)} != {tuple(w.shape)}")
        if w.numel():
            err = max(err, int((w.to(torch.int64) - g.to(torch.int64)).abs().max()))
    return err


def time_ms(torch, fn, reps):
    """Mean device time of ``fn()`` over ``reps`` calls, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profile_kernels(torch, fn, reps):
    """Device kernels of ``reps`` calls of ``fn()`` (after one warm-up call),
    from the CUDA profiler: {kernel name: [total µs, launches]}."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            k = kernels.setdefault(e.name, [0.0, 0])
            k[0] += e.time_range.elapsed_us()
            k[1] += 1
    return kernels


def kernel_ms(torch, fn, reps, name):
    """Device ms per launch of the kernel whose name contains ``name``, from
    the profiler; raises when the profiler saw no launch of it."""
    hits = [v for n, v in profile_kernels(torch, fn, reps).items() if name in n]
    if not hits:
        raise AssertionError(f"the profiler recorded no launch of {name}")
    return sum(v[0] for v in hits) / sum(v[1] for v in hits) / 1e3


def max_chain_per_batch(torch, cfg, keys):
    """Longest same-set chain of each BATCH-query batch of ``keys``."""
    from repro_torch.core import set_index_for

    sids = set_index_for(cfg, keys[:, None]).view(-1, BATCH)
    s = torch.sort(sids, dim=1).values
    idx = torch.arange(BATCH, device=keys.device).expand_as(s)
    firsts = torch.ones_like(s, dtype=torch.bool)
    firsts[:, 1:] = s[:, 1:] != s[:, :-1]
    start = torch.cummax(torch.where(firsts, idx, 0), dim=1).values
    return ((idx - start).max(dim=1).values + 1).cpu()


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

GEOMS = [  # (m, p, key_planes, value_planes, policy, cost_planes)
    (2, 4, 1, 2, "multistep", 0),
    (1, 4, 1, 1, "multistep", 0),
    (4, 2, 2, 2, "multistep", 0),
    (2, 8, 1, 0, "multistep", 0),
    (1, 8, 1, 2, "multistep", 0),
    (2, 4, 1, 2, "set_lru", 0),
    (8, 4, 2, 3, "multistep", 0),
    (2, 4, 1, 2, "multistep", 1),
]


def check_access_kernel(torch):
    from repro_torch.core import MSLRUConfig
    from repro_torch.kernels.msl_cache import msl_access_kernel_call, msl_access_plain

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    worst = 0
    for m, p, kp, v, policy, cost in GEOMS:
        cfg = MSLRUConfig(num_sets=64, m=m, p=p, key_planes=kp, value_planes=v,
                          cost_planes=cost, policy=policy)
        rows, qk, qv, ops, live, costs = random_rows_case(torch, cfg, BATCH, gen)
        for variant, extra in (("access", (None, None, costs if cost else None)),
                               ("mixed_ops", (ops, None, costs)),
                               ("chain_live", (ops, live, costs))):
            args = (rows, qk, qv, *extra)
            got = msl_access_kernel_call(*args, cfg=cfg)
            want = msl_access_plain(*args, cfg=cfg)
            err = max_abs_err(torch, want, got)
            worst = max(worst, err)
            if err:
                raise AssertionError(f"msl_access {cfg} {variant}: max |err| {err}")
        log(f"msl_access == plain: m={m} p={p} kp={kp} v={v} {policy} cost={cost} "
            "(access, mixed_ops, chain_live)")
    return worst


def onepass_case(torch, cfg, padded, keys, vals, ops=None, live=None, costs=None):
    from repro_torch.core import set_index_for
    from repro_torch.kernels.ops import onepass_prologue

    sids = set_index_for(cfg, keys)
    valid = torch.ones(sids.shape, dtype=torch.bool, device=keys.device)
    return onepass_prologue(padded, sids, valid, keys, vals, ops=ops,
                            chain_live=live, costs=costs)


def check_onepass(torch, cfg, x):
    from repro_torch.kernels.msl_cache import chain_resolve_plain, msl_onepass_kernel_call

    got = msl_onepass_kernel_call(*x.kernel_args(), cfg=cfg)
    want = chain_resolve_plain(*x.kernel_args(), cfg=cfg)
    err = max_abs_err(torch, want, got)
    if err:
        raise AssertionError(f"msl_onepass {cfg}: max |err| {err}")
    return err


def check_onepass_kernel(torch, cfg, keys, vals):
    """Phase 4.  Returns (max |err|, the last compared batch's one-pass
    inputs, and the access kernel's inputs for the same batch: the rows
    the rounds engine's first round gathers)."""
    from repro_torch.core import MSLRUConfig, MultiStepLRUCache, set_index_for

    warm = MultiStepLRUCache(cfg, device=DEVICE)
    for i in range(WARM_BATCHES):
        q = slice(i * BATCH, (i + 1) * BATCH)
        warm.access(keys[q], vals[q])
    log(f"warmed a main-configuration table on {WARM_BATCHES} batches: occupancy "
        f"{warm.occupancy:.4f}")
    worst = 0
    for i in range(WARM_BATCHES, WARM_BATCHES + 4):
        q = slice(i * BATCH, (i + 1) * BATCH)
        qk = keys[q, None]
        x = onepass_case(torch, cfg, warm._padded, qk, vals[q])
        worst = max(worst, check_onepass(torch, cfg, x))
        log(f"msl_onepass == plain: main configuration, batch {i}, "
            f"max chain {int(x.rank.max()) + 1}")
        access_inputs = (warm.table[set_index_for(cfg, qk).long()], qk, vals[q])
        warm.access(keys[q], vals[q])
    onepass_inputs = x
    del warm

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    for kw in (dict(num_sets=64, m=2, p=4, value_planes=2, cost_planes=1),
               dict(num_sets=64, m=2, p=2, key_planes=2, value_planes=1),
               dict(num_sets=32, m=4, p=2, value_planes=0, policy="set_lru",
                    cost_planes=1)):
        small = MSLRUConfig(**kw)
        table = torch.cat([random_rows_case(torch, small, small.num_sets, gen)[0],
                           torch.zeros((1, small.assoc, small.planes), dtype=torch.int32,
                                       device=DEVICE)])
        _, qk, qv, ops, live, costs = random_rows_case(torch, small, BATCH, gen)
        qk[:, 0] = torch.where(qk[:, 0] > 100_000, qk[:, 0] % 500 + 1, qk[:, 0])
        for extra in ((None, None, costs if small.cost_planes else None),
                      (ops, None, costs), (ops, live, costs)):
            x = onepass_case(torch, small, table, qk, qv, *extra)
            worst = max(worst, check_onepass(torch, small, x))
        log(f"msl_onepass == plain: {kw} (access, mixed_ops, chain_live)")
    return worst, onepass_inputs, access_inputs


def zero_launches():
    from repro_torch.kernels import msl_cache

    for name in msl_cache.LAUNCHES:
        msl_cache.LAUNCHES[name] = 0


def read_launches():
    from repro_torch.kernels import msl_cache

    return dict(msl_cache.LAUNCHES)


def run_main_path(torch, cfg, keys, vals):
    """Phase 5.  Returns the summary dict.  Launches are counted on two
    paths, each from zero just before it to just after it: the one-pass
    stream (the main path) and the rounds engine's cross-check, the path
    that runs the access kernel."""
    from repro_torch.core import MSLRUConfig, MultiStepLRUCache

    n_batches = keys.numel() // BATCH - CHECK_BATCHES
    half = n_batches // 2
    cache = MultiStepLRUCache(cfg, device=DEVICE)
    zero_launches()

    t0 = time.perf_counter()
    for i in range(half):
        q = slice(i * BATCH, (i + 1) * BATCH)
        cache.access(keys[q], vals[q])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    hits = torch.zeros((), dtype=torch.int64, device=DEVICE)
    evictions = torch.zeros((), dtype=torch.int64, device=DEVICE)
    for i in range(half, n_batches):
        q = slice(i * BATCH, (i + 1) * BATCH)
        res = cache.access(keys[q], vals[q])
        hits += res.hit.sum()
        evictions += res.evicted_valid.sum()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    timed_queries = (n_batches - half) * BATCH
    stream_launches = read_launches()
    occupancy = cache.occupancy
    log(f"warm half: {half} batches in {t1 - t0:.3f} s")
    breakdown = device_breakdown(torch, cache, keys, vals, half,
                                 1e3 * (t2 - t1) / (n_batches - half))

    # one-pass against the rounds engine (the access kernel) on the batches
    # after the stream, which neither cache has seen
    rounds = MultiStepLRUCache(cfg, engine="rounds", device=DEVICE)
    rounds.load_table(cache.table)
    onepass_hits = 0
    zero_launches()
    for i in range(n_batches, n_batches + CHECK_BATCHES):
        q = slice(i * BATCH, (i + 1) * BATCH)
        a = cache.access(keys[q], vals[q])
        b = rounds.access(keys[q], vals[q])
        for f in a._fields:
            if not torch.equal(getattr(a, f), getattr(b, f)):
                raise AssertionError(f"one-pass != rounds: {f}, batch {i}")
        stored = a.value[a.hit]
        expect = vals[q][a.hit]
        if not torch.equal(stored, expect):
            raise AssertionError("a hit returned a value not stored for its key")
        onepass_hits += int(a.hit.sum())
    rounds_launches = read_launches()
    if not torch.equal(cache.table, rounds.table):
        raise AssertionError("one-pass and rounds tables differ")
    log(f"one-pass == rounds (access kernel) on {CHECK_BATCHES} new batches: "
        f"results and table bit-equal; values of {onepass_hits} hits intact")
    del rounds

    # one-pass against the sequential oracle on a small configuration
    small = MSLRUConfig(num_sets=256, m=2, p=4, value_planes=2)
    seq = MultiStepLRUCache(small, device=DEVICE)
    one = MultiStepLRUCache(small, device=DEVICE)
    prefix_k, prefix_v = keys[:4096], vals[:4096]
    want = seq.access_seq(prefix_k, prefix_v)
    got = [one.access(prefix_k[i:i + 1024], prefix_v[i:i + 1024])
           for i in range(0, 4096, 1024)]
    for f in ("hit", "pos", "evicted_key", "evicted_val", "evicted_valid"):
        if not torch.equal(torch.cat([getattr(r, f) for r in got]), getattr(want, f)):
            raise AssertionError(f"one-pass != access_seq: {f}")
    if not torch.equal(one.table, seq.table):
        raise AssertionError("one-pass and sequential tables differ")
    log(f"one-pass == access_seq on a 4096-query prefix ({small.num_sets} sets): "
        f"{int(want.hit.sum())} hits, {int(want.evicted_valid.sum())} evictions, "
        "tables bit-equal")

    chains = max_chain_per_batch(torch, cfg, keys[half * BATCH:n_batches * BATCH])
    seconds = t2 - t1
    summary = {
        "config": {"num_sets": cfg.num_sets, "m": cfg.m, "p": cfg.p,
                   "key_planes": cfg.key_planes, "value_planes": cfg.value_planes,
                   "table_bytes": cfg.capacity * cfg.planes * 4,
                   "n_keys": N_KEYS, "zipf_alpha": ZIPF_ALPHA, "batch": BATCH,
                   "queries": n_batches * BATCH},
        "timed_queries": timed_queries,
        "seconds": seconds,
        "qps": timed_queries / seconds,
        "ms_per_batch": 1e3 * seconds / (n_batches - half),
        "hit_ratio": int(hits) / timed_queries,
        "evictions": int(evictions),
        "occupancy": occupancy,
        "max_chain_mean": float(chains.float().mean()),
        "max_chain_min": int(chains.min()),
        "max_chain_max": int(chains.max()),
        "launches_stream": stream_launches,
        "launches_rounds_check": rounds_launches,
        "device": breakdown,
    }
    if not 0.0 < summary["hit_ratio"] < 1.0 or not 0.0 < occupancy <= 1.0:
        raise AssertionError(f"implausible main-path result: {summary}")
    if stream_launches["msl_onepass"] == 0:
        raise AssertionError("msl_onepass was not launched on the main path")
    if rounds_launches["msl_access"] == 0:
        raise AssertionError("msl_access was not launched by the rounds engine")
    del cache
    return summary


def device_breakdown(torch, cache, keys, vals, first, wall_ms_per_batch, n=16):
    """Where a main-path batch's device time goes: the profiler's kernels
    over ``n`` batches of ``cache.access`` (re-run from batch ``first``),
    per batch, against the timed window's wall time per batch."""
    def run():
        for i in range(first, first + n):
            q = slice(i * BATCH, (i + 1) * BATCH)
            cache.access(keys[q], vals[q])

    kernels = profile_kernels(torch, run, 1)
    busy_ms = sum(v[0] for v in kernels.values()) / n / 1e3
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
    out = {
        "busy_ms_per_batch": busy_ms,
        "kernels_per_batch": sum(v[1] for v in kernels.values()) / n,
        "idle_share": 1.0 - busy_ms / wall_ms_per_batch,
        "top": [{"name": name[:100], "us_per_batch": t / n, "launches_per_batch": c / n}
                for name, (t, c) in top],
    }
    log(f"device per batch: busy {busy_ms:.4f} ms in {out['kernels_per_batch']:.1f} "
        f"kernels, idle share {out['idle_share']:.3f} of {wall_ms_per_batch:.4f} ms")
    for k in out["top"]:
        log(f"  {k['us_per_batch']:9.2f} us x{k['launches_per_batch']:.1f}  {k['name']}")
    return out


def chain_step_ns(torch, cfg, keys, vals):
    """Device time of one dependent transition: one chain of BATCH queries
    on a single set, timed as a whole, divided by its length."""
    from repro_torch.core import EMPTY_KEY
    from repro_torch.kernels.msl_cache import msl_onepass_kernel_call

    dev = keys.device
    sids = torch.zeros((BATCH,), dtype=torch.int32, device=dev)
    rank = torch.arange(BATCH, dtype=torch.int32, device=dev)
    served = torch.ones((BATCH,), dtype=torch.int32, device=dev)
    rows = torch.zeros((BATCH, cfg.assoc, cfg.planes), dtype=torch.int32, device=dev)
    rows[:, :, 0] = EMPTY_KEY
    qk = (keys[:BATCH] % 64 + 1)[:, None].contiguous()
    args = (rows, qk, vals[:BATCH].contiguous(), None, sids, rank, served)
    ms = kernel_ms(torch, lambda: msl_onepass_kernel_call(*args, cfg=cfg), 5,
                   "msl_onepass_kernel")
    return 1e6 * ms / BATCH


def kernel_records(torch, cfg, keys, vals, onepass_inputs, access_inputs, errs,
                   summary):
    """Phase 6: one record per kernel at the main path's shapes.  Each
    record's ``launches`` is the count on the path that runs that kernel,
    named by ``launches_path``."""
    from repro_torch.kernels.msl_cache import (chain_resolve_plain,
                                               msl_access_kernel_call,
                                               msl_access_plain,
                                               msl_onepass_kernel_call)

    b, a, c = BATCH, cfg.assoc, cfg.planes
    kp, v = cfg.key_planes, cfg.value_planes
    ve = max(v, 1)
    ops_per_row = a * (kp + 1 + 3 * c)    # probe, empty scan, rotate selects

    access_args = tuple(t.contiguous() for t in access_inputs)
    access_bytes = 4 * b * (2 * a * c + kp + v + 2 + ve + c)
    access_call = lambda: msl_access_kernel_call(*access_args, cfg=cfg)  # noqa: E731
    access_ms = kernel_ms(torch, access_call, 200, "msl_access_kernel")
    access = {
        "name": "msl_access",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": "src/repro/kernels/msl_cache.py:279",
        "launches": summary["launches_rounds_check"]["msl_access"],
        "launches_path": f"rounds engine, {CHECK_BATCHES} batches of the cross-check",
        "max_abs_err": errs["msl_access"],
        "ms": access_ms,
        "call_ms": time_ms(torch, access_call, 200),
        "plain_ms": time_ms(torch, lambda: msl_access_plain(*access_args, cfg=cfg), 5),
        "bound_ms": 1e3 * max(access_bytes / HBM_BYTES_PER_S,
                              b * ops_per_row / INT32_OPS_PER_S),
        "bound_by": ("bytes" if access_bytes / HBM_BYTES_PER_S
                     >= b * ops_per_row / INT32_OPS_PER_S else "operations"),
        "library_ms": None,
        "shape": {"B": b, "A": a, "C": c},
    }

    x = onepass_inputs
    heads = int(x.firsts.sum())
    max_chain = int(x.rank.max()) + 1
    onepass_bytes = 4 * (heads * a * c + b * (kp + v + 2)
                         + b * (a * c + 2 + ve + c))
    step_ns = chain_step_ns(torch, cfg, keys, vals)
    onepass_call = lambda: msl_onepass_kernel_call(*x.kernel_args(), cfg=cfg)  # noqa: E731
    onepass_ms = kernel_ms(torch, onepass_call, 50, "msl_onepass_kernel")
    onepass = {
        "name": "msl_onepass",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": "src/repro/kernels/msl_cache.py:413",
        "launches": summary["launches_stream"]["msl_onepass"],
        "launches_path": "main path: the one-pass stream, "
                         f"{summary['config']['queries'] // BATCH} batches",
        "max_abs_err": errs["msl_onepass"],
        "ms": onepass_ms,
        "call_ms": time_ms(torch, onepass_call, 50),
        "plain_ms": time_ms(torch, lambda: chain_resolve_plain(*x.kernel_args(), cfg=cfg), 2),
        "bound_ms": 1e3 * max(onepass_bytes / HBM_BYTES_PER_S,
                              b * ops_per_row / INT32_OPS_PER_S),
        "bound_by": ("bytes" if onepass_bytes / HBM_BYTES_PER_S
                     >= b * ops_per_row / INT32_OPS_PER_S else "operations"),
        "library_ms": None,
        "shape": {"B": b, "A": a, "C": c, "chain_heads": heads},
        "max_chain": max_chain,
        "chain_step_ns": step_ns,
        "chain_bound_ms": max_chain * step_ns * 1e-6,
    }
    return [access, onepass]


# ---------------------------------------------------------------------------

def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    try:
        from repro_torch.core import MSLRUConfig
        from repro_torch.data.ycsb import zipfian_tensor
        from repro_torch.kernels import msl_cache
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})", file=sys.stderr)
        return 1

    t_start = time.perf_counter()
    phase("1. the card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    phase("2. build the kernels")
    t = time.perf_counter()
    lib = msl_cache.build_library()
    log(f"built {lib.relative_to(ROOT)} in {time.perf_counter() - t:.1f} s")
    report = (lib.parent / "ptxas.log").read_text()
    regs = [int(n) for n in re.findall(r"Used (\d+) registers", report)]
    spills = [int(n) for n in re.findall(r"(\d+) bytes spill stores", report)]
    log(f"ptxas: {len(regs)} kernel instances, {min(regs)}-{max(regs)} registers "
        f"per thread, at most {max(spills)} bytes of spill stores; "
        f"{report.count('warning')} compiler warnings")

    phase("3. msl_access kernel == plain, B = 8192")
    errs = {"msl_access": check_access_kernel(torch)}

    cfg = MSLRUConfig(num_sets=MAIN_SETS, m=2, p=4, key_planes=1, value_planes=2)
    n_queries = 2 * cfg.capacity + CHECK_BATCHES * BATCH
    t = time.perf_counter()
    keys = zipfian_tensor(N_KEYS, n_queries, ZIPF_ALPHA, seed=SEED, device=DEVICE)
    vals = torch.stack([keys, -keys], dim=1)
    torch.cuda.synchronize()
    log(f"stream: {n_queries} Zipf {ZIPF_ALPHA} queries over {N_KEYS} keys in "
        f"{time.perf_counter() - t:.1f} s")

    phase("4. msl_onepass kernel == plain")
    errs["msl_onepass"], onepass_inputs, access_inputs = check_onepass_kernel(
        torch, cfg, keys, vals)

    phase("5. main path")
    summary = run_main_path(torch, cfg, keys, vals)
    log(f"hit ratio {summary['hit_ratio']:.4f}, occupancy {summary['occupancy']:.4f}, "
        f"evictions {summary['evictions']}, {summary['qps']:.4g} queries/s, "
        f"{summary['ms_per_batch']:.4f} ms/batch, max chain per batch mean "
        f"{summary['max_chain_mean']:.1f} (min {summary['max_chain_min']}, "
        f"max {summary['max_chain_max']})")

    phase("6. kernels")
    records = kernel_records(torch, cfg, keys, vals, onepass_inputs,
                             access_inputs, errs, summary)
    for r in records:
        log(f"{r['name']}: {r['ms']:.5f} ms/launch on the device (profiler), "
            f"{r['call_ms']:.5f} ms per wrapper call (plain {r['plain_ms']:.3f} ms, "
            f"bound {r['bound_ms']:.5f} ms by {r['bound_by']}), "
            f"{r['launches']} launches on the {r['launches_path']}")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(smi)
    print(json.dumps({"main_path": summary, "card": smi}))
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
