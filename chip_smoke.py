#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the multi-step LRU cache, of its sharded
form, of its prefix-cached serving path (every architecture of the JAX
package: the attention decoders, the MoE decoders, the hymba hybrid, xLSTM
and the Whisper encoder-decoder) and of its trainer on one NVIDIA GPU.

Run from the root of a checkout, with one card visible:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. the card: ``torch.cuda.is_available()``; name and power limit;
2. build the CUDA kernel libraries from ``src/repro_torch/kernels/csrc``,
   one nvcc per source, all at once; each one's registers and spills;
3. the access kernel against its plain version at B = 8192 on thirteen
   geometries (among them A = 1, 2, 12, 15 and 32, whose lane groups hold
   32, 16, 2, 2 and 1 rows per warp), with no opcodes, mixed opcodes and a
   chain execute mask;
4. the one-pass kernel against its plain version on four Zipf batches of
   the main configuration over a warmed table, then the opcode, chain and
   cost variants on small configurations, then the batches of long repeated
   runs of ``tests/torch_run_cases.py`` (as built and with served holes);
5. the main path: ``MultiStepLRUCache(device=DEVICE)`` with 2**21 sets of
   M=2 x P=4 ways, 32-bit keys and 64-bit values (C = 3 planes, 201 MB),
   fed a scrambled YCSB Zipf 0.99 stream over 100M keys of twice the
   capacity in 8192-query batches; the first half warms, the second half
   is timed; the profiler splits a batch's device time by kernel; for 16
   batches, the longest chain's members and the transitions the kernel ran
   on it (the rest it resolved as runs).  Then the one-pass engine against
   the rounds engine (the access kernel) on four batches past the stream,
   and against ``access_seq`` on a 4096-query prefix of a small
   configuration;
6. the msl_cache kernels' records: launches on the path that runs each
   (the one-pass stream for the one-pass kernel, the rounds cross-check
   for the access kernel), time per launch, plain version's time, bound;
   for the access kernel also its rows per warp, its registers and its
   time at B = 1 and at an A = 32 geometry; for the one-pass kernel also
   ns per dependent transition on a chain with no two neighbours equal, ns
   per member of a one-key run, and the longest chain walked member by
   member at that rate (``chain_path_ms``, a critical path, not a bound);
7. the paged-attention kernel against its plain version at the serving
   path's shapes and at GQA rep 2 and 4, Dh 64 and 128, with windows and
   softcaps, a row with no prefix and a row whose tail is one token
   (within the JAX package's gate for its Pallas kernel; argmax over Dh
   equal wherever decisive); then at the attention-decoder families'
   shapes, each with and without a softcap: Dh 16 rep 4, Dh 24 rep 3
   (window 32), Dh 32 rep 4 on one KV head (window 16), Dh 128 rep 9 and
   rep 8, Dh 256 rep 4 (windows 0 and 40), Dh 64 rep 16; then the MoE
   decoders' full-width shapes, Dh 128 rep 1 on 16 KV heads (olmoe-1b-7b)
   and Dh 128 rep 4 on 8 (phi3.5-moe-42b); Dh 80 and rep 17 must raise;
8. the serving path: ``repro_torch.launch.serve.build`` with
   ``--no-smoke --kv-mode paged`` (phi3-mini-3.8b at its published width
   and depth, random weights from a seeded generator on the card), the
   launcher's 24 requests served tick by tick; the paged kernel must have
   launched n_layers times per paged decode launch and the one-pass kernel
   once per prefix-cache call; then the device's busy share over a few
   profiled ticks of a second serve;
9. the same requests through a contiguous engine on the same weights
   (plain attention): teacher-forced logits within LOGIT_ULPS bf16 ulps of
   the paged engine's, and where the token streams differ, a near-tie;
10. every kernel's record (the paged kernel's with the cluster size it
   launched with);
11. megastep decode at full width: a twin of phase 8's engine with
   ``decode_mode="megastep"`` captures one CUDA graph per pow2 window
   bucket (each capture's ms and node count), then serves the same
   requests through graph replays only: tokens, ticks, finish order and
   prefill split equal phase 8's; ``paged_attn`` launches equal n_layers x
   (in-flight launches + window steps), by the counter and, on a second
   serve with each step under its own profiler, by the profiler too; ms per
   decode tick and decode tokens/s from the first serve, busy share and
   kernels per window from the second;
12. split admission and round-robin decode at full width: a twin with
   ``admit_mode="split"``, ``decode_mode="roundrobin"`` gives phase 8's
   streams but where one splits at a near-tie (the teacher-forced logits of
   the two tokens within LOGIT_ULPS bf16 ulps); one ``msl_onepass`` launch
   per prefix-cache call;
13. the families at smoke width: gemma3-, starcoder2-, command-r-,
   qwen2-vl-, olmoe- and phi3.5-moe-smoke, each served through
   ``serve.build`` with ``--kv-mode paged`` and phase 8's checks (the
   windows of 16 and 32 bind), and through a contiguous twin on the same
   weights: streams equal or split at a near-tie (for MoE also a near-tie
   of the router, two experts' gates within ROUTER_TIE); the paged
   kernel's record at each one's shapes;
14. starcoder2-7b at its published width and depth (32 layers, d_model
   4608, 36 heads on 4 KV heads, Dh 128, d_ff 18432, vocab 49152; random
   weights; nothing cut): the in-flight serve with phase 8's checks, then a
   megastep twin on the window buckets phase 11's serve used: tokens,
   ticks, finish order and prefill split equal; ms per decode tick, tokens/s,
   wall, launches, host syncs, peak device memory, the kernel's record;
15. gemma3-1b at its published width and depth (26 layers, d_model 1152, 4
   heads on 1 KV head, Dh 256, vocab 262144): the in-flight serve, the same
   checks and numbers.  Each full-width model is freed before the next is
   built; neither's window (4096, 512) binds at the launcher's max_len 256;
16. olmoe-1b-7b at its published width and depth (16 layers, d_model 2048,
   16 heads, 64 experts top-8, expert d_ff 1024, vocab 50304; random
   weights; nothing cut): phase 14's in-flight and megastep serves and
   numbers, and the MoE FFN's device time per decode step beside its
   expert-weight read;
17. hymba at smoke width, then at its published width and depth (32
   layers, d_model 1600, 25 heads on 5 KV heads, Mamba state 16, 128 meta
   tokens, windows 1024 but three global layers), served through
   ``serve.build`` with the default ``--kv-mode contiguous`` as the JAX
   engine serves it (no prefix cache: no kernel launches): in-flight, a
   megastep twin (window graphs captured mid-serve, each capture leaving
   the Mamba state bit-equal; tokens, ticks, finish order and prefill split
   equal the in-flight serve's) and a round-robin twin (tokens equal or
   split at a near-tie); at smoke width the window of 16 binds;
18. xLSTM at smoke width, then xlstm-1.3b at its published width and depth
   (48 blocks in 6 groups of 7 mLSTM and 1 sLSTM, d_model 2048, 4 heads,
   mLSTM Dh 1024, vocab 50304; 3.57B parameters; random weights; nothing
   cut), through phase 17's path: in-flight, a megastep twin whose every
   capture leaves each mLSTM and sLSTM leaf bit-equal (tokens, ticks,
   finish order and prefill split equal), and a round-robin twin whose
   tokens must equal the in-flight ones;
19. Whisper at smoke width, then whisper-medium at its published width and
   depth (24 encoder and 24 decoder layers, d_model 1024, 16 heads of 64,
   d_ff 4096, vocab 51865, 1500 frames per request drawn from the seed in
   place of the stubbed conv frontend): in-flight and a megastep twin whose
   every capture leaves the cross-attention KV and the written KV
   bit-equal, with phase 17's checks.
   Phases 17-19 print ms per decode tick, tokens/s, serve wall, kernels per
   in-flight tick and per window step, the busy share, peak memory, one
   admission's prefill device time (and the encoder's), and the freeze's
   device time per decode step beside the bytes it moves;
20. the sharded cache at the main path's size: ``make_sharded_stream_runner``
   over ``SHARDS`` = 8 logical shards on the card, cap full, one-pass, fed
   phase 5's stream (kept on the host from phase 6 to here): the table bit-equal to phase 5's and its hits over the timed
   half equal; from phase 5's post-stream table, the one-pass and rounds
   sharded engines (``msl_onepass``, ``msl_access``) equal the local cache on
   the four batches after the stream; at caps 2.0 and 1.0 the first batch's
   shed rate, its admitted rows equal to the local cache fed only them; one
   batch at D = 7 (a table padded with EMPTY sets) equal to the local cache;
   queries/s, ms per batch, kernel launches per batch, the idle share;
21. phi3-mini-3.8b at full width and depth, paged, behind a
   ``ShardedCacheClient`` of 8 shards through ``serve.build(--sharded 8)``:
   cap full in-flight and megastep give phase 8's tokens, ticks and prefill
   split (or a near-tie split); then ``BOUNDED`` (cap 2, split placement,
   throttle 0.75, ``--chaos-seed 28``: two resizes to 7 shards, a shard
   lost) twice in-flight and once megastep: every request completes, the
   pool ends balanced, both in-flight runs give the same fault log,
   counters and tokens, the megastep run in-flight's ticks, faults and
   counters with at least one window capped at a fault's tick, and the
   tokens equal phase 8's or split at a near-tie; the shed, split, throttle and
   fallback stats, ms per decode tick, host ms per cache call and peak
   memory, ``msl_onepass`` and ``paged_attn`` launches on the path;
22. training, every family's smoke config through
   ``repro_torch.launch.train.build`` (128 x 4): one step on the card
   against the same step on the machine's CPU from the card's initial
   parameters (loss and metrics within LOSS_RTOL, the gradient norm within
   NORM_RTOL, each leaf of m = 0.1 x the clipped gradient within GRAD_ULPS
   bf16 ulps of its largest magnitude; an MoE router takes the CPU's
   expert choices on the card, and every choice it would make otherwise
   must be a near-tie under ROUTER_TIE); the CPU step's AdamW update again
   on the card from the gradients, state and parameters it took (the
   card's norm of them within NORM_SUM_RTOL of the CPU's; given the CPU's
   norm, master, m and v within ADAMW_ULPS f32 ulps, the new parameters
   equal); then, without experts, 2 microbatches against 1 on the card,
   within the step's bounds;
23. phi3-mini-3.8b at full width: (a) 2 of its 32 layers (0.42 B
   parameters), 1 x 256, one step and its AdamW update on the card against
   the CPU as in 22;
   (b) all 32 layers, ``remat="full"``, 1024 x 2, one microbatch,
   FULL_STEPS steps with finite losses: ms per step, tokens/s, the step's
   FLOPs (``train_flops``) over the bf16 peak, peak device memory against
   the training state; one more step under the profiler (busy share, GEMM
   ms, kernels) and AdamW alone;
24. ``examples/train_smoke.py``'s run on the card (``build_train_smoke``:
   300 steps, 2 microbatches, checkpoints every 100 steps in a temporary
   directory): the loss falls by more than 0.3; a fresh trainer restored
   from step 200 replays steps 201-300 with the same losses, bit for bit.
   Phases 22-24 launch none of the three kernels (counted from 0 before 22).

Then the JSON lines: the main path (phase 20 under ``sharded``), the
serving path (phases 8, 9, 11-19, 21 under ``sharded``), training (phases
22-24) and every kernel's record (the paged kernel's with ``shapes``: its
record at phases 13-16's shapes).

The msl_cache comparisons are bit-exact (all state is int32).  The last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import math
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


T0 = time.perf_counter()


def log(*args):
    print(*args, flush=True)


def phase(name):
    log(f"== {name} (at {time.perf_counter() - T0:.1f} s)")


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


def cuda_kernels(torch, prof):
    """The device activity of a profile: {kernel name: [total µs, launches]}."""
    kernels = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            k = kernels.setdefault(e.name, [0.0, 0])
            k[0] += e.time_range.elapsed_us()
            k[1] += 1
    return kernels


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
    return cuda_kernels(torch, prof)


def cold_device_ms(torch, fn, reps):
    """Device ms per call of ``fn()`` with the 50 MB L2 flushed before each
    call (a 64 MiB int8 ``bitwise_not_``, whose kernels are left out): the
    sum of ``fn``'s kernels in the profiler.  The serving path reaches its
    K/V cold: 240 MB of a layer's weights pass through L2 between two
    paged-attention launches."""
    flush = torch.zeros(64 << 20, dtype=torch.int8, device=DEVICE)

    def run():
        flush.bitwise_not_()
        fn()

    kernels = profile_kernels(torch, run, reps)
    return sum(v[0] for name, v in kernels.items() if "bitwise_not" not in name) / reps / 1e3


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

def build_kernels():
    """Phase 2: one nvcc per kernel source, all started together; each
    library's register and spill report from ``-Xptxas -v``."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import msl_cache, paged_attn
    from repro_torch.kernels.build import build_library

    sources = [msl_cache.SOURCE, paged_attn.SOURCE]
    t = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        libs = list(pool.map(build_library, sources))
    log(f"built {len(libs)} libraries in {time.perf_counter() - t:.1f} s")
    for lib in libs:
        report = (lib.parent / "ptxas.log").read_text()
        regs = [int(n) for n in re.findall(r"Used (\d+) registers", report)]
        spills = [int(n) for n in re.findall(r"(\d+) bytes spill stores", report)]
        log(f"{lib.relative_to(ROOT)}: ptxas: {len(regs)} kernel instances, "
            f"{min(regs)}-{max(regs)} registers per thread, at most {max(spills)} "
            f"bytes of spill stores; {report.count('warning')} compiler warnings")


def ptxas_registers(lib):
    """{mangled kernel name: registers per thread} from the ``-Xptxas -v``
    report (``ptxas.log``) beside the library ``lib``."""
    regs, name = {}, None
    for line in (Path(lib).parent / "ptxas.log").read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            regs[name] = int(m.group(1))
            name = None
    return regs


GEOMS = [  # (m, p, key_planes, value_planes, policy, cost_planes)
    (2, 4, 1, 2, "multistep", 0),
    (1, 4, 1, 1, "multistep", 0),
    (4, 2, 2, 2, "multistep", 0),
    (2, 8, 1, 0, "multistep", 0),
    (1, 8, 1, 2, "multistep", 0),
    (2, 4, 1, 2, "set_lru", 0),
    (8, 4, 2, 3, "multistep", 0),
    (2, 4, 1, 2, "multistep", 1),
    # lane groups of the access kernel: lanes out of the row (A = 12, 15),
    # 16 and 32 rows per warp (A = 2, 1), one row of C = 8 planes (A = 32)
    (3, 4, 1, 2, "multistep", 0),
    (5, 3, 1, 2, "multistep", 0),
    (1, 2, 1, 1, "multistep", 0),
    (1, 1, 1, 1, "multistep", 0),
    (8, 4, 2, 5, "multistep", 1),
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
    worst = max(worst, check_run_cases(torch))
    return worst, onepass_inputs, access_inputs


def check_run_cases(torch):
    """The one-pass kernel against its plain version on the batches of long
    repeated runs of ``tests/torch_run_cases.py`` (the ones the CPU tests
    hold against the JAX engine), as built and with about one served bit in
    30 cleared inside the chains."""
    import numpy as np

    from repro_torch.core import MSLRUConfig, pad_dummy_row, set_index_for
    from repro_torch.kernels.ops import onepass_prologue

    sys.path.insert(0, str(ROOT / "tests"))
    from torch_run_cases import run_cases

    def t(a):
        return None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(DEVICE)

    worst = 0
    for case in run_cases():
        cfg = MSLRUConfig(**case.kw)
        keys = t(case.keys)
        x = onepass_prologue(pad_dummy_row(t(case.table)), set_index_for(cfg, keys),
                             t(case.valid), keys, t(case.vals), case.max_rounds,
                             t(case.ops), t(case.chain_live), t(case.costs))
        worst = max(worst, check_onepass(torch, cfg, x))
        keep = t((np.random.default_rng(SEED).random(len(case.keys)) >= 1 / 30)
                 .astype(np.int32))
        worst = max(worst, check_onepass(torch, cfg, x._replace(served=x.served * keep)))
        log(f"msl_onepass == plain: run case {case.name} ({len(case.keys)} queries, "
            f"longest chain {int(x.rank.max()) + 1}; as built and with served holes)")
    return worst


def zero_launches():
    """Every kernel wrapper's launch count to 0."""
    from repro_torch.kernels import msl_cache, paged_attn

    for counts in (msl_cache.LAUNCHES, paged_attn.LAUNCHES):
        for name in counts:
            counts[name] = 0


def read_launches():
    from repro_torch.kernels import msl_cache, paged_attn

    return {**msl_cache.LAUNCHES, **paged_attn.LAUNCHES}


def run_main_path(torch, cfg, keys, vals):
    """Phase 5.  Returns the summary dict and the table after the stream.  Launches are counted on two
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
    stream_table = cache.table.clone()     # phase 20's reference
    timed_queries = (n_batches - half) * BATCH
    stream_launches = read_launches()
    occupancy = cache.occupancy
    log(f"warm half: {half} batches in {t1 - t0:.3f} s")
    breakdown = device_breakdown(torch, cache, keys, vals, half,
                                 1e3 * (t2 - t1) / (n_batches - half))
    longest = longest_chain_work(torch, cfg, cache, keys, vals, half)

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
        "hits": int(hits),
        "hit_ratio": int(hits) / timed_queries,
        "evictions": int(evictions),
        "occupancy": occupancy,
        "max_chain_mean": float(chains.float().mean()),
        "max_chain_min": int(chains.min()),
        "max_chain_max": int(chains.max()),
        "longest_chain_transitions": longest,
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
    return summary, stream_table


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


def onepass_transitions(torch, x, rows_after):
    """Which queries of a sorted one-pass batch ``x`` run a transition in
    the kernel, from its inputs and outputs: all but a query whose operands
    (key, value and cost planes, opcode, chain bit, served) equal its chain
    predecessor's, where that predecessor left the row as it was.  This is
    the rule by which the kernel collapses a run (csrc/msl_cache.cu)."""
    planes = [a.reshape(a.shape[0], -1) for a in (x.qkeys, x.qvals, x.ops,
                                                  x.chain_live, x.costs, x.served)
              if a is not None]
    ops = torch.cat(planes, 1)
    before = torch.cat([x.rows[:1], rows_after[:-1]])
    before = torch.where(x.firsts[:, None, None], x.rows, before)
    kept = (rows_after == before).flatten(1).all(1)
    collapsed = torch.zeros_like(kept)
    collapsed[1:] = (ops[1:] == ops[:-1]).all(1) & kept[:-1]
    return ~(collapsed & ~x.firsts)


def longest_chain_work(torch, cfg, cache, keys, vals, first, n=16):
    """Phase 5: for ``n`` batches of the stream from ``first`` (run again
    on the warm table), the longest chain's members and the transitions the
    kernel ran on it.  Each batch is resolved once more by the kernel for
    its outputs (launches outside the counted paths), then committed."""
    from repro_torch.kernels.msl_cache import msl_onepass_kernel_call

    out = []
    for i in range(first, first + n):
        q = slice(i * BATCH, (i + 1) * BATCH)
        x = onepass_case(torch, cfg, cache._padded, keys[q, None], vals[q])
        ran = onepass_transitions(torch, x, msl_onepass_kernel_call(*x.kernel_args(),
                                                                    cfg=cfg)[0])
        tail = int(torch.argmax(x.rank))
        chain = x.sids == x.sids[tail]
        chain_id = torch.cumsum(x.firsts.long(), 0) - 1
        per_chain = torch.zeros(BATCH, dtype=torch.long, device=DEVICE)
        per_chain.index_add_(0, chain_id, ran.long())
        out.append({"members": int(chain.sum()), "transitions": int((ran & chain).sum()),
                    "most_transitions_in_a_chain": int(per_chain.max())})
        cache.access(keys[q], vals[q])
    log("longest chain per batch, members / transitions run: "
        + " ".join(f"{c['members']}/{c['transitions']}" for c in out))
    log("most transitions run by one chain, per batch: "
        + " ".join(str(c["most_transitions_in_a_chain"]) for c in out))
    return out


def single_chain_ns(torch, cfg, qk, vals):
    """Device ns per member of one chain of BATCH queries ``qk`` on a
    single set, starting from an empty row, timed as a whole."""
    from repro_torch.core import EMPTY_KEY
    from repro_torch.kernels.msl_cache import msl_onepass_kernel_call

    dev = qk.device
    sids = torch.zeros((BATCH,), dtype=torch.int32, device=dev)
    rank = torch.arange(BATCH, dtype=torch.int32, device=dev)
    served = torch.ones((BATCH,), dtype=torch.int32, device=dev)
    rows = torch.zeros((BATCH, cfg.assoc, cfg.planes), dtype=torch.int32, device=dev)
    rows[:, :, 0] = EMPTY_KEY
    args = (rows, qk[:, None].contiguous(), vals.contiguous(), None, sids, rank, served)
    ms = kernel_ms(torch, lambda: msl_onepass_kernel_call(*args, cfg=cfg), 5,
                   "msl_onepass_kernel")
    return 1e6 * ms / BATCH


def chain_step_ns(torch, cfg, keys):
    """Device time of one dependent transition: a chain of BATCH queries on
    a single set over 64 keys, no two neighbours equal (each step moves
    1-63 keys on), so every member runs its transition."""
    qk = (torch.cumsum(keys[:BATCH].long() % 63 + 1, 0) % 64 + 1).to(torch.int32)
    if bool((qk[1:] == qk[:-1]).any()):
        raise AssertionError("the no-repeat chain has equal neighbours")
    return single_chain_ns(torch, cfg, qk, torch.stack([qk, -qk], 1))


def run_member_ns(torch, cfg):
    """Device time per member of a run: BATCH queries of one key on a
    single set (a miss, two promotions, then the fixed point)."""
    qk = torch.full((BATCH,), 7, dtype=torch.int32, device=DEVICE)
    return single_chain_ns(torch, cfg, qk, torch.stack([qk, -qk], 1))


def access_geometry_record(torch, cfg, access_args):
    """Phase 6: the access kernel's lane groups at the main geometry (rows
    per warp, the instance's registers from ``ptxas.log``) and its time at
    B = 1 (the first of the main rows: one launch's floor) and on BATCH
    random rows of an A = 32 geometry (m = 8, p = 4, the main planes), each
    checked against the plain version first (launches outside the counted
    paths)."""
    from repro_torch.core import MSLRUConfig
    from repro_torch.kernels import msl_cache
    from repro_torch.kernels.build import build_library

    a, c, kp, v = cfg.assoc, cfg.planes, cfg.key_planes, cfg.value_planes
    w = 1 << (a - 1).bit_length()            # the kernel's lane-group width
    name = re.compile(rf"msl_access_kernelILi{c}ELi{kp}ELi{w}EE")
    regs = [n for k, n in ptxas_registers(build_library(msl_cache.SOURCE)).items()
            if name.search(k)]
    if len(regs) != 1:
        raise AssertionError(f"ptxas.log: {len(regs)} entries match {name.pattern}")
    cfg32 = MSLRUConfig(num_sets=64, m=8, p=4, key_planes=kp, value_planes=v)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 4)
    args32 = random_rows_case(torch, cfg32, BATCH, gen)[:3]
    args1 = tuple(t[:1].contiguous() for t in access_args)
    out = {"rows_per_warp": 32 // w, "registers": regs[0]}
    for key, args, cf in (("ms_b1", args1, cfg), ("ms_a32", args32, cfg32)):
        err = max_abs_err(torch, msl_cache.msl_access_plain(*args, cfg=cf),
                          msl_cache.msl_access_kernel_call(*args, cfg=cf))
        if err:
            raise AssertionError(f"msl_access {key}: max |err| {err}")
        out[key] = kernel_ms(torch, lambda: msl_cache.msl_access_kernel_call(*args, cfg=cf),
                             200, "msl_access_kernel")
    nbytes = 4 * BATCH * (2 * cfg32.assoc * c + kp + v + 2 + max(v, 1) + c)
    ops = BATCH * cfg32.assoc * (kp + 1 + 3 * c)
    out["bound_ms_a32"] = 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S)
    out["shape_a32"] = {"B": BATCH, "A": cfg32.assoc, "C": c}
    return out


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
    access.update(access_geometry_record(torch, cfg, access_args))
    log(f"msl_access: {access['rows_per_warp']} rows per warp, {access['registers']} "
        f"registers; {access['ms_b1']:.5f} ms at B = 1, {access['ms_a32']:.5f} ms at "
        f"A = 32 (B = {b}, one row per warp, bound {access['bound_ms_a32']:.5f} ms)")

    x = onepass_inputs
    heads = int(x.firsts.sum())
    max_chain = int(x.rank.max()) + 1
    onepass_bytes = 4 * (heads * a * c + b * (kp + v + 2)
                         + b * (a * c + 2 + ve + c))
    step_ns = chain_step_ns(torch, cfg, keys)
    run_ns = run_member_ns(torch, cfg)
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
        "run_member_ns": run_ns,
        "chain_path_ms": max_chain * step_ns * 1e-6,
    }
    log(f"msl_onepass: {step_ns:.2f} ns per dependent transition (no-repeat chain), "
        f"{run_ns:.3f} ns per member of a one-key run; longest chain {max_chain}, "
        f"its path walked member by member {onepass['chain_path_ms']:.5f} ms")
    return [access, onepass]


# ---------------------------------------------------------------------------
# Slice 2: the prefix-cached paged serving path and the paged-attention kernel
# ---------------------------------------------------------------------------

PAGED_SOURCE = "src/repro_torch/kernels/csrc/paged_attn.cu"
# f32 FMA rate of an H100 SXM outside the tensor cores (the kernel's dots
# are f32 on the CUDA cores), from the published table
F32_OPS_PER_S = 67e12
# kernel against plain version: the JAX package's gate for its Pallas
# kernel against its mirror (the kernel keeps f32 scores where the plain
# version rounds them to bf16, and accumulates flash-style)
PAGED_RTOL, PAGED_ATOL = 0.05, 0.02
# full-width paged (kernel) against contiguous (plain) logits: within 8
# bf16 ulps of the step's largest |logit| (the logits are rounded to bf16,
# and the two attentions round differently in each of 32 layers)
LOGIT_ULPS = 8
PROFILE_TICKS = 8
# (name, H, KVH, Dh, window, softcap): the slice's shapes first
PAGED_CASES = [
    ("phi3-mini: H 32, KVH 32, Dh 96", 32, 32, 96, None, 0.0),
    ("rep 2, Dh 64, window 40", 16, 8, 64, 40, 0.0),
    ("rep 4, Dh 128, softcap 30", 32, 8, 128, None, 30.0),
    ("rep 4, Dh 64, window 24, softcap 50", 16, 4, 64, 24, 50.0),
    ("rep 2, Dh 128, window 100", 8, 4, 128, 100, 0.0),
] + [  # the attention-decoder families' shapes, each also with a softcap
    (f"{name}{', softcap 30' if cap else ''}", h, kvh, dh, window, cap)
    for name, h, kvh, dh, window in [
        ("command-r/qwen2-vl-smoke: Dh 16, rep 4", 8, 2, 16, None),
        ("starcoder2-smoke: Dh 24, rep 3, window 32", 6, 2, 24, 32),
        ("gemma3-smoke: Dh 32, rep 4, KVH 1, window 16", 4, 1, 32, 16),
        ("starcoder2-7b: Dh 128, rep 9, KVH 4", 36, 4, 128, None),
        ("command-r-35b/qwen2-vl-72b: Dh 128, rep 8, KVH 8", 64, 8, 128, None),
        ("gemma3-1b: Dh 256, rep 4, KVH 1", 4, 1, 256, None),
        ("gemma3-1b: Dh 256, rep 4, KVH 1, window 40", 4, 1, 256, 40),
        ("Dh 64, rep 16", 16, 1, 64, None)]
    for cap in (0.0, 30.0)
] + [  # the MoE decoders' full-width shapes (no window, no softcap)
    ("olmoe-1b-7b: Dh 128, rep 1, KVH 16", 16, 16, 128, None, 0.0),
    ("phi3.5-moe-42b: Dh 128, rep 4, KVH 8", 32, 8, 128, None, 0.0),
]
# (what, H, KVH, Dh) outside the built set: the wrapper raises, no fallback
PAGED_REFUSED = [("head dim 80", 4, 4, 80), ("rep 17", 17, 1, 64)]


def serve_args(*extra, smoke=False):
    """The launcher's arguments: the published widths and depth unless
    ``smoke``."""
    from repro_torch.launch import serve

    return serve.parser().parse_args([*([] if smoke else ["--no-smoke"]), "--device",
                                      DEVICE, *extra])


def paged_inputs(torch, gen, h, kvh, dh):
    """The slice's paged-decode operands (4 rows, 256 pages of 16 tokens,
    16-page block tables, 256-token tails) with random content: row 0 has a
    64-token prefix and 20 tail tokens, row 1 no prefix, row 2 a 48-token
    prefix and a one-token tail, row 3 an 80-token prefix and 9."""
    dev = DEVICE

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    plen = torch.tensor([64, 0, 48, 80], dtype=torch.int32, device=dev)
    cur = plen + torch.tensor([20, 37, 0, 9], dtype=torch.int32, device=dev)
    bt = torch.randint(0, 256, (4, 16), generator=gen, device=dev, dtype=torch.int32)
    return (randn(4, h, dh), randn(256, 16, kvh, dh), randn(256, 16, kvh, dh), bt,
            randn(4, 256, kvh, dh), randn(4, 256, kvh, dh), plen, cur)


def compare_paged(torch, got, want, what):
    """max |kernel - plain| in f32 within PAGED_RTOL/ATOL, and the argmax
    over Dh of every (row, head) equal wherever the plain version's top-2
    margin exceeds 2 * PAGED_ATOL.  Returns (max |err|, argmax checks)."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    if bool((err > PAGED_ATOL + PAGED_RTOL * w.abs()).any()):
        raise AssertionError(f"paged_attn {what}: max |err| {float(err.max())}")
    top2 = w.topk(2, dim=-1).values
    decisive = top2[..., 0] - top2[..., 1] > 2 * PAGED_ATOL
    if not bool(((g.argmax(-1) == w.argmax(-1)) | ~decisive).all()):
        raise AssertionError(f"paged_attn {what}: argmax over Dh differs")
    return float(err.max()), int(decisive.sum())


def check_paged_kernel(torch):
    """Phase 7: the paged kernel against its plain version."""
    from repro_torch.kernels.paged_attn import (paged_attn_decode_call,
                                                paged_attn_decode_plain)

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    worst = 0.0
    for name, h, kvh, dh, window, softcap in PAGED_CASES:
        args = paged_inputs(torch, gen, h, kvh, dh)
        got = paged_attn_decode_call(*args, window=window, softcap=softcap)
        want = paged_attn_decode_plain(*args, window=window, softcap=softcap)
        err, decisive = compare_paged(torch, got, want, name)
        worst = max(worst, err)
        log(f"paged_attn == plain: {name}: max |err| {err:.5f} (allowed "
            f"{PAGED_ATOL} + {PAGED_RTOL}|plain|), argmax equal on {decisive} "
            f"decisive (row, head) pairs")
    for what, h, kvh, dh in PAGED_REFUSED:
        try:
            paged_attn_decode_call(*paged_inputs(torch, gen, h, kvh, dh))
        except ValueError as e:
            log(f"paged_attn refuses {what}: {e}")
        else:
            raise AssertionError(f"paged_attn launched for {what}, outside its built set")
    return worst


def serve_requests(torch, eng, reqs):
    """Drive ``eng`` tick by tick until ``reqs`` are served.  Returns the
    wall time, the (seconds, tokens) of each tick that admitted nothing
    (pure decode), and the operands of the first such tick with every slot
    busy, for timing the kernel at the path's shapes."""
    for r in reqs:
        eng.submit(r)
    decode_ticks, snapshot = [], None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while eng.queue or eng.active:
        queued, tokens = len(eng.queue), eng.decode_tokens
        t = time.perf_counter()
        eng.step()                    # ends with the host fetch of its tokens
        if len(eng.queue) == queued:
            decode_ticks.append((time.perf_counter() - t, eng.decode_tokens - tokens))
            if snapshot is None and len(eng.active) == eng.slots and eng.paged:
                snapshot = (eng.pool.block_tables.copy(), eng.pool.prefix_lens.copy(),
                            eng.cur_len.copy())
    torch.cuda.synchronize()
    return time.perf_counter() - t0, decode_ticks, snapshot


def busy_share(torch, eng, reqs, first=10, n=PROFILE_TICKS):
    """The device's busy share over ``n`` ticks of a second serve of the
    requests (ticks ``first``.. of it), from the CUDA profiler, and where
    the device time of those ticks goes."""
    from torch.profiler import ProfilerActivity, profile

    for r in reqs:
        eng.submit(r)
    for _ in range(first):
        eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(n):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    eng.run_until_done()
    kernels = cuda_kernels(torch, prof)
    busy_ms = sum(v[0] for v in kernels.values()) / 1e3
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
    paged = [v for name, v in kernels.items() if "paged_attn_kernel" in name]
    out = {"ticks": n, "wall_ms_per_tick": 1e3 * wall / n, "busy_ms_per_tick": busy_ms / n,
           "busy_share": busy_ms / (1e3 * wall),
           "kernels_per_tick": sum(v[1] for v in kernels.values()) / n,
           "paged_attn_ms_per_launch": (sum(v[0] for v in paged)
                                        / max(1, sum(v[1] for v in paged)) / 1e3),
           "top": [{"name": name[:100], "us_per_tick": us / n, "launches_per_tick": c / n}
                   for name, (us, c) in top]}
    log(f"profiled {n} ticks: {out['wall_ms_per_tick']:.3f} ms/tick wall, device busy "
        f"{out['busy_ms_per_tick']:.3f} ms/tick in {out['kernels_per_tick']:.0f} kernels "
        f"(busy share {out['busy_share']:.3f})")
    for k in out["top"]:
        log(f"  {k['us_per_tick']:10.1f} us x{k['launches_per_tick']:.1f}  {k['name']}")
    return out


def run_serving(torch, args=None):
    """Phase 8: the launcher's paged serving path at full width (or the
    path ``args`` describe).  Launch counts are zeroed just before the
    serve and read just after."""
    from repro_torch.launch import serve

    args = args or serve_args("--kv-mode", "paged")
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    eng = serve.build(args)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in eng.params.parameters())
    log(f"{eng.cfg.name}: {n_params / 1e9:.3f}B parameters "
        f"({n_params * 2 / 1e9:.2f} GB bf16), pool K+V "
        f"{2 * eng.pool.k.numel() * 2 / 1e6:.0f} MB, slot tails K+V "
        f"{2 * eng.pool.tail_k.numel() * 2 / 1e6:.0f} MB; built in "
        f"{time.perf_counter() - t:.1f} s")
    reqs = serve.make_requests(eng.cfg, args)
    zero_launches()
    wall, decode_ticks, snapshot = serve_requests(torch, eng, reqs)
    launches = read_launches()
    st, pc = eng.stats(), eng.prefix_cache.stats()
    skipped = sum(r.prefill_skipped for r in eng.finished)
    computed = sum(r.prefill_computed for r in eng.finished)
    dec_s = sum(s for s, _ in decode_ticks)
    dec_tok = sum(n for _, n in decode_ticks)
    summary = {
        "arch": eng.cfg.name, "params": n_params, "requests": len(reqs),
        "finished": len(eng.finished), "ticks": st["ticks"], "wall_s": wall,
        "decode_only_ticks": len(decode_ticks),
        "decode_tokens_per_s": dec_tok / dec_s,
        "ms_per_decode_tick": 1e3 * dec_s / len(decode_ticks),
        "prefill_computed": computed, "prefill_skipped": skipped,
        "decode_launches": st["decode_launches"], "decode_tokens": st["decode_tokens"],
        "host_syncs": st["host_syncs"], "gather_calls": st["gather_calls"],
        "resident_kv_tokens_peak": st["resident_kv_tokens_peak"],
        "prefix_cache": pc, "launches": launches,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    log(f"served {summary['finished']}/{len(reqs)} requests in {st['ticks']} ticks, "
        f"{wall:.3f} s wall")
    log(f"decode: {summary['decode_tokens_per_s']:.1f} tokens/s, "
        f"{summary['ms_per_decode_tick']:.3f} ms per decode-only tick "
        f"({len(decode_ticks)} ticks)")
    log(f"prefill tokens: computed {computed}, skipped {skipped}; decode_launches "
        f"{st['decode_launches']}, host_syncs {st['host_syncs']}, gather_calls "
        f"{st['gather_calls']}; prefix cache {pc['device_calls']} device calls, hit "
        f"ratio {pc['hit_ratio']:.4f}")
    log(f"launches on the serving path: {launches}")
    if summary["finished"] != len(reqs) or any(len(r.out_tokens) != args.max_new
                                               for r in eng.finished):
        raise AssertionError("not every request was served in full")
    if st["gather_calls"] != 0:
        raise AssertionError("paged serving copied a prefix (gather_calls != 0)")
    if not 0 < launches["paged_attn"] == eng.cfg.n_layers * st["decode_launches"]:
        raise AssertionError("paged_attn launches != n_layers x paged decode launches")
    if not 0 < launches["msl_onepass"] == pc["device_calls"]:
        raise AssertionError("msl_onepass launches != prefix-cache device calls")
    summary["device"] = busy_share(torch, eng, [
        type(r)(rid=1000 + r.rid, prompt=r.prompt, max_new_tokens=r.max_new_tokens)
        for r in reqs])
    return eng, reqs, summary, snapshot


def engine_twin(eng, **kw):
    """An engine on the same model and weights as ``eng``, with a fresh
    prefix cache and pool of the launcher's sizes; ``kw`` overrides the
    engine's arguments (paged by default)."""
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.kv_cache import PagedKVPool
    from repro_torch.serving.prefix_cache import PrefixCache

    ct = eng.prefix_cache.chunk_tokens
    return ServeEngine(eng.model, eng.params, slots=eng.slots, max_len=eng.max_len,
                       prefix_cache=PrefixCache(num_sets=256, m=2, p=4, chunk_tokens=ct,
                                                device=DEVICE),
                       pool=PagedKVPool(eng.cfg, n_pages=256, page_tokens=ct, device=DEVICE),
                       **{"kv_mode": "paged", **kw})



def teacher_forced_logits(torch, eng, prompt, tokens, paged, frames=None):
    """Logits for every emitted token of one request, its own tokens fed
    back: the prefill's (of ``frames`` too, for an encoder-decoder), then one
    decode step per token.  ``paged`` keeps the prompt's whole chunks before
    its last token in pool pages and decodes through ``paged_decode_step``
    (the kernel); otherwise a contiguous cache and ``decode_step`` (plain
    attention; recurrent state and cross-attention KV carried from the
    prefill)."""
    from repro_torch.serving.engine import paged_decode_step
    from repro_torch.serving.kv_cache import PagedKVPool

    cfg, model, params, dev = eng.cfg, eng.model, eng.params, eng.device
    n, ct = len(prompt), eng.prefix_cache.chunk_tokens
    batch = {"tokens": torch.tensor(prompt[None], device=dev)}
    if frames is not None:
        batch["frames"] = frames[None].to(dev)
    logits, pc = model.prefill(params, batch)
    out = [logits[0]]
    feed = [torch.tensor([[t]], dtype=torch.int32, device=dev) for t in tokens[:-1]]
    if paged:
        plen = (n - 1) // ct * ct
        pool = PagedKVPool(cfg, n_pages=eng.max_len // ct, page_tokens=ct, device=dev)
        tail = pool.attach_slots(1, eng.max_len)
        pages = list(range(plen // ct))
        shape = (cfg.n_layers, len(pages), ct, cfg.n_kv_heads, cfg.head_dim)
        pool.write_pages(pages, pc["k"][:, 0, :plen].reshape(shape),
                         pc["v"][:, 0, :plen].reshape(shape))
        pool.set_block_table(0, pages)
        tail["k"][:, 0, :n - plen] = pc["k"][:, 0, plen:]
        tail["v"][:, 0, :n - plen] = pc["v"][:, 0, plen:]
        plens = torch.tensor([plen], dtype=torch.int32, device=dev)
        for j, tok in enumerate(feed):
            cur = torch.tensor([n + j], dtype=torch.int32, device=dev)
            logits, _ = paged_decode_step(cfg, params, tok, tail, pool.k, pool.v,
                                          pool.device_block_tables(), plens, cur,
                                          smax=eng.max_len)
            out.append(logits[0])
    else:
        cache = model.init_cache(1, eng.max_len, device=dev)
        for name, x in pc.items():
            if name in ("k", "v"):            # the prompt's KV (and meta tokens')
                cache[name][:, 0, :x.shape[2]] = x[:, 0]
            else:                             # the state after the prompt, cross KV
                cache[name] = x
        for j, tok in enumerate(feed):
            cur = torch.tensor([n + j], dtype=torch.int32, device=dev)
            logits, cache = model.decode_step(params, tok, cache, cur)
            out.append(logits[0])
    return torch.stack(out)


def cross_check(torch, eng, reqs):
    """Phase 9: paged (kernel) against contiguous (plain attention) at full
    width on the same requests and weights.  Every step's logits,
    teacher-forced with the contiguous run's tokens, agree within
    LOGIT_ULPS bf16 ulps; where the two engines' token streams differ, the
    contiguous logits' top-2 margin at the first differing step is under
    that tolerance (a near-tie that the two roundings break apart).  The
    teacher-forced runs decode one request at a time, so a margin there
    stands for the engine's at that step."""
    from repro_torch.serving.engine import Request

    twin = engine_twin(eng, kv_mode="contiguous")
    for r in reqs:
        twin.submit(Request(rid=r.rid, prompt=r.prompt, max_new_tokens=r.max_new_tokens))
    twin.run_until_done()
    paged = {r.rid: r.out_tokens for r in eng.finished if r.rid < 1000}  # the cold serve
    contig = {r.rid: r.out_tokens for r in twin.finished}
    first_diff = {rid: next(j for j, (a, b) in enumerate(zip(paged[rid], toks)) if a != b)
                  for rid, toks in contig.items() if paged[rid] != toks}
    worst, worst_ulps, top, steps, margins = 0.0, 0.0, 0.0, 0, {}
    for r in reqs:
        toks = contig[r.rid]
        lc = teacher_forced_logits(torch, twin, r.prompt, toks, paged=False)
        lp = teacher_forced_logits(torch, eng, r.prompt, toks, paged=True)
        if not torch.equal(lc[0], lp[0]):
            raise AssertionError(f"request {r.rid}: prefill logits differ")
        big = lc.abs().amax(-1)
        ulp = 2.0 ** (torch.floor(torch.log2(big)) - 7)   # bf16 ulp of each step
        diff = (lp - lc).abs().amax(-1)
        worst, top = max(worst, float(diff.max())), max(top, float(big.max()))
        worst_ulps, steps = max(worst_ulps, float((diff / ulp).max())), steps + len(toks)
        if bool((diff > LOGIT_ULPS * ulp).any()):
            raise AssertionError(f"request {r.rid}: teacher-forced logits differ by "
                                 f"{float((diff / ulp).max())} > {LOGIT_ULPS} bf16 ulps")
        if r.rid in first_diff:
            j = first_diff[r.rid]
            top2 = lc[j].topk(2).values
            margins[r.rid] = (float(top2[0] - top2[1]), float(LOGIT_ULPS * ulp[j]))
    log(f"teacher-forced logits, paged (kernel) vs contiguous: max |diff| {worst:.5f} "
        f"= {worst_ulps:.2f} bf16 ulps of the step's largest |logit| (allowed "
        f"{LOGIT_ULPS}; largest |logit| {top:.3f}) over {steps} steps of "
        f"{len(reqs)} requests")
    if not first_diff:
        log("token streams of the paged and contiguous engines are identical")
    for rid, j in sorted(first_diff.items()):
        margin, tol = margins[rid]
        log(f"request {rid}: token streams first differ at step {j}; contiguous "
            f"top-2 margin there {margin:.5f} (tolerance {tol:.5f})")
        if margin >= tol:
            raise AssertionError(f"request {rid}: streams differ at step {j} with a "
                                 f"decisive margin {margin}")
    return {"logit_max_abs_diff": worst, "logit_max_diff_ulps": worst_ulps,
            "logit_tol_ulps": LOGIT_ULPS, "logit_max_abs": top, "steps": steps,
            "requests_differing": len(first_diff),
            "first_differing_step": min(first_diff.values(), default=None),
            "margins_at_first_difference": {k: v[0] for k, v in margins.items()}}


def paged_record(torch, eng, snapshot, serving, err, path="serving path"):
    """The paged kernel's record at the serving path's shapes: the
    operands of a decode tick with every slot busy (layer 0's pool plane,
    tails and window, random q).  ``ms``, ``library_ms`` and
    ``plain_device_ms`` are device times with L2 flushed, as the path finds
    its K/V; ``ms_in_path`` is the kernel's time per launch in the profiled
    serving ticks; ``call_ms`` and ``plain_ms`` are CUDA-event times per
    call, host included.  The bound counts the positions the window lets
    each row walk."""
    import torch.nn.functional as F

    from repro_torch.kernels.paged_attn import (gather_view, kernel_splits,
                                                paged_attn_decode_call,
                                                paged_attn_decode_plain)

    cfg = eng.cfg
    bt, plen, cur = (torch.from_numpy(x).to(DEVICE) for x in snapshot)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 3)
    q = torch.randn((eng.slots, cfg.n_heads, cfg.head_dim), generator=gen,
                    device=DEVICE).to(torch.bfloat16)
    args = (q, eng.pool.k[0], eng.pool.v[0], bt, eng.cache["k"][0], eng.cache["v"][0],
            plen, cur)
    window = cfg.windows()[0]
    kw = dict(window=window, softcap=cfg.softcap)
    call = lambda: paged_attn_decode_call(*args, **kw)          # noqa: E731
    plain = lambda: paged_attn_decode_plain(*args, smax=eng.max_len, **kw)  # noqa: E731
    err = max(err, compare_paged(torch, call(), plain(), f"{cfg.name} serving shapes")[0])
    # the yardstick: SDPA on the gathered contiguous view (the gather untimed)
    kv = [x.transpose(1, 2) for x in gather_view(*args[1:7], smax=eng.max_len)]
    S = kv[0].shape[2]
    k_pos = torch.arange(S, device=DEVICE)[None, :]
    mask = k_pos <= cur[:, None].long()
    if window > 0:
        mask &= cur[:, None].long() - k_pos < window
    library = lambda: F.scaled_dot_product_attention(      # noqa: E731
        q[:, :, None], kv[0], kv[1], attn_mask=mask[:, None, None, :],
        enable_gqa=cfg.n_heads != cfg.n_kv_heads)
    walked = cur + 1 if window <= 0 else torch.clamp(cur + 1, max=window)
    positions = int(walked.sum())
    nbytes = (positions * 2 * cfg.n_kv_heads * cfg.head_dim * 2
              + 2 * q.numel() * 2 + bt.numel() * 4 + 2 * eng.slots * 4)
    ops = positions * 4 * cfg.n_heads * cfg.head_dim
    return {
        "name": "paged_attn", "route": "cuda", "source": PAGED_SOURCE,
        "replaces": "src/repro/kernels/paged_attn.py:113",
        "launches": serving["launches"]["paged_attn"],
        "launches_path": f"{path}: {cfg.n_layers} per paged decode launch",
        "max_abs_err": err,
        "ms": cold_device_ms(torch, call, 100),
        "ms_warm_l2": kernel_ms(torch, call, 100, "paged_attn_kernel"),
        "ms_in_path": serving["device"]["paged_attn_ms_per_launch"],
        "call_ms": time_ms(torch, call, 100),
        "plain_ms": time_ms(torch, plain, 20),
        "plain_device_ms": cold_device_ms(torch, plain, 20),
        "bound_ms": 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S),
        "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= ops / F32_OPS_PER_S
                    else "operations",
        "library_ms": cold_device_ms(torch, library, 100),
        "splits": kernel_splits(q, args[1], bt, args[4]),
        "shape": {"arch": cfg.name, "B": eng.slots, "H": cfg.n_heads,
                  "KVH": cfg.n_kv_heads, "Dh": cfg.head_dim, "window": window,
                  "positions": positions, "prefix_len": plen.tolist(),
                  "cur_len": cur.tolist()},
    }

# ---------------------------------------------------------------------------
# Slice 5: megastep decode as one CUDA graph per window, split admission and
# round-robin decode
# ---------------------------------------------------------------------------

def graph_nodes(graph) -> int:
    """Nodes of a captured ``torch.cuda.CUDAGraph`` (kept with
    ``keep_graph=True``), from ``cuGraphGetNodes`` in ``libcuda``."""
    import ctypes

    n = ctypes.c_size_t(0)
    err = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"cuGraphGetNodes failed: CUresult {err}")
    return n.value


def fresh(reqs, offset=0):
    """Copies of ``reqs`` with no tokens yet (rids shifted by ``offset``)."""
    from repro_torch.serving.engine import Request

    return [Request(rid=offset + r.rid, prompt=r.prompt, max_new_tokens=r.max_new_tokens,
                    frames=r.frames) for r in reqs]


def served(eng, reqs):
    """What ``eng`` made of ``reqs``: per-request tokens and prefill split in
    finish order."""
    rids = {r.rid for r in reqs}
    return [(r.rid, list(r.out_tokens), r.prefill_skipped, r.prefill_computed)
            for r in eng.finished if r.rid in rids]


def serve_windows(torch, eng, reqs, profile_steps=False):
    """Drive ``eng`` tick by tick until ``reqs`` are served.  Returns the
    wall time and, for every step that admitted nothing (a megastep window,
    ending with the host fetch of its tokens), its (seconds, ticks covered,
    tokens, decode steps).  With ``profile_steps`` every step runs under a
    CUDA profiler of its own, and the list holds a record of every step:
    wall and busy ms, kernels, ``paged_attn`` launches by the profiler and
    by the counter."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import paged_attn

    for r in reqs:
        eng.submit(r)
    out = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while eng.queue or eng.active:
        queued, tokens, ticks, steps = (len(eng.queue), eng.decode_tokens, eng.ticks,
                                        eng.window_steps)
        admits = bool(eng.queue and eng._free_slots)
        launches = paged_attn.LAUNCHES["paged_attn"]
        if profile_steps:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t = time.perf_counter()
                eng.step()
                torch.cuda.synchronize()
                dt = time.perf_counter() - t
        else:
            t = time.perf_counter()
            eng.step()
            dt = time.perf_counter() - t
        window = len(eng.queue) == queued
        if window and (admits or eng.window_steps == steps):
            raise AssertionError("a step that admitted nothing ran no window")
        if profile_steps:
            kernels = cuda_kernels(torch, prof)
            out.append({"window": window, "wall_ms": 1e3 * dt, "ticks": eng.ticks - ticks,
                        "steps": eng.window_steps - steps,
                        "busy_ms": sum(v[0] for v in kernels.values()) / 1e3,
                        "kernels": sum(v[1] for v in kernels.values()),
                        "paged_attn": sum(v[1] for name, v in kernels.items()
                                          if "paged_attn_kernel" in name),
                        "paged_attn_counter": paged_attn.LAUNCHES["paged_attn"] - launches})
        elif window:
            out.append((dt, eng.ticks - ticks, eng.decode_tokens - tokens,
                        eng.window_steps - steps))
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def check_launches(eng, counted, stats, what):
    """``paged_attn`` launches of a serve: n_layers per in-flight decode
    launch and per decode step of a window."""
    inflight = stats["decode_launches"] - stats["megastep_windows"]
    want = eng.cfg.n_layers * (inflight + stats["megastep_steps"])
    if not 0 < counted == want:
        raise AssertionError(f"{what}: {counted} paged_attn launches, expected "
                             f"{eng.cfg.n_layers} x ({inflight} in-flight launches + "
                             f"{stats['megastep_steps']} window steps) = {want}")
    return want


def megastep_serve(torch, eng, reqs, serving, buckets):
    """A megastep twin of ``eng`` (the same model and weights, paged)
    serving ``reqs``: the window ``buckets`` captured first, each timed on
    its own; then the serve through graph replays only, which must give the
    in-flight serve's (``serving``) tokens, ticks, finish order and prefill
    split, with ``paged_attn`` = n_layers x (in-flight launches + window
    steps) and one ``msl_onepass`` launch per prefix-cache call.  Returns
    the twin and the serve's numbers."""
    twin = engine_twin(eng, decode_mode="megastep")
    captures = []
    for steps in buckets:
        torch.cuda.synchronize()
        t = time.perf_counter()
        win = twin.capture_window(steps)
        torch.cuda.synchronize()
        captures.append({"steps": steps, "ms": 1e3 * (time.perf_counter() - t),
                         "nodes": graph_nodes(win.graph),
                         "paged_attn": win.launches["paged_attn"]})
        log(f"captured the {steps}-step window: {captures[-1]['ms']:.1f} ms (warm-up "
            f"and capture), {captures[-1]['nodes']} graph nodes, "
            f"{win.launches['paged_attn']} paged_attn launches per replay")
        if win.launches["paged_attn"] != eng.cfg.n_layers * steps:
            raise AssertionError("a window graph holds the wrong paged_attn launches")
    graphs = dict(twin.window_graphs)

    zero_launches()
    wall, windows = serve_windows(torch, twin, fresh(reqs))
    launches = read_launches()
    st = twin.stats()
    if twin.window_graphs != graphs:
        raise AssertionError("the serve captured a window graph outside the captures")
    if served(twin, reqs) != served(eng, reqs) or st["ticks"] != serving["ticks"]:
        raise AssertionError("megastep tokens, finish order, prefill split or ticks "
                             "differ from the in-flight serve")
    check_launches(twin, launches["paged_attn"], st, "megastep serve")
    if launches["msl_onepass"] != twin.prefix_cache.device_calls:
        raise AssertionError("msl_onepass launches != prefix-cache device calls")
    win_s = sum(w[0] for w in windows)
    win_ticks = sum(w[1] for w in windows)
    win_tok = sum(w[2] for w in windows)
    out = {
        "ticks": st["ticks"], "wall_s": wall, "decode_launches": st["decode_launches"],
        "host_syncs": st["host_syncs"], "megastep_windows": st["megastep_windows"],
        "mean_window": st["mean_window"], "megastep_steps": st["megastep_steps"],
        "masked_step_share": 1 - win_ticks / st["megastep_steps"],
        "windows": [{"ms": 1e3 * s, "ticks": k, "tokens": n, "steps": m}
                    for s, k, n, m in windows],
        "ms_per_decode_tick": 1e3 * win_s / win_ticks,
        "decode_tokens_per_s": win_tok / win_s,
        "inflight_ms_per_decode_tick": serving["ms_per_decode_tick"],
        "inflight_decode_tokens_per_s": serving["decode_tokens_per_s"],
        "graphs": captures, "launches": launches,
        "paged_attn_expected": twin.cfg.n_layers * (st["decode_launches"]
                                                    - st["megastep_windows"]
                                                    + st["megastep_steps"]),
    }
    log(f"megastep: {st['ticks']} ticks (in-flight {serving['ticks']}), "
        f"{st['decode_launches']} decode launches (in-flight "
        f"{serving['decode_launches']}), {st['host_syncs']} host syncs (in-flight "
        f"{serving['host_syncs']}), {st['megastep_windows']} windows of mean "
        f"{st['mean_window']:.2f} ticks over {st['megastep_steps']} steps (masked "
        f"share {out['masked_step_share']:.3f}); {len(graphs)} graphs captured")
    log(f"megastep decode: {out['ms_per_decode_tick']:.3f} ms per decode tick, "
        f"{out['decode_tokens_per_s']:.1f} tokens/s over {len(windows)} windows, serve "
        f"{wall:.3f} s wall (in-flight: {serving['ms_per_decode_tick']:.3f} ms, "
        f"{serving['decode_tokens_per_s']:.1f} tokens/s)")
    return twin, out


def run_megastep(torch, eng, reqs, serving):
    """Phase 11: the launcher's requests through a megastep twin of phase
    8's engine (``megastep_serve``), every pow2 bucket up to
    ``max_window`` captured first.  Then a second serve under the profiler
    with each step under its own profiler: its ``paged_attn`` launches
    counted by the profiler and by the counter, and each window's busy
    share and kernels."""
    buckets = [1 << i for i in range(eng.max_window.bit_length())
               if 1 << i <= eng.max_window]
    twin, out = megastep_serve(torch, eng, reqs, serving, buckets)

    before = twin.stats()
    zero_launches()
    _, steps_seen = serve_windows(torch, twin, fresh(reqs, 2000), profile_steps=True)
    counted = read_launches()["paged_attn"]
    d = {k: twin.stats()[k] - before[k] for k in ("ticks", "decode_launches", "host_syncs",
                                                  "megastep_windows", "megastep_steps",
                                                  "decode_tokens")}
    want = check_launches(twin, counted, d, "profiled megastep serve")
    seen = sum(w["paged_attn"] for w in steps_seen)
    per = [w for w in steps_seen if w["window"]]
    out["profiled_serve"] = {"paged_attn_profiler": seen, "paged_attn_counter": counted,
                             "expected": want, **d}
    log(f"profiled megastep serve (each step under its own profiler): paged_attn {seen} "
        f"launches by the profiler, {counted} by the counter, expected {want} = "
        f"{twin.cfg.n_layers} x ({d['decode_launches'] - d['megastep_windows']} in-flight "
        f"launches + {d['megastep_steps']} window steps)")
    for w in steps_seen:
        log(f"  {'window' if w['window'] else 'in-flight tick'}: {w['ticks']} ticks in "
            f"{w['steps']} steps, {w['wall_ms']:.3f} ms wall, {w['busy_ms']:.3f} ms busy, "
            f"{w['kernels']} kernels, paged_attn {w['paged_attn']} by the profiler and "
            f"{w['paged_attn_counter']} by the counter")
    if seen != counted:
        raise AssertionError(f"the profiler saw {seen} paged_attn launches, the "
                             f"counter {counted}")
    wall_ms = sum(w["wall_ms"] for w in per)
    busy_ms = sum(w["busy_ms"] for w in per)
    n_steps = sum(w["steps"] for w in per)
    out["device"] = {"steps": steps_seen, "busy_share": busy_ms / wall_ms,
                     "busy_ms_per_step": busy_ms / n_steps,
                     "kernels_per_window": sum(w["kernels"] for w in per) / len(per),
                     "kernels_per_step": sum(w["kernels"] for w in per) / n_steps,
                     "ms_per_decode_tick_profiled": wall_ms / sum(w["ticks"] for w in per)}
    log(f"profiled windows: busy share {out['device']['busy_share']:.3f}, "
        f"{out['device']['busy_ms_per_step']:.3f} ms busy per step, "
        f"{out['device']['kernels_per_window']:.0f} kernels per window "
        f"({out['device']['kernels_per_step']:.0f} per step)")
    return out


# an MoE routing choice may flip between two paths where the router's k-th
# and (k+1)-th probabilities lie within this gap (the CPU tests' bound
# against the JAX router: the router reads a bf16 hidden state that two
# paths round differently)
ROUTER_TIE = 2 ** -7


def router_gap(probs, top_k):
    """Each token's gap between its k-th and (k+1)-th router probability."""
    top = probs.topk(top_k + 1, dim=-1).values
    return top[..., top_k - 1] - top[..., top_k]


@contextlib.contextmanager
def routing(torch, impose=None):
    """Log every MoE router call's probabilities and choices (on the
    host); with ``impose`` (another run's log), the router takes that run's
    choices, call by call, and the log keeps its own."""
    from repro_torch.models import moe

    route, log_ = moe.route, []

    def logged(params, x, top_k):
        logits, probs, gv, gi = route(params, x, top_k)
        log_.append((probs.detach().float().cpu(), gi.cpu()))
        if impose is not None:
            gi = impose[len(log_) - 1][1].to(gi.device)
            gv = probs.gather(-1, gi)
            gv = gv / torch.clamp(gv.sum(-1, keepdim=True), min=1e-9)
        return logits, probs, gv, gi

    moe.route = logged
    try:
        yield log_
    finally:
        moe.route = route


def near_ties(torch, eng, reqs, got, want):
    """Where the token streams ``got`` and ``want`` (rid -> tokens) differ:
    the first differing step of each, and the gap there between the two
    tokens' logits, teacher-forced with ``want``'s tokens through ``eng``'s
    path (paged or contiguous).  Raises unless every gap is under LOGIT_ULPS
    bf16 ulps of the step's largest |logit| (a near-tie that two roundings
    break apart, as in phase 9), or, for an MoE model, the teacher-forced
    path up to that step passes a routing near-tie (two experts' gates
    within ROUTER_TIE), which two roundings may flip."""
    ties = {}
    for r in reqs:
        a, b = want[r.rid], got[r.rid]
        if a == b:
            continue
        j = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        with routing(torch) as routes:
            lg = teacher_forced_logits(torch, eng, r.prompt, a, paged=eng.paged,
                                       frames=r.frames)[j]
        margins = [float(router_gap(p, eng.cfg.moe_top_k).min()) for p, _ in routes]
        gap = float((lg[a[j]] - lg[b[j]]).abs())
        tol = float(LOGIT_ULPS * 2.0 ** (torch.floor(torch.log2(lg.abs().max())) - 7))
        # the prefill's router calls, then one per layer per decode step
        router = min(margins[: eng.cfg.n_layers * (j + 1)], default=None)
        ties[r.rid] = {"step": j, "gap": gap, "tol": tol, "router_margin": router}
        log(f"request {r.rid}: streams first differ at step {j}; teacher-forced logit "
            f"gap between the two tokens {gap:.5f} (tolerance {tol:.5f})"
            + ("" if router is None else f"; smallest router margin on the path "
               f"{router:.6f} (tolerance {ROUTER_TIE})"))
        if gap >= tol and (router is None or router >= ROUTER_TIE):
            raise AssertionError(f"request {r.rid}: streams differ at step {j} with a "
                                 f"decisive gap {gap}")
    return ties


def run_split_roundrobin(torch, eng, reqs, serving):
    """Phase 12: the launcher's requests through a twin of phase 8's engine
    with split admission and round-robin decode (paged).  Its streams must
    be phase 8's but where two differ from a near-tie on (``near_ties``):
    split admission prefills each request alone, and round-robin decode
    admits on other ticks, so prefill GEMMs of other shapes round the
    shared KV differently.  The one-pass kernel launches once per
    prefix-cache call, the paged kernel n_layers times per decode launch."""
    twin = engine_twin(eng, admit_mode="split", decode_mode="roundrobin")
    zero_launches()
    for r in fresh(reqs):
        twin.submit(r)
    torch.cuda.synchronize()
    t = time.perf_counter()
    twin.run_until_done()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = read_launches()
    st, pc = twin.stats(), twin.prefix_cache.stats()
    got = {rid: toks for rid, toks, _, _ in served(twin, reqs)}
    want = {rid: toks for rid, toks, _, _ in served(eng, reqs)}
    if sorted(got) != sorted(want) or any(len(got[r]) != len(want[r]) for r in want):
        raise AssertionError("split/round-robin did not serve every request in full")
    ties = near_ties(torch, eng, reqs, got, want)
    check_launches(twin, launches["paged_attn"], st, "split/round-robin serve")
    if not 0 < launches["msl_onepass"] == pc["device_calls"]:
        raise AssertionError("msl_onepass launches != prefix-cache device calls")
    out = {"ticks": st["ticks"], "wall_s": wall, "decode_launches": st["decode_launches"],
           "host_syncs": st["host_syncs"], "launches": launches,
           "streams_equal": len(reqs) - len(ties), "near_ties": ties,
           "prefix_cache_device_calls": pc["device_calls"], "hit_ratio": pc["hit_ratio"],
           "prefill_computed": sum(r.prefill_computed for r in twin.finished),
           "prefill_skipped": sum(r.prefill_skipped for r in twin.finished)}
    log(f"split admission, round-robin decode: {out['streams_equal']} of {len(reqs)} "
        f"streams equal phase 8's, the rest split at near-ties; {st['ticks']} ticks "
        f"(in-flight {serving['ticks']}), {st['decode_launches']} decode launches, "
        f"{st['host_syncs']} host syncs, prefill computed {out['prefill_computed']} / "
        f"skipped {out['prefill_skipped']}; launches {launches}; prefix cache "
        f"{pc['device_calls']} device calls")
    return out

# ---------------------------------------------------------------------------
# Slice 6: the attention-decoder families through the paged kernel at their
# head dims and GQA ratios
# ---------------------------------------------------------------------------

# gemma3 (QK-norm, windows, Dh 32 and 256 on one KV head), starcoder2
# (LayerNorm, GeLU, a window, rep 9 at full width), command-r (LayerNorm,
# parallel block), qwen2-vl (M-RoPE), and the MoE decoders olmoe (QK-norm,
# 8 experts top-2 at smoke width) and phi3.5-moe (4 experts top-2, rep 2)
FAMILIES = ["gemma3-1b", "starcoder2-7b", "command-r-35b", "qwen2-vl-72b",
            "olmoe-1b-7b", "phi3.5-moe-42b-a6.6b"]


def release(torch):
    """Return the device memory of engines the caller has dropped."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def log_record(r):
    log(f"{r['name']} ({r.get('shape', {}).get('arch', '')}): {r['ms']:.5f} ms/launch on "
        f"the device (profiler, L2 flushed), {r['call_ms']:.5f} ms per wrapper call "
        f"(plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.5f} ms by {r['bound_by']}, "
        f"library {r['library_ms']} ms), {r['launches']} launches on the "
        f"{r['launches_path']}")


def windows_walked(eng, reqs):
    """The configuration's sliding windows and the longest row the serve
    decodes: a window binds when it is shorter than that row."""
    longest = max(len(r.prompt) + r.max_new_tokens for r in reqs)
    windows = sorted({w for w in eng.cfg.windows() if w > 0})
    return {"windows": windows, "longest_row": longest,
            "binding": [w for w in windows if w < longest]}


def run_family_smoke(torch, arch, err):
    """Phase 13, one family: its smoke config through the launcher's paged
    path on the card with phase 8's checks (every request served in full,
    no prefix copy, ``paged_attn`` = n_layers x decode launches,
    ``msl_onepass`` = prefix-cache device calls), then through a contiguous
    twin on the same weights (plain attention): the streams equal, or split
    at a near-tie (``near_ties``).  Returns the summary and the paged
    kernel's record at this path's shapes."""
    eng, reqs, summary, snapshot = run_serving(
        torch, serve_args("--arch", arch, "--kv-mode", "paged", smoke=True))
    twin = engine_twin(eng, kv_mode="contiguous")
    for r in fresh(reqs):
        twin.submit(r)
    twin.run_until_done()
    got = {rid: toks for rid, toks, _, _ in served(eng, reqs)}
    want = {rid: toks for rid, toks, _, _ in served(twin, reqs)}
    ties = near_ties(torch, eng, reqs, got, want)
    summary.update(windows_walked(eng, reqs), streams_equal_contiguous=len(reqs) - len(ties),
                   near_ties=ties)
    log(f"{eng.cfg.name}: H {eng.cfg.n_heads} on KVH {eng.cfg.n_kv_heads}, Dh "
        f"{eng.cfg.head_dim}, norm {eng.cfg.norm}, rope {eng.cfg.rope_kind}; windows "
        f"{summary['windows']} bind at rows of up to {summary['longest_row']} positions: "
        f"{summary['binding']}; {summary['streams_equal_contiguous']} of {len(reqs)} "
        f"streams equal the contiguous twin's, the rest split at near-ties")
    record = paged_record(torch, eng, snapshot, summary, err,
                          path=f"{eng.cfg.name} serving path")
    log_record(record)
    return summary, record


def run_full_width(torch, arch, err, buckets=()):
    """Phases 14-16: ``arch`` at its published width and depth (random
    weights from a seeded generator on the card; nothing cut) through the
    launcher's paged path with phase 8's checks, the paged kernel's record
    at its shapes and, given window ``buckets``, the megastep serve
    (``megastep_serve``; phase 11's buckets: the launcher's request mix
    plans the same windows for every architecture, since no stream ends
    early).  An MoE model adds its FFN's device time per decode step
    (``moe_ffn_step``).  Returns the summary and the record."""
    eng, reqs, summary, snapshot = run_serving(
        torch, serve_args("--arch", arch, "--kv-mode", "paged"))
    summary.update(windows_walked(eng, reqs))
    if eng.cfg.ffn == "moe":
        summary["moe_ffn"] = moe_ffn_step(torch, eng)
    record = paged_record(torch, eng, snapshot, summary, err,
                          path=f"{eng.cfg.name} serving path")
    if buckets:
        _, summary["megastep"] = megastep_serve(torch, eng, reqs, summary, buckets)
        record["launches_megastep_path"] = summary["megastep"]["launches"]["paged_attn"]
    summary["peak_memory_gb_all"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"{eng.cfg.name} at full width: {summary['ms_per_decode_tick']:.3f} ms per decode "
        f"tick, {summary['decode_tokens_per_s']:.1f} decode tokens/s, serve "
        f"{summary['wall_s']:.3f} s wall, decode_launches {summary['decode_launches']}, "
        f"host_syncs {summary['host_syncs']}, peak device memory "
        f"{summary['peak_memory_gb_all']:.2f} GB; paged_attn {record['ms']:.5f} ms per "
        f"launch (L2 flushed), {record['ms_in_path']:.5f} in the serving ticks, "
        f"H {eng.cfg.n_heads} on KVH {eng.cfg.n_kv_heads}, Dh {eng.cfg.head_dim}")
    log(f"{eng.cfg.name}: windows {summary['windows']} against rows of at most "
        f"{summary['longest_row']} positions: "
        f"{'binding ' + str(summary['binding']) if summary['binding'] else 'no window binds here'}")
    log_record(record)
    return summary, record

def moe_ffn_step(torch, eng):
    """The MoE FFN's device time per decode step: ``moe_decode`` of every
    layer on a decode tick's rows (B = slots, random hidden states), the sum
    of its kernels in the profiler over 10 steps, beside the bytes it must
    read (every expert's SwiGLU weights, bf16) and the whole step's weight
    read (every parameter but the embedding table)."""
    from repro_torch.models.moe import moe_decode

    cfg = eng.cfg
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 4)
    x = torch.randn((eng.slots, 1, cfg.d_model), generator=gen, device=DEVICE).to(
        torch.bfloat16)
    mlps = [p["mlp"] for p in eng.params["blocks"]]

    def step():
        for p in mlps:
            moe_decode(p, x, n_experts=cfg.n_experts, top_k=cfg.moe_top_k)

    kernels = profile_kernels(torch, step, 10)
    ms = sum(v[0] for v in kernels.values()) / 10 / 1e3
    expert_bytes = cfg.n_layers * cfg.n_experts * 3 * cfg.d_model * cfg.d_ff * 2
    step_bytes = (sum(p.numel() for p in eng.params.parameters())
                  - eng.params["head"]["embed"].numel()) * 2
    out = {"device_ms_per_step": ms, "kernels_per_step": sum(v[1] for v in kernels.values())
           / 10, "expert_bytes": expert_bytes,
           "expert_bound_ms": 1e3 * expert_bytes / HBM_BYTES_PER_S,
           "step_weight_bytes": step_bytes,
           "step_bound_ms": 1e3 * step_bytes / HBM_BYTES_PER_S}
    log(f"{cfg.name}: MoE FFN (moe_decode, {cfg.n_layers} layers, B {eng.slots}) "
        f"{ms:.4f} ms of device time per decode step in {out['kernels_per_step']:.0f} "
        f"kernels; its expert-weight read {expert_bytes / 1e9:.2f} GB is "
        f"{out['expert_bound_ms']:.3f} ms at {HBM_BYTES_PER_S / 1e12:.2f} TB/s (the whole "
        f"step's weight read {step_bytes / 1e9:.2f} GB, {out['step_bound_ms']:.3f} ms)")
    return out


# ---------------------------------------------------------------------------
# Slices 7 and 8: the families served contiguous through plain admission (the
# hymba hybrid, xLSTM, the Whisper encoder-decoder), their recurrent state
# frozen per row
# ---------------------------------------------------------------------------

HYMBA = "hymba-1.5b"
XLSTM = "xlstm-1.3b"
WHISPER = "whisper-medium"


def kept_leaves(eng):
    """The slot cache's leaves that no decode step may change for a row
    that does not emit: the recurrent state (``eng._state``: hymba's Mamba,
    every xLSTM leaf) and Whisper's cross-attention KV."""
    from repro_torch.serving.engine import CROSS_KV, _leaf

    return ([_leaf(eng.cache, path) for path, _ in eng._state]
            + [eng.cache[n] for n in CROSS_KV if n in eng.cache])


def written_kv(eng):
    """Each live row's KV up to its cur_len (meta tokens included): what a
    window's warm-up and capture must leave as it is."""
    if "k" not in eng.cache:
        return []
    return [eng.cache[n][:, r.slot, :int(eng.cur_len[r.slot]) + eng.cfg.meta_tokens]
            for r in eng.active.values() for n in ("k", "v")]


def freeze_ms(torch, eng):
    """The freeze's device time per decode step: ``freeze_rows`` over the
    slot cache's recurrent leaves, every other row emitting, from fresh
    copies of the leaves (as a decode step returns them), timed with CUDA
    events over 10 calls (a short profile of it drops kernel records);
    beside the bytes it must move (read the new and the old leaves, write
    the old) at the memory rate."""
    from repro_torch.serving.engine import _leaf, freeze_rows

    new = {}
    for path, _ in eng._state:
        t = new
        for name in path[:-1]:
            t = t.setdefault(name, {})
        t[path[-1]] = _leaf(eng.cache, path).clone()
    keep = torch.arange(eng.slots, device=DEVICE) % 2 == 0
    ms = time_ms(torch, lambda: freeze_rows(eng.cache, new, eng._state, keep), 10)
    state_bytes = sum(x.numel() * x.element_size() for x in kept_leaves(eng))
    out = {"device_ms_per_step": ms, "kernels_per_step": len(eng._state),
           "state_bytes": state_bytes,
           "bound_ms": 1e3 * 3 * state_bytes / HBM_BYTES_PER_S}
    log(f"{eng.cfg.name}: the freeze (freeze_rows, {len(eng._state)} leaves, one select "
        f"each, {state_bytes / 1e6:.1f} MB of state at {eng.slots} slots) {ms:.4f} ms "
        f"of device time per decode step (CUDA events); moving 3 x the state is "
        f"{out['bound_ms']:.4f} ms at {HBM_BYTES_PER_S / 1e12:.2f} TB/s")
    return out


def admission_ms(torch, eng, req):
    """One plain admission's prefill (B = 1, the launcher's first request)
    and, for an encoder-decoder, its encoder alone: device ms and kernels
    of one call (after a warm-up) from the profiler."""
    batch = {"tokens": torch.tensor(req.prompt[None], device=DEVICE)}
    if req.frames is not None:
        batch["frames"] = req.frames[None].to(DEVICE)
    out = {}
    calls = {"prefill": lambda: eng.model.prefill(eng.params, batch)}
    if eng.cfg.enc_dec:
        calls["encoder"] = lambda: eng.model.encode(eng.params, batch["frames"])
    for name, fn in calls.items():
        kernels = profile_kernels(torch, fn, 1)
        out[name] = {"device_ms": sum(v[0] for v in kernels.values()) / 1e3,
                     "kernels": sum(v[1] for v in kernels.values())}
        log(f"{eng.cfg.name}: {name} of one {len(req.prompt)}-token admission"
            + (f" over {eng.cfg.enc_len} frames" if name == "encoder" else "")
            + f": {out[name]['device_ms']:.3f} ms of device time in "
            f"{out[name]['kernels']:.0f} kernels")
    return out


def run_contiguous(torch, arch, smoke, roundrobin="near-tie"):
    """Phases 17-19: ``arch`` (hymba, xLSTM or Whisper) through ``serve.build``
    with the default ``--kv-mode contiguous``: plain admission, the prefix
    cache unused (``msl_onepass`` and ``paged_attn`` launch 0 times).  The
    launcher's requests in-flight, with the device's busy share, one
    admission's device time (and the encoder's) and the freeze's; then a
    megastep twin, whose window graphs are captured at first use mid-serve,
    each capture leaving the recurrent state, the cross-attention KV and the
    KV the live rows have written bit-equal, then a second serve through
    replays only (timed), and each captured window replayed alone, timed
    with CUDA events (its device time per step; its graph nodes per step are
    its kernels); then, unless ``roundrobin`` is None, a round-robin twin.  Megastep gives the in-flight tokens, ticks, finish order and
    prefill split exactly; round-robin the tokens, or (``roundrobin =
    "near-tie"``) differs only at a near-tie (``near_ties``); with
    ``"exact"`` a split is logged with its gap and fails."""
    from repro_torch.launch import serve

    args = serve_args("--arch", arch, smoke=smoke)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    eng = serve.build(args)
    torch.cuda.synchronize()
    cfg = eng.cfg
    n_params = sum(p.numel() for p in eng.params.parameters())
    kv_mb = sum(eng.cache[n].numel() * 2 for n in ("k", "v") if n in eng.cache) / 1e6
    kept_mb = sum(x.numel() * x.element_size() for x in kept_leaves(eng)) / 1e6
    log(f"{cfg.name}: {n_params / 1e9:.3f}B parameters ({n_params * 2 / 1e9:.2f} GB bf16), "
        f"{cfg.meta_tokens} meta tokens, slot KV {kv_mb:.0f} MB, recurrent state and "
        f"cross-attention KV {kept_mb:.1f} MB ({kept_mb / eng.slots:.1f} MB per slot); "
        f"built in {time.perf_counter() - t:.1f} s")
    reqs = serve.make_requests(cfg, args)
    zero_launches()
    wall, decode_ticks, _ = serve_requests(torch, eng, reqs)
    launches = read_launches()
    st, pc = eng.stats(), eng.prefix_cache.stats()
    if len(eng.finished) != len(reqs) or any(len(r.out_tokens) != args.max_new
                                             for r in eng.finished):
        raise AssertionError("not every request was served in full")
    if any(launches.values()) or pc["device_calls"] or any(r.prefill_skipped
                                                           for r in eng.finished):
        raise AssertionError(f"{cfg.name} reached the prefix cache or a kernel: {launches}, "
                             f"{pc['device_calls']} prefix-cache calls")
    dec_s = sum(s for s, _ in decode_ticks)
    longest = max(len(r.prompt) + r.max_new_tokens for r in reqs) + cfg.meta_tokens
    windows = sorted({w for w in cfg.windows() if w > 0})
    summary = {
        "arch": cfg.name, "params": n_params, "requests": len(reqs),
        "finished": len(eng.finished), "ticks": st["ticks"], "wall_s": wall,
        "ms_per_decode_tick": 1e3 * dec_s / len(decode_ticks),
        "decode_tokens_per_s": sum(n for _, n in decode_ticks) / dec_s,
        "decode_launches": st["decode_launches"], "host_syncs": st["host_syncs"],
        "prefill_computed": sum(r.prefill_computed for r in eng.finished),
        "launches": launches, "prefix_cache_device_calls": pc["device_calls"],
        "state_and_cross_kv_bytes": int(kept_mb * 1e6),
    }
    if windows:
        summary.update(windows=windows, longest_row=longest,
                       binding=[w for w in windows if w < longest])
    log(f"served {len(eng.finished)}/{len(reqs)} requests in {st['ticks']} ticks, "
        f"{wall:.3f} s wall: {summary['ms_per_decode_tick']:.3f} ms per decode tick, "
        f"{summary['decode_tokens_per_s']:.1f} decode tokens/s, decode_launches "
        f"{st['decode_launches']}, host_syncs {st['host_syncs']}; launches {launches}, "
        f"prefix cache {pc['device_calls']} device calls")
    summary["device"] = busy_share(torch, eng, fresh(reqs, 1000))
    summary["admission"] = admission_ms(torch, eng, reqs[0])
    if eng._state:
        summary["freeze"] = freeze_ms(torch, eng)

    twin = engine_twin(eng, kv_mode="contiguous", decode_mode="megastep")
    captures, capture = [], twin.capture_window

    def checked_capture(steps, inputs=None):
        before = [x.clone() for x in kept_leaves(twin) + written_kv(twin)]
        torch.cuda.synchronize()
        t = time.perf_counter()
        win = capture(steps, inputs)
        torch.cuda.synchronize()
        equal = all(torch.equal(a, b) for a, b in
                    zip(before, kept_leaves(twin) + written_kv(twin)))
        captures.append({"steps": steps, "ms": 1e3 * (time.perf_counter() - t),
                         "nodes": graph_nodes(win.graph), "live_rows": len(twin.active),
                         "state_equal": equal})
        log(f"captured the {steps}-step window mid-serve ({len(twin.active)} live rows): "
            f"{captures[-1]['ms']:.1f} ms, {captures[-1]['nodes']} graph nodes; recurrent "
            f"state, cross KV and written KV {'bit-equal' if equal else 'CHANGED'} after "
            f"the warm-up and capture")
        if not equal:
            raise AssertionError("a window graph's capture changed the slot cache")
        return win

    twin.capture_window = checked_capture
    serve_windows(torch, twin, fresh(reqs))              # captures at first use
    twin.capture_window = capture
    if not captures:
        raise AssertionError("the megastep serve captured no window graph")
    if served(twin, reqs) != served(eng, reqs) or twin.ticks != st["ticks"]:
        raise AssertionError("megastep tokens, finish order, prefill split or ticks "
                             "differ from the in-flight serve")
    keys = ("ticks", "decode_launches", "host_syncs", "megastep_windows", "megastep_steps")
    before = twin.stats()
    zero_launches()
    mwall, wins = serve_windows(torch, twin, fresh(reqs, 2000))
    if any(read_launches().values()):
        raise AssertionError("the megastep serve launched a kernel")
    d = {k: twin.stats()[k] - before[k] for k in keys}
    again = [(rid - 2000, *rest) for rid, *rest in served(twin, fresh(reqs, 2000))]
    if again != served(eng, reqs) or d["ticks"] != st["ticks"]:
        raise AssertionError("the replayed megastep serve differs from the in-flight one")
    replay_ms = {}
    for c in captures:
        replay_ms[c["steps"]] = c["replay_ms"] = time_ms(
            torch, twin.window_graphs[c["steps"]].graph.replay, 5)
    win_s, win_ticks = sum(w[0] for w in wins), sum(w[1] for w in wins)
    big = max(captures, key=lambda c: c["steps"])
    summary["megastep"] = {
        **d, "wall_s": mwall, "graphs": captures,
        "ms_per_decode_tick": 1e3 * win_s / win_ticks,
        "decode_tokens_per_s": sum(w[2] for w in wins) / win_s,
        "masked_step_share": 1 - win_ticks / d["megastep_steps"],
        "kernels_per_step": big["nodes"] / big["steps"],
        "busy_ms_per_step": big["replay_ms"] / big["steps"],
        "busy_share": sum(replay_ms[w[3]] for w in wins) / (1e3 * win_s)}
    log(f"megastep: the in-flight tokens, ticks, finish order and prefill split; "
        f"{summary['megastep']['ms_per_decode_tick']:.3f} ms per decode tick, "
        f"{summary['megastep']['decode_tokens_per_s']:.1f} tokens/s, serve {mwall:.3f} s "
        f"wall, {d['decode_launches']} decode launches and {d['host_syncs']} host syncs "
        f"(in-flight {st['decode_launches']} and {st['host_syncs']}), "
        f"{d['megastep_windows']} windows over {d['megastep_steps']} steps; a window "
        f"replayed alone: {summary['megastep']['kernels_per_step']:.0f} graph nodes and "
        f"{summary['megastep']['busy_ms_per_step']:.3f} ms of device time per step, busy "
        f"share of the windows {summary['megastep']['busy_share']:.3f}")

    if roundrobin is not None:
        rr = engine_twin(eng, kv_mode="contiguous", decode_mode="roundrobin")
        for r in fresh(reqs):
            rr.submit(r)
        torch.cuda.synchronize()
        t = time.perf_counter()
        rr.run_until_done()
        torch.cuda.synchronize()
        got = {rid: toks for rid, toks, _, _ in served(rr, reqs)}
        want = {rid: toks for rid, toks, _, _ in served(eng, reqs)}
        if sorted(got) != sorted(want) or any(len(got[r]) != len(want[r]) for r in want):
            raise AssertionError("round-robin did not serve every request in full")
        ties = near_ties(torch, eng, reqs, got, want)
        if roundrobin == "exact" and ties:
            raise AssertionError(f"round-robin tokens differ from the in-flight serve's: {ties}")
        summary["roundrobin"] = {"ticks": rr.ticks, "wall_s": time.perf_counter() - t,
                                 "decode_launches": rr.decode_launches,
                                 "streams_equal": len(reqs) - len(ties), "near_ties": ties}
        log(f"round-robin: {summary['roundrobin']['streams_equal']} of {len(reqs)} streams "
            f"equal the in-flight serve's; {rr.ticks} ticks, {rr.decode_launches} decode "
            f"launches")
        del rr
    summary["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if "windows" in summary:
        log(f"{cfg.name}: windows {windows} against rows of at most {longest} positions "
            f"(meta tokens included): " + (f"binding {summary['binding']}"
                                           if summary["binding"] else "no window binds here"))
    log(f"{cfg.name}: peak device memory {summary['peak_memory_gb']:.2f} GB, busy share "
        f"{summary['device']['busy_share']:.3f} in-flight, "
        f"{summary['device']['kernels_per_tick']:.0f} kernels per in-flight tick")
    return summary

# ---------------------------------------------------------------------------
# Slice 9: the sharded cache (D logical shards on the card) and the serving
# engine's sheds, retries, split placement, throttling and fault plans
# ---------------------------------------------------------------------------

SHARDS = 8
# phase 21's bounded serve: FaultPlan.seeded(28, ticks=24, ndev=8) resizes to
# 7 shards at ticks 6 and 16 (a table padded with EMPTY sets) and loses shard
# 1 at tick 20; at cap 2 the launcher's requests shed whole chains and chunk
# suffixes, split chains over slabs, throttle admissions and fall back
BOUNDED = ("--sharded", str(SHARDS), "--cap", "2", "--placement", "split",
           "--throttle-threshold", "0.75", "--chaos-seed", "28")


def sharded_step_profile(torch, cfg, mesh, table, keys, vals, first, n=16):
    """The device's idle share over ``n`` sharded batches (one-pass, cap
    full, updating ``table`` in place) from batch ``first``: the profiler's
    kernels against the wall time of the same batches."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import pad_dummy_row
    from repro_torch.core.sharded import make_sharded_engine

    run = make_sharded_engine(cfg, mesh, cap="full", engine="onepass", in_place=True)
    table = pad_dummy_row(table)
    run(table, keys[:BATCH], vals[:BATCH])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for i in range(first, first + n):
            q = slice(i * BATCH, (i + 1) * BATCH)
            run(table, keys[q], vals[q])
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t)
    kernels = cuda_kernels(torch, prof)
    busy_ms = sum(v[0] for v in kernels.values()) / 1e3
    return {"busy_ms_per_batch": busy_ms / n, "wall_ms_per_batch_profiled": wall_ms / n,
            "kernels_per_batch": sum(v[1] for v in kernels.values()) / n,
            "idle_share": 1.0 - busy_ms / wall_ms}


def host_pace_ab(torch, cfg, mesh, table, keys, vals, first, blocks=8, per=32):
    """Like for like, in one phase: the local cache (phase 5's path) and the
    one-pass sharded engine (cap full) over the same ``blocks * per``
    batches from batch ``first``, alternating blocks of ``per``, each on
    its own copy of ``table``.  Returns wall ms per batch of each."""
    from repro_torch.core import MultiStepLRUCache, pad_dummy_row
    from repro_torch.core.sharded import make_sharded_engine, shard_table

    local = MultiStepLRUCache(cfg, device=DEVICE)
    local.load_table(table)
    run = make_sharded_engine(cfg, mesh, cap="full", engine="onepass", in_place=True)
    padded = pad_dummy_row(shard_table(table, mesh))
    qk = keys[:, None]
    seconds = {"local": 0.0, "sharded": 0.0}
    for b in range(blocks):
        for name in seconds:
            torch.cuda.synchronize()
            t = time.perf_counter()
            for i in range(first + b * per, first + (b + 1) * per):
                q = slice(i * BATCH, (i + 1) * BATCH)
                if name == "local":
                    local.access(keys[q], vals[q])
                else:
                    run(padded, qk[q], vals[q])
            torch.cuda.synchronize()
            seconds[name] += time.perf_counter() - t
    return {f"{k}_ms_per_batch": 1e3 * v / (blocks * per) for k, v in seconds.items()}


def run_sharded_cache(torch, cfg, keys, vals, stream_table, main):
    """Phase 20: the sharded engine with ``SHARDS`` logical shards on the
    card at the main path's size.  The one-pass stream runner over phase
    5's stream must leave phase 5's table bit for bit, with phase 5's hits
    over the timed half; on the batches after the stream, from that table,
    the one-pass and rounds sharded engines (each through its kernel) must
    give the local cache's results and table; at cap 2.0 the admitted rows
    must give what the local cache gives fed only them; one batch at D = 7
    (a padded table) must give the local cache's.  Launches are counted on
    the stream, from zero just before it to just after."""
    from repro_torch.core import EMPTY_KEY, MultiStepLRUCache, init_table
    from repro_torch.core.sharded import (make_sharded_engine, make_sharded_stream_runner,
                                          shard_table)
    from repro_torch.launch.mesh import make_cache_mesh

    n_batches = keys.numel() // BATCH - CHECK_BATCHES
    half = n_batches // 2
    mesh = make_cache_mesh(SHARDS, device=DEVICE)
    stream = make_sharded_stream_runner(cfg, mesh, cap="full", batch=BATCH,
                                        engine="onepass")
    qk, qv = keys[:, None], vals
    table = shard_table(init_table(cfg, DEVICE), mesh)
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    table, _, _ = stream(table, qk[: half * BATCH], qv[: half * BATCH])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    table, hits, served = stream(table, qk[half * BATCH: n_batches * BATCH],
                                 qv[half * BATCH: n_batches * BATCH])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = read_launches()
    timed = (n_batches - half) * BATCH
    if not torch.equal(table, stream_table):
        raise AssertionError("the sharded one-pass table differs from phase 5's")
    if int(hits) != main["hits"] or int(served) != timed:
        raise AssertionError(f"sharded hits {int(hits)} (served {int(served)}) != phase 5's "
                             f"{main['hits']} over the timed half")
    if launches["msl_onepass"] != n_batches:
        raise AssertionError(f"{launches['msl_onepass']} msl_onepass launches for "
                             f"{n_batches} batches")
    out = {"shards": SHARDS, "batches": n_batches, "timed_queries": timed,
           "seconds": t2 - t1, "qps": timed / (t2 - t1),
           "ms_per_batch": 1e3 * (t2 - t1) / (n_batches - half),
           "warm_seconds": t1 - t0, "hit_ratio": int(hits) / timed,
           "launches_stream": launches,
           "launches_per_batch": {k: v / n_batches for k, v in launches.items()}}
    log(f"D = {SHARDS} shards, cap full, one-pass: {n_batches} batches; table bit-equal "
        f"to phase 5's, {int(hits)} hits over the timed half as phase 5; "
        f"{out['qps']:.4g} queries/s, {out['ms_per_batch']:.4f} ms/batch (phase 5 "
        f"{main['ms_per_batch']:.4f}), launches per batch {out['launches_per_batch']}")

    # the batches after the stream, from phase 5's post-stream table
    check = [slice(i * BATCH, (i + 1) * BATCH) for i in range(n_batches, n_batches + 4)]
    local = MultiStepLRUCache(cfg, device=DEVICE)
    local.load_table(stream_table)
    want = [local.access(keys[q], vals[q]) for q in check]
    for engine in ("onepass", "rounds"):
        run = make_sharded_engine(cfg, mesh, cap="full", engine=engine)
        t = stream_table.clone()
        zero_launches()
        for q, w in zip(check, want):
            t, hit, val, srv = run(t, qk[q], qv[q])
            if not (torch.equal(hit, w.hit) and bool(srv.all())
                    and torch.equal(val[hit], w.value[w.hit])):
                raise AssertionError(f"sharded {engine} results differ from the local cache")
        out[f"launches_{engine}_check"] = read_launches()
        if not torch.equal(t, local.table):
            raise AssertionError(f"sharded {engine} table differs from the local cache")
    if out["launches_rounds_check"]["msl_access"] == 0:
        raise AssertionError("the sharded rounds engine did not launch msl_access")
    log(f"one-pass and rounds sharded engines == local cache on {len(check)} batches "
        f"after the stream (results, table); launches {out['launches_onepass_check']} / "
        f"{out['launches_rounds_check']}")

    # bounded caps on the first batch: shed rows as if absent
    q0 = slice(0, BATCH)
    full = MultiStepLRUCache(cfg, device=DEVICE).access(keys[q0], vals[q0])
    for cap in (2.0, 1.0):
        bounded = make_sharded_engine(cfg, mesh, cap=cap, engine="onepass")
        t, hit, val, srv = bounded(shard_table(init_table(cfg, DEVICE), mesh), qk[q0], qv[q0])
        cold = MultiStepLRUCache(cfg, device=DEVICE)
        w = cold.access(keys[q0][srv], vals[q0][srv])
        if not (torch.equal(hit[srv], w.hit) and torch.equal(val[srv][w.hit], w.value[w.hit])
                and torch.equal(t, cold.table) and not bool(hit[~srv].any())):
            raise AssertionError(f"cap {cap}: admitted rows differ from the local cache fed them")
        same = int(((hit == full.hit) & srv).sum())
        out[f"cap{cap:g}"] = {"shed_rate": 1.0 - float(srv.float().mean()),
                              "admitted": int(srv.sum()), "admitted_equal_full_cap": same}
        log(f"cap {cap}, first batch: shed rate {out[f'cap{cap:g}']['shed_rate']:.4f}; the "
            f"{int(srv.sum())} admitted rows == the local cache fed only them (results, "
            f"table); {same} of them hit as under cap full (a row whose earlier same-key "
            f"row shed misses instead)")
        del t, cold

    # D = 7: a padded table
    mesh7 = make_cache_mesh(7, device=DEVICE)
    q7 = slice(n_batches * BATCH, n_batches * BATCH + 7 * (BATCH // 7))
    local7 = MultiStepLRUCache(cfg, device=DEVICE)
    local7.load_table(stream_table)
    w7 = local7.access(keys[q7], vals[q7])
    t7 = shard_table(stream_table, mesh7)
    t7, hit, val, _ = make_sharded_engine(cfg, mesh7, cap="full", engine="onepass")(
        t7, qk[q7], qv[q7])
    if not (torch.equal(hit, w7.hit) and torch.equal(t7[: cfg.num_sets], local7.table)
            and bool((t7[cfg.num_sets:, :, 0] == EMPTY_KEY).all())):
        raise AssertionError("D = 7 differs from the local cache")
    out["d7"] = {"rows": int(t7.shape[0]), "padded_sets": int(t7.shape[0]) - cfg.num_sets}
    log(f"D = 7: {t7.shape[0]} table rows ({out['d7']['padded_sets']} EMPTY padded sets); "
        f"one batch of {q7.stop - q7.start} == the local cache")
    del t7, local7, local

    out["ab"] = host_pace_ab(torch, cfg, mesh, stream_table, keys, vals, half)
    log(f"like for like over {8 * 32} batches in alternating blocks: local cache "
        f"{out['ab']['local_ms_per_batch']:.4f} ms per batch, sharded "
        f"{out['ab']['sharded_ms_per_batch']:.4f}")
    out["device"] = sharded_step_profile(torch, cfg, mesh, table, qk, qv, half)
    log(f"device per sharded batch: busy {out['device']['busy_ms_per_batch']:.4f} ms in "
        f"{out['device']['kernels_per_batch']:.1f} kernels, idle share "
        f"{out['device']['idle_share']:.3f} of {out['device']['wall_ms_per_batch_profiled']:.4f} "
        f"ms (phase 5: {main['device']['kernels_per_batch']:.1f} kernels, idle "
        f"{main['device']['idle_share']:.3f})")
    return out


def timed_backend(backend, ms):
    """Record the host ms of every ``access`` of ``backend`` (placement,
    packing, the engine call and its result fetch) and of its placement
    alone into ``ms`` ("access", "placement")."""
    for name, key in (("access", "access"), ("_place_split", "placement"),
                      ("_place_whole", "placement")):
        inner = getattr(backend, name)

        def wrapped(*a, _inner=inner, _key=key, **k):
            t = time.perf_counter()
            try:
                return _inner(*a, **k)
            finally:
                ms[_key].append(1e3 * (time.perf_counter() - t))

        setattr(backend, name, wrapped)


def serve_with_faults(torch, eng, reqs, plan):
    """``run_until_done(fault_plan=plan)`` step by step: the wall time and,
    for each step that admitted nothing (a pure-decode tick or a megastep
    window), its seconds and the ticks it covered."""
    for r in reqs:
        eng.submit(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    decode_ticks = []
    while eng.queue or eng.retry_queue or eng.active or eng._pending_inserts:
        cap = None
        if plan is not None:
            for ev in plan.pop_due(eng.ticks):
                eng.apply_fault(ev)
            nxt = plan.next_tick()
            if nxt is not None:
                cap = nxt - eng.ticks
        queued, retried, ticks = len(eng.queue), len(eng.retry_queue), eng.ticks
        t = time.perf_counter()
        eng.step(window_cap=cap)
        if len(eng.queue) == queued and len(eng.retry_queue) == retried == 0:
            decode_ticks.append((time.perf_counter() - t, eng.ticks - ticks))
    torch.cuda.synchronize()
    return time.perf_counter() - t0, decode_ticks


def sharded_serve(torch, args, reqs, plan=None, buckets=()):
    """One serve of ``reqs`` through ``serve.build(args)`` (the weights made
    from ``--seed`` anew), launches counted from zero just before it to just
    after (a megastep engine's window ``buckets`` captured first, as in
    phase 11).  Returns the engine and the serve's numbers (the
    shed/split/throttle stats among them; megastep: the windows a fault's
    tick capped below what ``_plan_window`` plans without the cap)."""
    from repro_torch.launch import serve

    eng = serve.build(args)
    plans = []
    if eng.decode_mode == "megastep":
        for steps in buckets:
            eng.capture_window(steps)
        plan_window = eng._plan_window

        def recording(cap=None):
            k = plan_window(cap)
            plans.append((k, plan_window(None)))
            return k

        eng._plan_window = recording
    captured = set(eng.window_graphs)
    ms = {"access": [], "placement": []}
    timed_backend(eng.prefix_cache.cache, ms)
    zero_launches()
    wall, decode_ticks = serve_with_faults(torch, eng, fresh(reqs), plan)
    launches = read_launches()
    st, pc = eng.stats(), eng.prefix_cache.stats()
    pool = eng.pool
    dec_s = sum(s for s, _ in decode_ticks)
    dec_ticks = sum(k for _, k in decode_ticks)
    out = {"ticks": st["ticks"], "wall_s": wall, "finished": len(eng.finished),
           "fault_log": [list(x) for x in eng.fault_log], "launches": launches,
           "fault_capped_windows": sum(k < free for k, free in plans),
           "ms_per_decode_tick": 1e3 * dec_s / max(1, dec_ticks),
           "decode_only_ticks": dec_ticks,
           "cache_calls": len(ms["access"]),
           "prefix_cache_calls": pc["device_calls"],
           "host_ms_per_cache_call": sum(ms["access"]) / max(1, len(ms["access"])),
           "placement_ms_per_cache_call": sum(ms["placement"]) / max(1, len(ms["access"])),
           "leaked_pages": pool.n_pages - pool.free_pages - int(pool.refcount.sum()),
           "reserved_pages": len(pool._reserved), "pending_inserts": len(eng._pending_inserts),
           "prefill_computed": sum(r.prefill_computed for r in eng.finished),
           "prefill_skipped": sum(r.prefill_skipped for r in eng.finished),
           "stats": {k: st[k] for k in ("decode_launches", "host_syncs", "fallbacks",
                                         "fallback_rate", "partial_served", "partial_sheds",
                                         "split_chains", "slab_occupancy_peak",
                                         "throttled_admissions", "megastep_windows")},
           "prefix_cache": {k: pc[k] for k in ("hits", "misses", "shed", "retried",
                                                "fallbacks", "device_calls")},
           "backend": {"ndev": eng.prefix_cache.cache.ndev,
                       "sheds": eng.prefix_cache.cache.sheds,
                       "shed_groups": eng.prefix_cache.cache.shed_groups,
                       "degraded_sheds": eng.prefix_cache.cache.degraded_sheds,
                       "fault_sheds": eng.prefix_cache.cache.fault_sheds}}
    if out["finished"] != len(reqs) or any(len(r.out_tokens) != r.max_new_tokens
                                           for r in eng.finished):
        raise AssertionError("a request was dropped or cut short")
    if out["leaked_pages"] or out["reserved_pages"] or out["pending_inserts"]:
        raise AssertionError(f"the pool did not balance: {out}")
    # one engine call per client access: the prefix cache's calls and a
    # reshard's drain and re-insert sweeps
    if not 0 < launches["msl_onepass"] == out["cache_calls"]:
        raise AssertionError(f"{launches['msl_onepass']} msl_onepass launches for "
                             f"{out['cache_calls']} client engine calls")
    # a window graph captured at its first use, mid-serve, runs one eager
    # warm-up of the window first: those launches are on the path too
    out["warmup_paged_attn"] = sum(w.launches["paged_attn"] for k, w in
                                   eng.window_graphs.items() if k not in captured)
    check_launches(eng, launches["paged_attn"] - out["warmup_paged_attn"], st,
                   "sharded serve")
    return eng, out


def run_sharded_serving(torch, phase8, buckets):
    """Phase 21: phi3-mini-3.8b at full width and depth, paged, behind a
    ``ShardedCacheClient`` of ``SHARDS`` logical shards, through
    ``serve.build`` with ``--sharded`` (every serve builds its engine anew,
    the weights from the seed): at cap full in-flight and megastep (phase
    8's tokens, ticks and prefill split, or a near-tie split; the megastep
    serve with phase 11's window ``buckets`` captured first), then the
    bounded, split-placed, throttled serve under a seeded fault plan, twice
    in-flight (the same faults, counters and tokens both times) and once
    megastep (the in-flight serve's ticks, faults and counters, with at
    least one window capped at a fault's tick): every request completes, no
    page leaks, and the tokens equal phase 8's or split at a near-tie."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    torch.cuda.reset_peak_memory_stats()
    want = {rid: toks for rid, toks, _, _ in phase8["served"]}
    args = serve_args("--kv-mode", "paged")
    reqs = serve.make_requests(get_config(args.arch, smoke=args.smoke), args)
    out = {}
    for name, extra in (("full_inflight", ()), ("full_megastep", ("--decode-mode", "megastep"))):
        args = serve_args("--kv-mode", "paged", "--sharded", str(SHARDS), *extra)
        eng, rec = sharded_serve(torch, args, reqs, buckets=buckets)
        got = served(eng, reqs)
        rec["equal_phase8"] = got == phase8["served"] and rec["ticks"] == phase8["ticks"]
        if not rec["equal_phase8"]:
            if rec["ticks"] != phase8["ticks"] or [(a, c, d) for a, _, c, d in got] != \
                    [(a, c, d) for a, _, c, d in phase8["served"]]:
                raise AssertionError(f"{name}: ticks, finish order or prefill split differ "
                                     "from phase 8's")
            rec["near_ties"] = near_ties(torch, eng, reqs, {r: t for r, t, _, _ in got}, want)
        log(f"{name}: {rec['ticks']} ticks, tokens {'equal' if rec['equal_phase8'] else 'near-tie'} "
            f"phase 8's, {rec['ms_per_decode_tick']:.3f} ms per decode tick, "
            f"{rec['host_ms_per_cache_call']:.3f} host ms per cache call over "
            f"{rec['cache_calls']} calls; launches {rec['launches']}")
        out[name] = rec
        del eng
        release(torch)

    runs = []
    for i, mode in enumerate(("inflight", "inflight", "megastep")):
        bargs = serve_args("--kv-mode", "paged", *BOUNDED, "--decode-mode", mode)
        eng, rec = sharded_serve(torch, bargs, reqs, serve.fault_plan(bargs), buckets)
        got = {rid: toks for rid, toks, _, _ in served(eng, reqs)}
        rec["tokens"] = got
        rec["near_ties"] = near_ties(torch, eng, reqs, got, want)
        runs.append(rec)
        log(f"bounded run {i + 1} ({mode}): {rec['ticks']} ticks, faults {rec['fault_log']}, "
            f"{rec['stats']}, prefix cache {rec['prefix_cache']}, backend "
            f"{rec['backend']}; {len(reqs) - len(rec['near_ties'])} of {len(reqs)} streams "
            f"equal phase 8's, the rest near-ties; {rec['fault_capped_windows']} windows "
            f"capped at a fault's tick; {rec['ms_per_decode_tick']:.3f} ms per decode tick, "
            f"{rec['host_ms_per_cache_call']:.3f} host ms per cache call "
            f"({rec['placement_ms_per_cache_call']:.3f} of it placement); launches "
            f"{rec['launches']}")
        del eng
        release(torch)
    keys = ("ticks", "fault_log", "stats", "prefix_cache", "backend", "tokens",
            "prefill_computed", "prefill_skipped", "launches")
    if any(runs[0][k] != runs[1][k] for k in keys):
        raise AssertionError("the bounded serve did not repeat: " + ", ".join(
            k for k in keys if runs[0][k] != runs[1][k]))
    if len(runs[0]["fault_log"]) != 3 or runs[0]["prefix_cache"]["shed"] == 0:
        raise AssertionError("the fault plan or the sheds did not happen")
    # megastep decodes the same ticks in fewer launches: every count but
    # the decode launches, host syncs and windows equals in-flight's
    decode_keys = ("decode_launches", "host_syncs", "megastep_windows")
    mega, inflight = runs[2], runs[0]
    same = ["ticks", "fault_log", "prefix_cache", "backend", "prefill_computed",
            "prefill_skipped"]
    if any(mega[k] != inflight[k] for k in same) or any(
            mega["stats"][k] != inflight["stats"][k] for k in mega["stats"]
            if k not in decode_keys):
        raise AssertionError("the bounded megastep serve differs from in-flight's: " + ", ".join(
            k for k in same if mega[k] != inflight[k]))
    if not mega["stats"]["megastep_windows"] or not mega["fault_capped_windows"]:
        raise AssertionError("no megastep window ran, or none was capped at a fault's tick")
    for r in runs:
        del r["tokens"]
    out["bounded"] = runs[0]
    out["bounded_repeat_wall_s"] = runs[1]["wall_s"]
    out["bounded_megastep"] = mega
    out["args"] = list(BOUNDED)
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"bounded serve repeated exactly (faults, counters, tokens), megastep as in-flight; "
        f"peak device memory {out['peak_memory_gb']:.2f} GB")
    return out

# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# Training (phases 22-24): the port's trainer on the card
# ---------------------------------------------------------------------------

# card against the machine's CPU (the port's plain path), one step from the
# same parameters and batch: the CPU tests' bounds against the JAX package
LOSS_RTOL = 2 ** -12        # the loss and its metrics, relative
NORM_RTOL = 2 ** -8         # the global gradient norm, relative
GRAD_ULPS = 16              # m = 0.1 x the clipped gradient: bf16 ulps of a leaf's max
# AdamW on the card against the CPU's, on the CPU step's own gradients and
# state: the card's f32 sums of squares in another order than the CPU's
NORM_SUM_RTOL = 2 ** -16
ADAMW_ULPS = 1              # master, m and v, given the same norm (both sqrt IEEE)
BF16_PEAK = 989e12          # H100 SXM dense bf16 FLOP/s at 700 W
PHI3 = "phi3-mini-3.8b"
FULL_STEPS = 6              # phase 23(b): steps at full width and depth
SMOKE_STEPS = 300           # phase 24: the train_smoke example's run
SMOKE_RESUME = 200          # ... resumed from this step's checkpoint


def train_args(*extra):
    """The training launcher's arguments on the card (a later ``--device``
    wins)."""
    from repro_torch.launch import train

    return train.parser().parse_args(["--device", DEVICE, *extra])


def twin(torch, src, args, cfg=None):
    """A trainer built from ``args`` (another device, or microbatches) with
    ``src``'s parameters and a fresh optimizer state."""
    from repro_torch.launch import train
    from repro_torch.train.optimizer import adamw_init

    tr, _ = train.build(args, cfg)
    tr.init_state(resume=False)
    with torch.no_grad():
        for p, q in zip(src.params.parameters(), tr.params.parameters()):
            q.copy_(p.to(q.device))
    tr.opt_state = adamw_init(tr.params)
    return tr


def step_once(torch, tr, data):
    """One step of ``tr`` on ``data.batch(0)``: (metrics as floats, the
    first moment m by parameter name, wall ms)."""
    batch = {k: torch.from_numpy(v).to(tr.device) for k, v in data.batch(0).items()}
    t = time.perf_counter()
    tr.params, tr.opt_state, metrics = tr.bundle.fn(tr.params, tr.opt_state, batch)
    out = {k: float(v) for k, v in metrics.items()}       # waits for the step
    return out, tr.opt_state.m, (time.perf_counter() - t) * 1e3


@contextlib.contextmanager
def recorded_update(torch):
    """Records what the next ``adamw_update`` call takes (gradients, state,
    parameters, copied to the host before it writes them) and what it gives
    (the new state, parameters and norm), into the dict it yields."""
    from repro_torch.train import optimizer as opt_mod

    update, rec = opt_mod.adamw_update, {}

    def host(tree):
        return {n: x.detach().to("cpu", copy=True) for n, x in opt_mod.leaves(tree).items()}

    def recording(grads, opt, params, **kw):
        rec.update(grads=host(grads), params=host(params), kw=kw,
                   state=opt._replace(step=opt.step.cpu(), master=host(opt.master),
                                      m=host(opt.m), v=host(opt.v)))
        out = update(grads, opt, params, **kw)
        rec.update(new_params=host(out[0]), new_state=out[1], norm=out[2]["grad_norm"])
        return out

    opt_mod.adamw_update = recording
    try:
        yield rec
    finally:
        opt_mod.adamw_update = update


def _f32_ulps(torch, a, b):
    """The largest distance in f32 ulps between two f32 tensors (their bits
    as ordered integers, so that -0 and +0 are one value)."""
    def ordered(x):
        i = x.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int((ordered(a) - ordered(b)).abs().max()) if a.numel() else 0


def card_update(torch, rec, what):
    """The CPU step's AdamW update again on the card, from the gradients,
    state and parameters it took, moved there.  The card's global norm of
    those gradients is within NORM_SUM_RTOL of the CPU's; given the CPU's
    norm, the card's master, m and v are within ADAMW_ULPS f32 ulps of the
    CPU's and its new parameters equal them.  Returns the gaps."""
    from repro_torch.train import optimizer as opt_mod

    def card(tree):
        return {n: x.to(DEVICE) for n, x in tree.items()}

    grads, st = card(rec["grads"]), rec["state"]
    cpu_norm = float(rec["norm"])
    norm_rel = abs(float(opt_mod.global_norm(grads)) / cpu_norm - 1)
    if norm_rel > NORM_SUM_RTOL:
        raise AssertionError(f"{what}: the card's gradient norm is {norm_rel:.2e} from the CPU's")
    state = st._replace(step=st.step.to(DEVICE), master=card(st.master), m=card(st.m),
                        v=card(st.v))
    params = card(rec["params"])
    global_norm = opt_mod.global_norm
    opt_mod.global_norm = lambda tree: torch.tensor(cpu_norm, dtype=torch.float32,
                                                    device=DEVICE)
    try:
        _, state, _ = opt_mod.adamw_update(grads, state, params, **rec["kw"])
    finally:
        opt_mod.global_norm = global_norm
    want = rec["new_state"]
    worst = {f: max(_f32_ulps(torch, getattr(want, f)[n], getattr(state, f)[n].cpu())
                    for n in grads) for f in ("master", "m", "v")}
    if max(worst.values()) > ADAMW_ULPS or int(state.step) != int(want.step):
        raise AssertionError(f"{what}: AdamW on the card {worst} f32 ulps from the CPU's")
    for n, p in params.items():
        if not torch.equal(p.cpu(), rec["new_params"][n]):
            raise AssertionError(f"{what}: parameter {n} after AdamW differs from the CPU's")
    return {"adamw_norm_rel": norm_rel, "adamw_ulps": worst}


def compare_steps(torch, want, got, what):
    """Raises unless ``got``'s step (metrics, m) is ``want``'s within the
    bounds above; returns the gaps."""
    (wm, wmom, _), (gm, gmom, _) = want, got
    gaps = {"loss_rel": abs(gm["loss"] / wm["loss"] - 1),
            "grad_norm_rel": abs(gm["grad_norm"] / wm["grad_norm"] - 1)}
    for k in ("loss", "ce_loss", "lb_loss", "z_loss", "drop_frac"):
        if abs(gm[k] - wm[k]) > LOSS_RTOL * abs(wm[k]):
            raise AssertionError(f"{what}: {k} {gm[k]} against {wm[k]}")
    if gaps["grad_norm_rel"] > NORM_RTOL or not all(map(math.isfinite, gm.values())):
        raise AssertionError(f"{what}: grad_norm {gm['grad_norm']} against {wm['grad_norm']}")
    worst, worst_name = 0.0, None
    for name, w in wmom.items():
        w, g = w.float().cpu(), gmom[name].float().cpu()
        big = float(w.abs().max())
        gap = float((w - g).abs().max()) / 2.0 ** (math.floor(math.log2(big)) - 7) if big else 0.0
        if gap > worst:
            worst, worst_name = gap, name
    if worst > GRAD_ULPS:
        raise AssertionError(f"{what}: gradient leaf {worst_name} {worst:.2f} bf16 ulps apart")
    gaps.update(grad_ulps=worst, grad_ulps_leaf=worst_name)
    return gaps


def routing_flips(torch, want, got, top_k):
    """Tokens whose expert choices differ between two routing logs, and the
    largest gap of ``want``'s router between its k-th and (k+1)-th
    probabilities at those tokens; raises unless each is under ROUTER_TIE."""
    flips, widest = 0, 0.0
    for (probs, wi), (_, gi) in zip(want, got):
        diff = (wi.sort(-1).values != gi.sort(-1).values).any(-1)
        if diff.any():
            widest = max(widest, float(router_gap(probs[diff], top_k).max()))
            flips += int(diff.sum())
    if widest >= ROUTER_TIE:
        raise AssertionError(f"an expert choice flips at a router gap of {widest}")
    return {"routing_flips": flips, "widest_flip_gap": widest}


def run_family_training(torch, arch):
    """Phase 22, one family: its smoke config through the training
    launcher's path (``train.build``, 128 x 4) on the card, one step against
    the same step on the CPU from the card's initial parameters (an MoE
    router takes the CPU's expert choices on the card, each flip a near-tie);
    then, without experts, 2 microbatches against 1 on the card."""
    from repro_torch.launch import train

    card, data = train.build(train_args("--arch", arch, "--smoke", "--steps", "1"))
    card.init_state(resume=False)
    cpu = twin(torch, card, train_args("--arch", arch, "--smoke", "--device", "cpu"))
    moe = card.model.cfg.ffn == "moe"
    mb2 = None if moe else twin(torch, card, train_args("--arch", arch, "--smoke",
                                                       "--microbatches", "2"))
    with routing(torch) as cpu_routes, recorded_update(torch) as rec:
        want = step_once(torch, cpu, data)
    with routing(torch, impose=cpu_routes if moe else None) as card_routes:
        got = step_once(torch, card, data)
    out = {"loss_cpu": want[0]["loss"], "loss_card": got[0]["loss"],
           "card_step_ms": got[2], **compare_steps(torch, want, got, f"{arch} card vs CPU"),
           **card_update(torch, rec, f"{arch} AdamW")}
    if moe:
        out.update(routing_flips(torch, cpu_routes, card_routes, card.model.cfg.moe_top_k))
    else:
        gaps = compare_steps(torch, got, step_once(torch, mb2, data), f"{arch} 2 microbatches")
        out["microbatches_2_vs_1"] = gaps
    log(f"{card.model.cfg.name}: loss {out['loss_card']:.6f} on the card, "
        f"{out['loss_cpu']:.6f} on the CPU (gap {out['loss_rel']:.2e}), grad norm gap "
        f"{out['grad_norm_rel']:.2e}, widest gradient gap {out['grad_ulps']:.2f} bf16 ulps "
        f"({out['grad_ulps_leaf']}); AdamW on the card from the CPU step's gradients: norm "
        f"gap {out['adamw_norm_rel']:.2e}, f32 ulps {out['adamw_ulps']}, parameters equal"
        + (f"; {out['routing_flips']} routing flips, widest at a router gap of "
           f"{out['widest_flip_gap']:.5f}" if moe else
           f"; 2 microbatches vs 1: loss gap {out['microbatches_2_vs_1']['loss_rel']:.2e}, "
           f"widest gradient gap {out['microbatches_2_vs_1']['grad_ulps']:.2f} ulps"))
    return out


def train_flops(cfg, b, s, remat):
    """FLOPs of one training step as the port computes it: 6 N per token
    for N the parameters that multiply (every block's projections and the
    logits' matrix; the embedding lookup and the norms do none), plus the
    chunked attention's full masked S x S scores and values (4 B S^2 H Dh
    per layer forward), run forward once, again in backward (each query
    chunk is recomputed) and twice in its backward; ``remat="full"`` runs
    every layer's forward once more (2 N_blocks per token and the attention
    forward); the loss recomputes each chunk's logits (2 V D per token)."""
    d, h, dh, kvh, f = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.n_kv_heads, cfg.d_ff
    n_blocks = cfg.n_layers * (2 * d * h * dh + 2 * d * kvh * dh + 3 * d * f)
    n_logits = cfg.vocab_size * d
    tokens = b * s
    attn = 4 * b * s * s * h * dh * cfg.n_layers
    flops = {"6N": 6 * (n_blocks + n_logits) * tokens,
             "attention": 4 * attn,
             "loss_recompute": 2 * n_logits * tokens,
             "remat": (2 * n_blocks * tokens + attn) if remat == "full" else 0}
    flops["total"] = sum(flops.values())
    return flops


def run_phi3_training(torch):
    """Phase 23: phi3-mini-3.8b at full width.  (a) Depth cut to 2 layers,
    B = 1, S = 256: one step on the card against the same step on the CPU.
    (b) Full depth, ``remat="full"``, 1024 x 2, one microbatch:
    FULL_STEPS steps with finite losses; ms per step, tokens/s, peak memory
    against the training state, share of the bf16 peak; one more step under
    the profiler (busy share, GEMM share) and AdamW alone (CUDA events)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.train import optimizer as opt_mod

    full = get_config(PHI3)
    out = {}
    cut = dataclasses.replace(full, n_layers=2)
    args = train_args("--arch", PHI3, "--seq-len", "256", "--global-batch", "1",
                      "--steps", "1")
    card, data = train.build(args, cut)
    card.init_state(resume=False)
    cpu = twin(torch, card, train_args("--arch", PHI3, "--seq-len", "256",
                                       "--global-batch", "1", "--device", "cpu"), cut)
    with recorded_update(torch) as rec:
        want = step_once(torch, cpu, data)
    got = step_once(torch, card, data)
    out["depth_2"] = {"params": cut.param_count(), "loss_cpu": want[0]["loss"],
                      "loss_card": got[0]["loss"], "cpu_step_ms": want[2],
                      "card_step_ms": got[2],
                      **compare_steps(torch, want, got, "phi3-mini-3.8b, 2 layers"),
                      **card_update(torch, rec, "phi3-mini-3.8b, 2 layers, AdamW")}
    del rec
    r = out["depth_2"]
    log(f"phi3-mini-3.8b at 2 layers ({r['params']:,} parameters), 1 x 256: loss "
        f"{r['loss_card']:.6f} on the card, {r['loss_cpu']:.6f} on the CPU (gap "
        f"{r['loss_rel']:.2e}), grad norm gap {r['grad_norm_rel']:.2e}, widest gradient "
        f"gap {r['grad_ulps']:.2f} bf16 ulps ({r['grad_ulps_leaf']}); step {r['cpu_step_ms']:.0f} "
        f"ms on the CPU, {r['card_step_ms']:.1f} ms on the card (first step); AdamW on the "
        f"card from the CPU step's gradients: norm gap {r['adamw_norm_rel']:.2e}, f32 ulps "
        f"{r['adamw_ulps']}, parameters equal")
    del card, cpu, data, want, got
    release(torch)

    cfg = dataclasses.replace(full, remat="full")
    b, s = 2, 1024
    args = train_args("--arch", PHI3, "--seq-len", str(s), "--global-batch", str(b),
                      "--microbatches", "1", "--steps", str(FULL_STEPS))
    tr, data = train.build(args, cfg)
    torch.cuda.reset_peak_memory_stats()
    tr.init_state(resume=False)
    state_gb = torch.cuda.memory_allocated() / 1e9
    hist = tr.run(data, FULL_STEPS, log_every=1)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [h["loss"] for h in hist]
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"phi3-mini-3.8b at full width: losses {losses}")
    step_ms = sorted(h["sec_per_step"] * 1e3 for h in hist[1:])
    ms = step_ms[len(step_ms) // 2]
    flops = train_flops(cfg, b, s, cfg.remat)
    n = cfg.param_count()

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tr.run(data, 1, log_every=1)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t) * 1e3
    kernels = cuda_kernels(torch, prof)
    busy = sum(v[0] for v in kernels.values()) / 1e3
    gemm = sum(v[0] for name, v in kernels.items()
               if any(w in name.lower() for w in ("gemm", "cutlass", "xmma", "nvjet"))) / 1e3
    grads = {name: torch.zeros_like(p) for name, p in tr.params.named_parameters()}
    lr_fn = opt_mod.cosine_schedule(3e-4, 100, FULL_STEPS)
    adamw_ms = time_ms(torch, lambda: opt_mod.adamw_update(grads, tr.opt_state, tr.params,
                                                           lr_fn=lr_fn), 3)
    out["full"] = {
        "params": n, "layers": cfg.n_layers, "remat": cfg.remat, "batch": b, "seq_len": s,
        "losses": losses, "ms_per_step": ms, "ms_per_step_all": step_ms,
        "tokens_per_s": b * s / (ms / 1e3),
        "state_gb_after_init": state_gb, "state_gb_model": n * (2 + 4 + 4 + 4 + 2) / 1e9,
        "peak_memory_gb": peak_gb, "flops": flops,
        "bf16_peak_share": flops["total"] / (ms / 1e3) / BF16_PEAK,
        "profiled_step_ms": wall, "device_busy_ms": busy, "busy_share": busy / wall,
        "gemm_ms": gemm, "kernels_per_step": sum(v[1] for v in kernels.values()),
        "adamw_ms": adamw_ms}
    r = out["full"]
    log(f"phi3-mini-3.8b at full width and depth ({n:,} parameters, remat full), "
        f"{b} x {s}, {FULL_STEPS} steps: losses {[round(x, 4) for x in losses]}; "
        f"{ms:.1f} ms per step (median of steps 2-{FULL_STEPS}), {r['tokens_per_s']:.0f} "
        f"tokens/s; {flops['total'] / 1e12:.1f} TFLOP per step "
        f"({flops['6N'] / 1e12:.1f} 6N, {flops['attention'] / 1e12:.1f} attention, "
        f"{flops['remat'] / 1e12:.1f} remat, {flops['loss_recompute'] / 1e12:.2f} loss "
        f"recompute): {r['bf16_peak_share']:.3f} of the bf16 peak; device memory "
        f"{state_gb:.1f} GB after init, peak {peak_gb:.1f} GB against the "
        f"{r['state_gb_model']:.1f} GB training state; a profiled step {wall:.1f} ms, "
        f"device busy {busy:.1f} ms ({r['busy_share']:.3f}), GEMMs {gemm:.1f} ms, "
        f"{r['kernels_per_step']} kernels; AdamW alone {adamw_ms:.1f} ms")
    del tr, data, grads, prof
    release(torch)
    return out


def run_train_smoke(torch):
    """Phase 24: the train_smoke example's run on the card (its config, 128 x
    8, lr 3e-3, warm-up 20, 2 microbatches, SMOKE_STEPS steps, checkpoints
    every 100 steps in a temporary directory): the loss drops by more than
    0.3 from the first logged step to the last; a fresh trainer restored
    from step SMOKE_RESUME replays the rest with the first run's losses bit
    for bit."""
    import tempfile

    from repro_torch.launch import train
    from repro_torch.train import checkpoint as ckpt

    with tempfile.TemporaryDirectory() as tmp:
        tr, data = train.build_train_smoke(SMOKE_STEPS, ckpt_dir=tmp, device=DEVICE)
        tr.init_state(resume=False)
        t = time.perf_counter()
        hist = tr.run(data, SMOKE_STEPS, log_every=20)
        wall = time.perf_counter() - t
        replay, data = train.build_train_smoke(SMOKE_STEPS, device=DEVICE)
        replay.init_state(resume=False)
        _, replay.step = ckpt.restore(tmp, {"params": replay.params, "opt": replay.opt_state},
                                      step=SMOKE_RESUME)
        again = replay.run(data, SMOKE_STEPS - SMOKE_RESUME, log_every=20)
    first, last = hist[0]["loss"], hist[-1]["loss"]
    if not last < first - 0.3:
        raise AssertionError(f"train_smoke: loss {first} -> {last}, no clear learning")
    want = [(h["step"], h["loss"]) for h in hist if h["step"] > SMOKE_RESUME]
    got = [(h["step"], h["loss"]) for h in again]
    if got != want:
        raise AssertionError(f"train_smoke: the replay from step {SMOKE_RESUME} gave {got}, "
                             f"the first run {want}")
    out = {"params": tr.model.cfg.param_count(), "steps": SMOKE_STEPS,
           "loss_first": first, "loss_last": last, "wall_s": wall,
           "ms_per_step": wall / SMOKE_STEPS * 1e3, "replayed_steps": [s for s, _ in got],
           "replay_bit_equal": True}
    log(f"train_smoke ({out['params']:,} parameters): loss {first:.4f} -> {last:.4f} in "
        f"{SMOKE_STEPS} steps ({out['ms_per_step']:.1f} ms per step with the logging and "
        f"3 checkpoints); the replay from step {SMOKE_RESUME} gives the losses at steps "
        f"{out['replayed_steps']} bit for bit")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    try:
        from repro_torch.configs import list_archs
        from repro_torch.core import MSLRUConfig
        from repro_torch.data.ycsb import zipfian_tensor
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
    build_kernels()

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
    summary, stream_table = run_main_path(torch, cfg, keys, vals)
    log(f"hit ratio {summary['hit_ratio']:.4f}, occupancy {summary['occupancy']:.4f}, "
        f"evictions {summary['evictions']}, {summary['qps']:.4g} queries/s, "
        f"{summary['ms_per_batch']:.4f} ms/batch, max chain per batch mean "
        f"{summary['max_chain_mean']:.1f} (min {summary['max_chain_min']}, "
        f"max {summary['max_chain_max']})")

    phase("6. msl_cache kernels")
    records = kernel_records(torch, cfg, keys, vals, onepass_inputs,
                             access_inputs, errs, summary)
    # phase 20 reads the stream and its table again: they wait on the host,
    # so no phase in between counts them in its device memory
    host_stream = [x.cpu() for x in (keys, vals, stream_table)]
    del keys, vals, stream_table, onepass_inputs, access_inputs

    phase("7. paged_attn kernel == plain")
    errs["paged_attn"] = check_paged_kernel(torch)

    phase("8. serving path: phi3-mini-3.8b at full width, paged")
    eng, reqs, serving, snapshot = run_serving(torch)

    phase("9. paged (kernel) against contiguous (plain) at full width")
    serving["cross_check"] = cross_check(torch, eng, reqs)

    phase("10. kernels")
    records[1]["launches_serving_path"] = serving["launches"]["msl_onepass"]
    records.append(paged_record(torch, eng, snapshot, serving, errs["paged_attn"]))
    log(f"paged_attn: clusters of {records[2]['splits']} blocks per (row, KV head), "
        f"grid ({records[2]['shape']['KVH']}, {records[2]['shape']['B']}, "
        f"{records[2]['splits']}), for {records[2]['shape']['positions']} positions")
    for r in records:
        log_record(r)

    phase("11. megastep decode at full width, paged: one CUDA graph per window")
    serving["megastep"] = run_megastep(torch, eng, reqs, serving)
    records[2]["launches_megastep_path"] = serving["megastep"]["launches"]["paged_attn"]

    phase("12. split admission and round-robin decode at full width, paged")
    serving["split_roundrobin"] = run_split_roundrobin(torch, eng, reqs, serving)
    buckets = sorted({w["steps"] for w in serving["megastep"]["windows"]})
    phase8 = {"served": served(eng, reqs), "ticks": serving["ticks"]}
    del eng, reqs, snapshot
    release(torch)

    phase("13. the attention-decoder families at smoke width, paged")
    serving["families_smoke"], shapes = {}, []
    for arch in FAMILIES:
        serving["families_smoke"][arch], rec = run_family_smoke(torch, arch,
                                                                errs["paged_attn"])
        shapes.append(rec)
        release(torch)

    phase("14. starcoder2-7b at full width and depth, paged: in-flight and megastep")
    serving["starcoder2-7b"], rec = run_full_width(torch, "starcoder2-7b",
                                                  errs["paged_attn"], buckets)
    shapes.append(rec)
    release(torch)

    phase("15. gemma3-1b at full width and depth, paged")
    serving["gemma3-1b"], rec = run_full_width(torch, "gemma3-1b", errs["paged_attn"])
    shapes.append(rec)
    release(torch)

    phase("16. olmoe-1b-7b at full width and depth, paged: in-flight and megastep")
    serving["olmoe-1b-7b"], rec = run_full_width(torch, "olmoe-1b-7b", errs["paged_attn"],
                                                buckets)
    shapes.append(rec)
    release(torch)

    phase("17. hymba at smoke width and at full width and depth, contiguous")
    serving["hymba-smoke"] = run_contiguous(torch, HYMBA, smoke=True)
    release(torch)
    serving[HYMBA] = run_contiguous(torch, HYMBA, smoke=False)
    release(torch)

    phase("18. xlstm at smoke width and at full width and depth, contiguous")
    serving["xlstm-smoke"] = run_contiguous(torch, XLSTM, smoke=True, roundrobin="exact")
    release(torch)
    serving[XLSTM] = run_contiguous(torch, XLSTM, smoke=False, roundrobin="exact")
    release(torch)

    phase("19. whisper at smoke width and at full width and depth, contiguous")
    serving["whisper-smoke"] = run_contiguous(torch, WHISPER, smoke=True, roundrobin=None)
    release(torch)
    serving[WHISPER] = run_contiguous(torch, WHISPER, smoke=False, roundrobin=None)
    release(torch)
    # the paged kernel's record at every other path's shapes
    records[2]["shapes"] = shapes

    phase(f"20. the sharded cache: {SHARDS} logical shards on the card at the main "
          "path's size")
    keys, vals, stream_table = (x.to(DEVICE) for x in host_stream)
    del host_stream
    summary["sharded"] = run_sharded_cache(torch, cfg, keys, vals, stream_table, summary)
    records[0]["launches_sharded_path"] = summary["sharded"]["launches_rounds_check"][
        "msl_access"]
    records[1]["launches_sharded_path"] = summary["sharded"]["launches_stream"]["msl_onepass"]
    del keys, vals, stream_table
    release(torch)

    phase(f"21. phi3-mini-3.8b at full width behind {SHARDS} shards: sheds, retries, "
          "split placement, throttling, faults")
    serving["sharded"] = run_sharded_serving(torch, phase8, buckets)
    bounded = serving["sharded"]["bounded"]["launches"]
    records[1]["launches_sharded_serving_path"] = bounded["msl_onepass"]
    records[2]["launches_sharded_serving_path"] = bounded["paged_attn"]
    release(torch)

    # the training path launches none of the three kernels: counted from 0
    # here to the end of phase 24
    zero_launches()
    phase("22. every family's smoke config trains on the card: one step against the CPU")
    training = {"families": {}}
    for arch in list_archs():
        training["families"][arch] = run_family_training(torch, arch)
        release(torch)

    phase("23. phi3-mini-3.8b training at full width: 2 layers against the CPU, then "
          "full depth")
    training[PHI3] = run_phi3_training(torch)

    phase("24. the train_smoke example's run on the card: learning, checkpoint, replay")
    training["train_smoke"] = run_train_smoke(torch)
    release(torch)
    launches = read_launches()
    if any(launches.values()):
        raise AssertionError(f"the training phases launched kernels: {launches}")
    for r in records:
        r["launches_training_path"] = launches[r["name"]]

    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(smi)
    print(json.dumps({"main_path": summary, "card": smi}))
    print(json.dumps({"serving": serving, "card": smi}))
    print(json.dumps({"training": training, "card": smi}))
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
