#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the multi-step LRU cache, of its sharded
form, of its prefix-cached serving path (every architecture of the JAX
package: the attention decoders, the MoE decoders, the hymba hybrid, xLSTM
and the Whisper encoder-decoder), of its trainer, of its Python oracle and
of its step bundles and dry run, of its route between processes, of its
gradient compression and of its faults and resizes across processes on one
NVIDIA GPU.

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
   and against ``access_seq`` (one ``msl_seq`` launch, counted from 0) on a
   4096-query prefix of a small configuration; the sequential kernel, at
   the wrapper's own number of queues and at one (a warp over the whole
   stream in order), against its plain version on CPU copies of that
   prefix and of mixed-op streams with chain ops and a cost plane (A = 32,
   two key planes, set_lru; A = 8, multistep);
6. the msl_cache kernels' records: launches on the path that runs each
   (the one-pass stream for the one-pass kernel, the rounds cross-check
   for the access kernel, ``access_seq`` for the sequential kernel), time
   per launch, plain version's time, bound; for the access kernel also its
   rows per warp, its registers and its time at B = 1 and at an A = 32
   geometry; for the one-pass kernel also
   ns per dependent transition on a chain with no two neighbours equal, ns
   per member of a one-key run, and the longest chain walked member by
   member at that rate (``chain_path_ms``, a critical path, not a bound);
   for the sequential kernel its record at phase 5's check and, on each of
   fig07's zipfian, latest and scan streams (1M keys, 2M queries, capacity
   262144, m = 2, p = 4), ``access_seq`` in one launch against the
   one-pass kernel in batches of 8192: hits, positions, evictions and the
   final table bit-equal, queries/s and ns per query of each, the
   kernel's device ms beside its byte bound and its dependency floor (the
   longest owner queue at the ns of one dependent transition); on zipfian
   also the kernel at one queue, bit-equal, and its device ms;
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
14. starcoder2-7b at its published width (d_model 4608, 36 heads on 4 KV
   heads, Dh 128, d_ff 18432, vocab 49152; random weights), its depth cut
   from 32 layers to FULL_WIDTH_LAYERS' 8, as phases 14-19 all are: the
   in-flight serve with phase 8's checks, then a
   megastep twin on the window buckets phase 11's serve used: tokens,
   ticks, finish order and prefill split equal; ms per decode tick, tokens/s,
   wall, launches, host syncs, peak device memory, the kernel's record;
15. gemma3-1b at its published width (d_model 1152, 4 heads on 1 KV head,
   Dh 256, vocab 262144), 6 of its 26 layers (one period of five windowed
   and one global): the in-flight serve, the same
   checks and numbers.  Each full-width model is freed before the next is
   built; neither's window (4096, 512) binds at the launcher's max_len 256;
16. olmoe-1b-7b at its published width (d_model 2048, 16 heads, 64 experts
   top-8, expert d_ff 1024, vocab 50304; random weights), 4 of its 16
   layers: phase 14's in-flight and megastep serves and
   numbers, and the MoE FFN's device time per decode step beside its
   expert-weight read;
16(b). command-r-35b at its published width and whole depth (40 layers,
   d_model 8192, 64 heads on 8 KV heads, Dh 128, a parallel block with
   LayerNorm, vocab 256000: 64.8 GB of bf16 weights on the one card):
   phase 14's serves and numbers, the device memory after init and at the
   serve's peak, ms per decode tick beside the step's weight read, and
   phase 9's cross-check against a contiguous twin on the same weights;
16(c). qwen2-vl-72b at its published width, 8 of its 80 layers (d_model
   8192, 64 heads on 8, Dh 128, M-RoPE): phase 14's serves, every M-RoPE
   call of the serve on (B, 3, S) position streams, and the rotation's
   16/24/24 split of the 64 frequency slots checked on the card;
16(d). phi3.5-moe-42b-a6.6b at its published width, 8 of its 32 layers
   (d_model 4096, 32 heads on 8, 16 experts of 4096 x 6400, top-2,
   capacity 1.25): phase 16's serves and numbers, the MoE FFN's device
   time per decode step beside its 20.1 GB expert read and olmoe's;
17. hymba at smoke width, then at its published width (d_model 1600, 25
   heads on 5 KV heads, Mamba state 16, 128 meta tokens), 8 of its 32
   layers (layer 0 global, 1-7 windowed at 1024), served through
   ``serve.build`` with the default ``--kv-mode contiguous`` as the JAX
   engine serves it (no prefix cache: no kernel launches): in-flight, a
   megastep twin (window graphs captured mid-serve, each capture leaving
   the Mamba state bit-equal; tokens, ticks, finish order and prefill split
   equal the in-flight serve's) and a round-robin twin (tokens equal or
   split at a near-tie); at smoke width the window of 16 binds;
18. xLSTM at smoke width, then xlstm-1.3b at its published width (d_model
   2048, 4 heads, mLSTM Dh 1024, vocab 50304; random weights), 8 of its 48
   blocks (one group of 7 mLSTM and 1 sLSTM), through phase 17's path:
   in-flight, a megastep twin whose every
   capture leaves each mLSTM and sLSTM leaf bit-equal (tokens, ticks,
   finish order and prefill split equal), and a round-robin twin whose
   tokens must equal the in-flight ones;
19. Whisper at smoke width, then whisper-medium at its published width
   (24 encoder layers and 6 of its 24 decoder layers, d_model 1024, 16 heads of 64,
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
23. phi3-mini-3.8b at full width: (a) CUT_LAYERS (1) of its 32 layers
   (0.31 B parameters), 1 x 256, one step and its AdamW update on the card
   against the CPU as in 22;
   (b) all 32 layers, ``remat="full"``, 1024 x 2, one microbatch,
   FULL_STEPS steps with finite losses: ms per step, tokens/s, the step's
   FLOPs (``train_flops``) over the bf16 peak, peak device memory against
   the training state; one more step under the profiler (busy share, GEMM
   ms, kernels) and AdamW alone;
24. ``examples/torch_train_smoke.py``'s ``main`` on the card (the train_smoke
   example's run, its 300 steps cut to 150: 2 microbatches, checkpoints at
   step 100 and at the end in a temporary directory): the loss falls by
   more than 0.3; a fresh trainer restored from step 100 replays steps
   101-150 with the same logged losses, bit for bit.
   Phases 22-24 launch none of the three kernels (counted from 0 before 22);
25. the port's Python oracle (``core/policies.py`` ``MultiStepLRUOracle``)
   against ``MultiStepLRUCache`` on the card through both engines, so both
   msl kernels: five geometries (m, p) = (1, 4), (2, 4), (4, 4), (8, 4) and
   (2, 8) with 2^10-2^12 sets, 2 value planes, key planes 1 and 2, a cost
   plane or none, multistep and set_lru; ORACLE_BATCHES batches of 8192
   mixed rows (``tests/torch_oracle_cases.py``: ACCESS, GET, DELETE,
   LOOKUP, prefix-cache chains, costs): every row's hit, pos, value and
   eviction and, after each batch, the table's keys bit-equal;
26. the paper's figures at their scale (1M keys, 2M queries, Zipf 0.99,
   the figure scripts' seeds and capacities) through the one-pass kernel
   in batches of 8192: fig07's hit ratios (three distributions, four
   capacities, in-vector, multistep, cost-aware, set-LRU; the Mattson exact
   LRU, GCLOCK and ARC for zipfian), fig11's M sweep, fig12's hits per
   vector, fig13's P = 8, fig15's warm-up from a garbage table, fig08's
   shape (longest chain per batch, the Python baselines' µs per query on
   300k queries); the whole 2M-query hit and pos stream of fig07 zipfian at
   65536, m = 2, equal to the oracle's (the oracle and the baselines run on
   the host in HOST_WORKERS processes while the card streams); claims c1-c6 of
   ``tests/test_paper_claims.py`` with its margins (c1-c3 at 65536, c4 on
   fig11, c5 on fig12 zipfian M = 4, c6 on fig15 over the first C6_WINDOW
   queries);
27. phi3-mini-3.8b at full width: ``launch/steps.py`` ``bundle_for``'s
   prefill step and serve step (logits and greedy) on ``decode_specs``'s
   shapes made real at 4 x 4096, bit-equal to ``model.prefill`` and
   ``model.decode_step`` + argmax over 8 steps; then ``launch/dryrun.py``
   on the host over phi3-mini's four cells and phase 23(b)'s cut train cell
   (counted FLOPs against ``train_flops``, terms and memory beside phase
   23(b)'s measured step and peak); its records on the production meshes
   are phase 30(c)'s;
28. the sharded cache with one shard per process: ``run_on_ranks`` spawns
   one world of 8 gloo ranks that share the card (NCCL does not put two
   ranks on one card, so the route's ``all_to_all`` goes through pinned
   host buffers); the cache runs on its first D = 2, 4 and 8 ranks in turn
   (``ProcessCacheMesh(D)``), each rank holding its rows of the main
   configuration's table and its slab of every batch: the one-pass route
   over the first ROUTE_SHORT_BATCHES (D = 2, 4) or ROUTE_D8_BATCHES (D =
   8) batches of phase 5's stream from a cold table, its rows (at D = 8 the
   table gathered to rank 0) and the second half's hits bit-equal to phase
   5's engine (one table) on the same batches, one ``msl_onepass`` launch
   per batch on every rank; at D = 8 then the rounds route (``msl_access``)
   on CHECK_BATCHES batches after it and, from a cold table, a per-peer
   depth of ROUTE_CAP (sheds) against the one-process engine; queries/s per
   D, host-staging and gloo ms per exchange;
29. int8 gradient compression: ``quantize_int8``/``dequantize_int8`` on the
   card bit-equal to the CPU on seeded gradients shaped like phi3-mini's
   1-layer cut; ``compress_tree`` over 4 gloo ranks on the card, two rounds
   carrying the residuals, bit-equal to the formula on the CPU (the int32
   sum of every rank's int8 values times the largest scale; residuals).
   Any rank's failure fails the run;
30. the sharded step (``launch/steps.py`` on a ``DeviceMesh``): (a) phase
   23(b)'s run (phi3-mini-3.8b at full width and depth, remat full, 1024 x
   2) for MESH_STEPS steps on one device, then through the launcher's
   ``build`` on a (1, 1) mesh in a process group of one NCCL rank: losses
   within LOSS_RTOL, parameters within GRAD_ULPS bf16 ulps, ms per step and
   peak memory beside phase 23(b)'s (what DTensor dispatch costs the
   host-bound step); (b) phi3-mini at full width, 1 of 32 layers, 256 x 4:
   one train step, the prefill and CUT_DECODE serve steps on one device,
   then on meshes (2, 1), (1, 2) (each twice over) and (2, 2) of one world
   of 4 gloo ranks sharing the card, DTensor's collectives through host memory
   (``HostStagedCollectives``, which counts them), each held against one
   device (metrics, parameters and the gradients that reached AdamW within
   the CPU tests' bounds, every rank's parameters, master, m and v those of
   the one-device update of its shards bit for bit, logits within phase 9's
   LOGIT_ULPS, greedy tokens equal but at ties), with ms per step per rank
   and the first step's collectives by kind; (c) ``launch/dryrun.py --mesh
   pod1|pod2`` for phi3-mini's cells, xlstm-1.3b's decode_32k and
   olmoe-1b-7b's and hymba-1.5b's prefill_32k (MESH_DRYRUN), run on the
   host beside (a) and (b): every record's activations,
   collectives, terms, dominant term and roofline fraction counted.
   Phase 30 launches none of the three kernels;
31. faults across processes, one world of FAULT_WORLD gloo ranks sharing
   the card that runs (a) and then (b): (a) ``ShardedCacheClient.reshard`` and ``mark_degraded`` on a
   ``ProcessCacheMesh``: ``tests/test_reshard.py``'s workload (one of its
   seeds 0-2 per pair) from the first D ranks to the first D' for (8, 4),
   (4, 8), (8, 7), (2, 1) and (8, 7) through the rounds engine, then at
   the real size (REAL_SETS sets x 8 ways, Zipf 0.99 chains of 1-5 chunks)
   8 -> 7, ``mark_degraded(3)``, 7 -> 8: every rebuilt table equal to a cold
   ``MultiStepLRUCache`` on the card fed the drain stream, every chain
   re-inserted resident, every rank's orphans, drain streams, tables and
   client state equal to the one-process client's; each engine's kernel
   launched on exactly the ranks that held rows (launches read before the
   checks' own); ms per drain and re-insert sweep, per reshard and per
   ``mark_degraded``; (b) phase 21's
   first bounded serve with the cache on the ranks and the engine on rank
   0 (``serve --processes``: rank 0 leads the client, the others replay
   its calls; the plan's resize to 7 leaves rank 7 outside the group):
   ticks, fault log, finish order, prefill split, every stats and
   prefix-cache key, the pool and the gathered table equal phase 21's,
   tokens equal or split at a near-tie; ms per decode tick and host ms per
   cache call beside phase 21's, staging and gloo ms per exchange, ms per
   applied fault, ``msl_onepass`` launches per rank and ``paged_attn``
   launches on rank 0;
32. the port's examples, in this process on the card
   (``examples/torch_quickstart.py``, ``torch_distributed_cache.py``, whose
   sequential oracle runs on the card, ``torch_serve_prefix_cache.py``):
   value integrity "OK" and the final table "YES"; hits, occupancy,
   evictions, served queries and requests, tokens, prefill computed and
   skipped and the prefix cache's stats equal to the CPU's
   (EXAMPLE_RESULTS); ``msl_onepass`` launched by each, ``msl_seq`` by the
   distributed cache, ``paged_attn`` by the serve.

Then the JSON lines: the main path (phase 20 under ``sharded``, 28 under
``route``, 31(a) under ``reshard_processes``), the serving path (phases 8,
9, 11-19, 21 under ``sharded``, 31(b) under ``sharded_processes``, 32 under
``examples``),
training (phases 22-24, 29 under ``compression``, 30(a) and 30(b) under
``sharded_step``), the oracle, the figures and the dry run (phases 25-27,
30(c) under ``dryrun``'s ``mesh_cells``) and every kernel's record (the paged
kernel's with ``shapes``: its record at phases 13-16's shapes).

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

# the H100 SXM's dense bf16 peak and HBM3 rate (NVIDIA's data sheet)
from repro_torch.roofline.analysis import BF16_PEAK, HBM_BW  # noqa: E402

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
    """A line of the log, after the seconds since this process started."""
    print(f"[{time.perf_counter() - T0:7.1f}]", *args, flush=True)


def phase(name):
    print(f"== {name} (at {time.perf_counter() - T0:.1f} s)", flush=True)


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


def launches_ms(torch, launch, states):
    """Mean device ms of ``launch(s)`` over ``states[1:]``, prepared before
    the timed span: CUDA events around back-to-back launches, behind one
    untimed launch on ``states[0]`` so that the host's enqueueing stays
    ahead of the device (the kernel alone, without the profiler)."""
    launch(states[0])
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for s in states[1:]:
        launch(s)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (len(states) - 1)


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
    """Phase 5.  Returns the summary dict and the table after the stream.  Launches are counted on three
    paths, each from zero just before it to just after it: the one-pass
    stream (the main path), the rounds engine's cross-check, the path that
    runs the access kernel, and ``access_seq`` on the prefix, the path that
    runs the sequential kernel."""
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

    # one-pass against the sequential oracle (the msl_seq kernel: one launch
    # walks the prefix) on a small configuration; the sequential kernel
    # against its plain version on CPU copies of the same inputs
    small = MSLRUConfig(**SEQ_CFG)
    seq = MultiStepLRUCache(small, device=DEVICE)
    one = MultiStepLRUCache(small, device=DEVICE)
    prefix_k, prefix_v = keys[:SEQ_PREFIX], vals[:SEQ_PREFIX]
    zero_launches()
    want = seq.access_seq(prefix_k, prefix_v)
    seq_launches = read_launches()
    if seq_launches["msl_seq"] != 1:
        raise AssertionError(f"access_seq launched msl_seq {seq_launches['msl_seq']} times")
    got = [one.access(prefix_k[i:i + 1024], prefix_v[i:i + 1024])
           for i in range(0, SEQ_PREFIX, 1024)]
    for f in ("hit", "pos", "evicted_key", "evicted_val", "evicted_valid"):
        if not torch.equal(torch.cat([getattr(r, f) for r in got]), getattr(want, f)):
            raise AssertionError(f"one-pass != access_seq: {f}")
    if not torch.equal(one.table, seq.table):
        raise AssertionError("one-pass and sequential tables differ")
    log(f"one-pass == access_seq (one msl_seq launch) on a {SEQ_PREFIX}-query prefix "
        f"({small.num_sets} sets): {int(want.hit.sum())} hits, "
        f"{int(want.evicted_valid.sum())} evictions, tables bit-equal")
    seq_check = check_seq_kernel(torch, small, prefix_k, prefix_v, want, seq.table)

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
        "launches_seq_check": seq_launches,
        "seq_check": seq_check,
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


# the sequential engine (the msl_seq kernel)
SEQ_CFG = dict(num_sets=256, m=2, p=4, value_planes=2)   # phase 5's access_seq check
SEQ_PREFIX = 4096           # ... on this many queries of the main stream
# phase 5(i): (m, p, key planes, cost planes, policy) of the mixed-op
# streams, 16 sets, 2 value planes; SEQ_CALLS calls of SEQ_ROWS rows each
SEQ_GEOMS = [(8, 4, 2, 1, "set_lru"), (2, 4, 1, 1, "multistep")]
SEQ_CALLS = 2
SEQ_ROWS = 2048
SEQ_SCALE_CAP = 262144      # phase 6: fig07's largest capacity (m = 2, p = 4)


def _seq_equal(torch, want, got, what):
    """Two (table, SeqOutputs) pairs bit-equal, wherever each lies."""
    (wt, wo), (gt, go) = want, got
    for f in wo._fields:
        if not torch.equal(getattr(wo, f).cpu(), getattr(go, f).cpu()):
            raise AssertionError(f"msl_seq != plain: {f}, {what}")
    if not torch.equal(wt.cpu(), gt.cpu()):
        raise AssertionError(f"msl_seq != plain: the table, {what}")


@contextlib.contextmanager
def forced_owners(n):
    """Inside the block, the sequential kernel walks ``n`` queues (1: one
    warp over the whole stream in order) wherever ``make_sequential_engine``
    (and so ``access_seq``) calls it, in place of the wrapper's own G."""
    import functools

    from repro_torch.kernels import msl_cache

    call = msl_cache.msl_seq_kernel_call
    msl_cache.msl_seq_kernel_call = functools.partial(call, owners=n)
    try:
        yield
    finally:
        msl_cache.msl_seq_kernel_call = call


# the sequential kernel's two schedules held against the plain loop: the
# wrapper's own number of queues and one warp over the whole stream
SEQ_SCHEDULES = (None, 1)


def check_seq_kernel(torch, small, prefix_k, prefix_v, want, table):
    """Phase 5(i): the sequential kernel against ``msl_seq_plain`` on CPU
    copies of the same inputs, through ``make_sequential_engine``, at the
    wrapper's own G and at G = 1 (SEQ_SCHEDULES): (a) the main stream's
    prefix just run by ``access_seq`` on the card (``want``, ``table``) and
    again at G = 1; (b) SEQ_GEOMS' mixed-op streams
    (``tests/torch_oracle_cases.py``: ACCESS, GET, DELETE, LOOKUP,
    prefix-cache chains with chain ids, costs; among them A = 32, two key
    planes, a cost plane and set_lru), SEQ_CALLS calls of SEQ_ROWS rows
    each, one launch per call and schedule on the card: every output and
    the table bit-equal.  Returns the rows compared and their hits and
    evictions."""
    import numpy as np

    from repro_torch.core import MSLRUConfig, init_table, make_sequential_engine
    from repro_torch.kernels.msl_cache import seq_owners

    run = make_sequential_engine(small)
    plain = run(init_table(small, "cpu"), prefix_k[:, None].cpu(), prefix_v.cpu())
    _seq_equal(torch, plain, (table, want), "the main stream's prefix")
    with forced_owners(1):
        _seq_equal(torch, plain, run(init_table(small, DEVICE), prefix_k[:, None], prefix_v),
                   "the main stream's prefix, G = 1")
    out = {"rows": prefix_k.numel(), "hits": 0, "evictions": 0, "chain_rows": 0,
           "owners": {"prefix": seq_owners(small, prefix_k.numel(), DEVICE)}}
    oc = oracle_cases()
    for m, p, kp, cp, policy in SEQ_GEOMS:
        cfg = MSLRUConfig(num_sets=16, m=m, p=p, key_planes=kp, value_planes=2,
                          cost_planes=cp, policy=policy)
        run = make_sequential_engine(cfg, with_ops=True)
        rng = np.random.default_rng(SEED + 7 * m + p)
        tables = {g: init_table(cfg, DEVICE) for g in SEQ_SCHEDULES}
        tables["cpu"] = init_table(cfg, "cpu")
        for i in range(SEQ_CALLS):
            batch = oc.mixed_batch(rng, cfg, SEQ_ROWS, 3 * cfg.capacity)
            res = {}
            for g in ("cpu", *SEQ_SCHEDULES):
                dev = "cpu" if g == "cpu" else DEVICE
                args = [torch.from_numpy(batch[k]).to(dev)
                        for k in ("keys", "vals", "ops", "chain_ids", "costs")]
                before = read_launches()["msl_seq"]
                with forced_owners(g) if g == 1 else contextlib.nullcontext():
                    tables[g], res[g] = run(tables[g], *args[:4], costs=args[4])
                if dev == DEVICE and read_launches()["msl_seq"] != before + 1:
                    raise AssertionError("make_sequential_engine did not launch msl_seq once")
            for g in SEQ_SCHEDULES:
                _seq_equal(torch, (tables["cpu"], res["cpu"]), (tables[g], res[g]),
                           f"{cfg}, call {i}, G = {g or 'default'}")
            out["rows"] += SEQ_ROWS
            out["hits"] += int(res["cpu"].hit.sum())
            out["evictions"] += int(res["cpu"].evicted_valid.sum())
            out["chain_rows"] += int((batch["chain_ids"] > 0).sum())
        out["owners"][f"m{m}p{p}"] = seq_owners(cfg, SEQ_ROWS, DEVICE)
        log(f"msl_seq == plain (CPU copies) at G = {out['owners'][f'm{m}p{p}']} and G = 1: "
            f"m={m} p={p} (A = {m * p}), key planes {kp}, cost planes {cp}, {policy}: "
            f"{SEQ_CALLS} mixed-op calls of {SEQ_ROWS} rows")
    if not out["evictions"]:
        raise AssertionError("the sequential checks evicted nothing")
    log(f"msl_seq == plain on {out['rows']} rows ({out['chain_rows']} in chains) at both "
        f"schedules: {out['hits']} hits, {out['evictions']} evictions, tables bit-equal")
    return out


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
    out["bound_ms_a32"] = 1e3 * max(nbytes / HBM_BW, ops / INT32_OPS_PER_S)
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
        "bound_ms": 1e3 * max(access_bytes / HBM_BW,
                              b * ops_per_row / INT32_OPS_PER_S),
        "bound_by": ("bytes" if access_bytes / HBM_BW
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
        "bound_ms": 1e3 * max(onepass_bytes / HBM_BW,
                              b * ops_per_row / INT32_OPS_PER_S),
        "bound_by": ("bytes" if onepass_bytes / HBM_BW
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


def seq_bytes_ops(cfg, sids, ops=None, live=None, costs=None):
    """(bytes, int32 operations) the sequential engine needs for a stream
    over set ids ``sids``: each distinct set's row read and written once;
    each query's set id, key and value planes read, its opcode, chain mask
    and cost only where the stream carries them (``ops``, ``live``, and
    ``costs`` with a cost plane); its hit, pos, value planes and evicted
    key and value planes written once; one transition's probe, empty scan
    and rotate selects per query."""
    import torch

    n, a, c = sids.numel(), cfg.assoc, cfg.planes
    kp, v = cfg.key_planes, cfg.value_planes
    rows = torch.unique(sids).numel()
    carried = (ops is not None) + (live is not None) + (costs is not None and cfg.cost_planes > 0)
    words_in = 1 + kp + v + carried
    words_out = 2 + v + kp + v
    nbytes = 4 * (2 * rows * a * c + n * (words_in + words_out))
    return nbytes, n * a * (kp + 1 + 3 * c)


# phase 6: fig07's three streams (benchmarks/fig07_hit_ratio.py DISTS)
SEQ_STREAMS = ("zipfian", "latest", "scan")


def seq_at_fig07_scale(torch, dist, step_ns, smi, g1=False):
    """Phase 6: one of fig07's traces (``dist``: FIG_KEYS keys, FIG_QUERIES
    queries, Zipf 0.99, seed 7) at SEQ_SCALE_CAP items, m = 2, p = 4, no
    values, from a cold table: ``access_seq`` (one msl_seq launch over the
    whole stream, the wrapper's G) against the one-pass kernel in
    BATCH-query batches; every hit, pos, evicted key and valid bit and the
    final table bit-equal.  Queries/s and ns per query of each (host clock
    around each whole stream, synchronized), the sequential kernel's device
    ms per stream (``launches_ms``: two launches behind one, the
    partition's prologue included), the partition alone (``seq_queues``),
    its byte bound, the longest set chain and owner queue, and the
    dependency floor: the longest queue times phase 6's ``chain_step_ns``.
    With ``g1`` also G = 1 (one warp over the stream in order, the earlier
    design) on the same stream: bit-equal, and its device ms."""
    import numpy as np

    from repro_torch.core import MultiStepLRUCache, init_table, set_index_for
    from repro_torch.data.ycsb import make_workload
    from repro_torch.kernels.msl_cache import msl_seq_kernel_call, seq_owners, seq_queues

    cfg = fig_cfg(SEQ_SCALE_CAP)
    trace = torch.from_numpy(np.ascontiguousarray(
        make_workload(dist, FIG_KEYS, FIG_QUERIES, ZIPF_ALPHA, seed=7), np.int32)).to(DEVICE)
    n = trace.numel()
    fields = ("hit", "pos", "evicted_key", "evicted_valid")
    one = MultiStepLRUCache(cfg, device=DEVICE)
    got = {f: [] for f in fields}
    torch.cuda.synchronize()
    t = time.perf_counter()
    for i in range(0, n, BATCH):
        res = one.access(trace[i:i + BATCH])
        for f in fields:
            got[f].append(getattr(res, f))
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t
    got = {f: torch.cat(v) for f, v in got.items()}

    seq = MultiStepLRUCache(cfg, device=DEVICE)
    before = read_launches()["msl_seq"]
    torch.cuda.synchronize()
    t = time.perf_counter()
    want = seq.access_seq(trace)
    torch.cuda.synchronize()
    seq_s = time.perf_counter() - t
    if read_launches()["msl_seq"] != before + 1:
        raise AssertionError(f"access_seq over fig07's {dist} stream did not launch msl_seq once")
    for f in fields:
        if not torch.equal(got[f], getattr(want, f)):
            raise AssertionError(f"fig07's {dist} stream: msl_seq != msl_onepass: {f}")
    if not torch.equal(one.table, seq.table):
        raise AssertionError(f"fig07's {dist} stream: the sequential and one-pass tables differ")

    qk = trace[:, None].contiguous()
    sids = set_index_for(cfg, qk)
    nvals = torch.zeros((n, 0), dtype=torch.int32, device=DEVICE)
    cold = init_table(cfg, DEVICE)
    g = seq_owners(cfg, n, DEVICE)
    _, starts = seq_queues(sids, g)
    longest_queue = int((starts[1:] - starts[:-1]).max())
    longest_chain = int(torch.bincount(sids.long()).max())
    # all ACCESS, no chains, no cost plane: ops, chain mask and costs stay
    # None, as access_seq passes them
    device_ms = launches_ms(torch, lambda t: msl_seq_kernel_call(t, sids, qk, nvals, cfg=cfg),
                            [cold.clone() for _ in range(3)])
    partition_ms = time_ms(torch, lambda: seq_queues(sids, g), 5)
    nbytes, ops = seq_bytes_ops(cfg, sids)
    out = {"stream": dist, "capacity": cfg.capacity, "m": cfg.m, "p": cfg.p, "queries": n,
           "hits": int(want.hit.sum()), "evictions": int(want.evicted_valid.sum()),
           "owners": g, "longest_set_chain": longest_chain,
           "longest_owner_queue": longest_queue,
           "seq_wall_s": seq_s, "seq_qps": n / seq_s, "seq_ns_per_query": 1e9 * seq_s / n,
           "seq_device_ms": device_ms, "seq_device_ns_per_query": 1e6 * device_ms / n,
           "partition_ms": partition_ms,
           "onepass_wall_s": one_s, "onepass_qps": n / one_s,
           "onepass_ns_per_query": 1e9 * one_s / n, "onepass_batches": math.ceil(n / BATCH),
           "bound_ms": 1e3 * max(nbytes / HBM_BW, ops / INT32_OPS_PER_S),
           "bound_by": "bytes" if nbytes / HBM_BW >= ops / INT32_OPS_PER_S else "operations",
           "dependency_floor_ms": longest_queue * step_ns * 1e-6,
           "card": smi}
    if g1:
        table1, *res1 = msl_seq_kernel_call(cold.clone(), sids, qk, nvals, cfg=cfg, owners=1)
        if not (torch.equal(table1, seq.table) and torch.equal(res1[0] != 0, want.hit)
                and torch.equal(res1[1], want.pos)):
            raise AssertionError(f"fig07's {dist} stream: msl_seq at G = 1 != at G = {g}")
        out["g1_device_ms"] = launches_ms(
            torch, lambda t: msl_seq_kernel_call(t, sids, qk, nvals, cfg=cfg, owners=1),
            [cold.clone() for _ in range(3)])
        out["g1_dependency_floor_ms"] = n * step_ns * 1e-6
        out["speedup_over_g1"] = out["g1_device_ms"] / device_ms
    log(f"fig07's {dist} stream ({n} queries, capacity {cfg.capacity}, m=2 p=4) on {smi}: "
        f"msl_seq == msl_onepass (hits, pos, evictions, table); G = {g} queues, longest "
        f"{longest_queue} (longest set chain {longest_chain}); {device_ms:.4f} device ms "
        f"({out['seq_device_ns_per_query']:.2f} ns per query; partition {partition_ms:.4f} "
        f"ms), dependency floor {out['dependency_floor_ms']:.4f} ms, bound "
        f"{out['bound_ms']:.5f} ms ({out['bound_by']}); {out['seq_qps']:.4g} queries/s by "
        f"the host clock, one-pass {out['onepass_qps']:.4g}"
        + (f"; G = 1 (bit-equal): {out['g1_device_ms']:.2f} device ms, "
           f"{out['speedup_over_g1']:.1f}x" if g1 else ""))
    return out


def seq_record(torch, keys, vals, summary, step_ns, smi):
    """Phase 6: the sequential kernel's record at the shape of phase 5's
    ``access_seq`` check (SEQ_CFG from a cold table, SEQ_PREFIX queries of
    the main stream): device ms per wrapper call (``launches_ms``: 20
    calls behind one, the partition included), the kernel alone (the
    profiler) and the partition alone, ms per wrapper call on a clone of
    the table, the plain version's ms on the card (one call), the bound;
    then its runs at fig07's scale."""
    from repro_torch.core import MSLRUConfig, init_table, set_index_for
    from repro_torch.kernels.msl_cache import (msl_seq_kernel_call, msl_seq_plain, seq_owners,
                                               seq_queues)

    cfg = MSLRUConfig(**SEQ_CFG)
    qk = keys[:SEQ_PREFIX, None].contiguous()
    qv = vals[:SEQ_PREFIX].contiguous()
    n = SEQ_PREFIX
    args = (set_index_for(cfg, qk), qk, qv)   # all ACCESS: as access_seq passes them
    cold = init_table(cfg, DEVICE)
    ms = launches_ms(torch, lambda t: msl_seq_kernel_call(t, *args, cfg=cfg),
                     [cold.clone() for _ in range(21)])
    call_ms = time_ms(torch, lambda: msl_seq_kernel_call(cold.clone(), *args, cfg=cfg), 20)
    g = seq_owners(cfg, n, DEVICE)
    partition_ms = time_ms(torch, lambda: seq_queues(args[0], g), 20)
    kernel_only_ms = kernel_ms(torch, lambda: msl_seq_kernel_call(cold.clone(), *args, cfg=cfg),
                               20, "msl_seq_kernel")
    got = msl_seq_kernel_call(cold.clone(), *args, cfg=cfg)
    torch.cuda.synchronize()
    t = time.perf_counter()
    want = msl_seq_plain(cold.clone(), *args, cfg=cfg)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t)
    err = max_abs_err(torch, want, got)
    if err:
        raise AssertionError(f"msl_seq: max |err| {err}")
    nbytes, ops = seq_bytes_ops(cfg, args[0])
    rec = {
        "name": "msl_seq",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": "none: the JAX package's jitted lax.scan, src/repro/core/engine.py:290",
        "launches": summary["launches_seq_check"]["msl_seq"],
        "launches_path": f"access_seq on {SEQ_PREFIX} queries of the main stream",
        "max_abs_err": err,
        "ms": ms,
        "ms_by": "CUDA events around 20 back-to-back wrapper calls (the partition included)",
        "kernel_ms": kernel_only_ms,
        "partition_ms": partition_ms,
        "call_ms": call_ms,
        "plain_ms": plain_ms,
        "bound_ms": 1e3 * max(nbytes / HBM_BW, ops / INT32_OPS_PER_S),
        "bound_by": "bytes" if nbytes / HBM_BW >= ops / INT32_OPS_PER_S else "operations",
        "library_ms": None,
        "shape": {"N": n, "S": cfg.num_sets, "A": cfg.assoc, "C": cfg.planes},
        "latency_estimate_ms": n * step_ns * 1e-6,
        "owners": g,
        "fig07_streams": {d: seq_at_fig07_scale(torch, d, step_ns, smi, g1=d == "zipfian")
                          for d in SEQ_STREAMS},
    }
    log(f"msl_seq: {ms:.4f} ms per {n}-query call at G = {g} (the kernel {kernel_only_ms:.4f} "
        f"ms by the profiler, the partition {partition_ms:.4f} ms; plain {plain_ms:.1f} ms), "
        f"bound {rec['bound_ms']:.5f} ms ({rec['bound_by']}), latency estimate "
        f"{rec['latency_estimate_ms']:.4f} ms")
    return rec


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


def run_serving(torch, args=None, cfg=None):
    """Phase 8: the launcher's paged serving path at full width (or the
    path ``args`` describe, on ``cfg`` if given).  Launch counts are zeroed
    just before the serve and read just after."""
    from repro_torch.launch import serve

    args = args or serve_args("--kv-mode", "paged")
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    before = torch.cuda.memory_allocated()
    eng = serve.build(args, cfg=cfg)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in eng.params.parameters())
    init = {"before_gb": before / 1e9, "after_gb": torch.cuda.memory_allocated() / 1e9,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "reserved_gb": torch.cuda.memory_reserved() / 1e9}
    log(f"{eng.cfg.name}: {n_params / 1e9:.3f}B parameters "
        f"({n_params * 2 / 1e9:.2f} GB bf16), pool K+V "
        f"{2 * eng.pool.k.numel() * 2 / 1e6:.0f} MB, slot tails K+V "
        f"{2 * eng.pool.tail_k.numel() * 2 / 1e6:.0f} MB; built in "
        f"{time.perf_counter() - t:.1f} s; device memory {init['before_gb']:.2f} GB "
        f"before, {init['after_gb']:.2f} GB after, peak {init['peak_gb']:.2f} GB, "
        f"reserved {init['reserved_gb']:.2f} GB")
    torch.cuda.reset_peak_memory_stats()      # from here the serve's peak
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
        "init_memory_gb": init,
    }
    log(f"served {summary['finished']}/{len(reqs)} requests in {st['ticks']} ticks, "
        f"{wall:.3f} s wall; peak device memory {summary['peak_memory_gb']:.2f} GB")
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
        "bound_ms": 1e3 * max(nbytes / HBM_BW, ops / F32_OPS_PER_S),
        "bound_by": "bytes" if nbytes / HBM_BW >= ops / F32_OPS_PER_S
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
        f"the device ({r.get('ms_by', 'profiler, L2 flushed')}), {r['call_ms']:.5f} ms per "
        f"wrapper call "
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


def run_full_width(torch, arch, err, buckets=(), cross=False):
    """Phases 14-16(d): ``arch`` at its published width and
    FULL_WIDTH_LAYERS' depth (random weights from a seeded generator on the
    card) through the launcher's paged path with phase 8's checks, the paged
    kernel's record at its shapes and, given window ``buckets``, the
    megastep serve (``megastep_serve``; phase 11's buckets: the launcher's
    request mix plans the same windows for every architecture, since no
    stream ends early).  Each decode tick's ms beside the step's weight read
    (``step_weight_bytes``).  With ``cross``, phase 9's cross-check against
    a contiguous twin.  An M-RoPE model must rotate every call of the serve
    by (B, 3, S) streams, split as ``check_mrope_sections`` checks; an MoE
    model logs its largest prefill dispatch buffer and adds its FFN's device
    time per decode step (``moe_ffn_step``).  Returns the summary and the
    record."""
    from repro_torch.models import attention, moe

    cfg, rotations, dispatches = cut_depth(arch), [], []
    with contextlib.ExitStack() as stack:
        if cfg.rope_kind == "mrope":
            stack.enter_context(recording(
                attention, "apply_mrope", lambda x, pos, *a: rotations.append(tuple(pos.shape))))
        if cfg.ffn == "moe":
            stack.enter_context(recording(
                moe, "moe_apply", lambda p, x, **kw: dispatches.append(tuple(x.shape))))
        eng, reqs, summary, snapshot = run_serving(
            torch, serve_args("--arch", arch, "--kv-mode", "paged"), cfg=cfg)
    summary.update(windows_walked(eng, reqs))
    if cfg.rope_kind == "mrope":
        summary["mrope"] = check_mrope_sections(torch, cfg, rotations)
    if cfg.ffn == "moe":
        summary["moe_dispatch"] = dispatch_buffers(cfg, dispatches)
        summary["moe_ffn"] = moe_ffn_step(torch, eng)
    if cross:
        summary["cross_check"] = cross_check(torch, eng, reqs)
    record = paged_record(torch, eng, snapshot, summary, err,
                          path=f"{cfg.name} serving path")
    if buckets:
        _, summary["megastep"] = megastep_serve(torch, eng, reqs, summary, buckets)
        record["launches_megastep_path"] = summary["megastep"]["launches"]["paged_attn"]
    summary["peak_memory_gb_all"] = torch.cuda.max_memory_allocated() / 1e9
    nbytes = step_weight_bytes(eng)
    summary["step_weight_bytes"] = nbytes
    summary["step_bound_ms"] = 1e3 * nbytes / HBM_BW
    log(f"{cfg.name} at full width, {cfg.n_layers} layers: "
        f"{summary['ms_per_decode_tick']:.3f} ms per decode "
        f"tick, {summary['decode_tokens_per_s']:.1f} decode tokens/s, serve "
        f"{summary['wall_s']:.3f} s wall, decode_launches {summary['decode_launches']}, "
        f"host_syncs {summary['host_syncs']}, peak device memory "
        f"{summary['init_memory_gb']['peak_gb']:.2f} GB at init, "
        f"{summary['peak_memory_gb_all']:.2f} GB from the serve on; paged_attn "
        f"{record['ms']:.5f} ms per "
        f"launch (L2 flushed), {record['ms_in_path']:.5f} in the serving ticks, "
        f"H {cfg.n_heads} on KVH {cfg.n_kv_heads}, Dh {cfg.head_dim}")
    log(f"{cfg.name}: a decode tick reads {nbytes / 1e9:.2f} GB of weights (the "
        f"embedding table left out): {summary['step_bound_ms']:.3f} ms at "
        f"{HBM_BW / 1e12:.2f} TB/s, against {summary['ms_per_decode_tick']:.3f} ms "
        f"in-flight" + (f" and {summary['megastep']['ms_per_decode_tick']:.3f} ms megastep"
                        if buckets else ""))
    log(f"{cfg.name}: windows {summary['windows']} against rows of at most "
        f"{summary['longest_row']} positions: "
        f"{'binding ' + str(summary['binding']) if summary['binding'] else 'no window binds here'}")
    log_record(record)
    return summary, record


@contextlib.contextmanager
def recording(module, name, record):
    """``module.name`` calls ``record`` with each call's arguments first."""
    fn = getattr(module, name)

    def wrapped(*args, **kw):
        record(*args, **kw)
        return fn(*args, **kw)

    setattr(module, name, wrapped)
    try:
        yield
    finally:
        setattr(module, name, fn)


def step_weight_bytes(eng) -> int:
    """The bytes of weights one decode step reads: every parameter but the
    embedding table (a step gathers B of its rows)."""
    return sum(p.numel() * p.element_size() for p in eng.params.parameters()) - (
        eng.params["head"]["embed"].numel() * eng.params["head"]["embed"].element_size())


def check_mrope_sections(torch, cfg, shapes):
    """M-RoPE on the card: every ``apply_mrope`` call of the serve
    (``shapes``: its positions' shapes) rotated by (B, 3, S) streams, and
    ``apply_mrope`` at the config's Dh with three distinct streams equal to
    ``apply_rope`` by stream t on the first quarter of the Dh/2 frequency
    slots, by h on the next three eighths and by w on the last (Qwen2-VL's
    mrope_section [16, 24, 24] at Dh 128), within 1e-5."""
    from repro_torch.models.layers import apply_mrope, apply_rope

    if not shapes or any(len(sh) < 2 or sh[-2] != 3 for sh in shapes):
        raise AssertionError(f"M-RoPE ran on positions other than (B, 3, S) streams: "
                             f"{sorted(set(shapes))}")
    dh, half, s = cfg.head_dim, cfg.head_dim // 2, 16
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 5)
    x = torch.randn((1, s, 2, dh), generator=gen, device=DEVICE)
    pos = torch.stack([torch.arange(s), 3 * torch.arange(s) % 11,
                       300 + 7 * torch.arange(s)])[None].to(DEVICE)
    got = apply_mrope(x, pos, cfg.rope_theta).reshape(1, s, 2, half, 2)
    bounds = [0, half // 4, half // 4 + 3 * half // 8, half]
    err = 0.0
    for i in range(3):
        want = apply_rope(x, pos[:, i], cfg.rope_theta).reshape(1, s, 2, half, 2)
        lo, hi = bounds[i], bounds[i + 1]
        err = max(err, float((got[..., lo:hi, :] - want[..., lo:hi, :]).abs().max()))
    if err > 1e-5:
        raise AssertionError(f"apply_mrope's sections are not {bounds} of {half} slots: "
                             f"max |err| {err}")
    out = {"calls": len(shapes), "positions_shapes": sorted(set(shapes))[:4],
           "sections": [bounds[i + 1] - bounds[i] for i in range(3)], "max_abs_err": err}
    log(f"{cfg.name}: {len(shapes)} apply_mrope calls in the serve, each on (B, 3, S) "
        f"streams; at Dh {dh} the {half} frequency slots split {out['sections']} by stream "
        f"t, h, w (apply_rope per stream within {err:.2e})")
    return out


def dispatch_buffers(cfg, shapes):
    """The largest dispatch buffer of the serve's ``moe_apply`` calls
    (``shapes``: their x shapes): (E, B, capacity, D) bf16, capacity as
    ``moe_apply`` sets it."""
    b, s, d = max(shapes, key=lambda sh: sh[0] * sh[1])
    cap = max(4, int(s * cfg.moe_top_k * cfg.capacity_factor / cfg.n_experts))
    out = {"calls": len(shapes), "x": [b, s, d], "capacity": cap,
           "bytes": cfg.n_experts * b * cap * d * 2}
    log(f"{cfg.name}: {len(shapes)} moe_apply calls in the serve; the largest "
        f"dispatches x {tuple(out['x'])} into ({cfg.n_experts}, {b}, {cap}, {d}) bf16, "
        f"{out['bytes'] / 1e6:.1f} MB")
    return out


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
    step_bytes = step_weight_bytes(eng)
    out = {"device_ms_per_step": ms, "kernels_per_step": sum(v[1] for v in kernels.values())
           / 10, "expert_bytes": expert_bytes,
           "expert_bound_ms": 1e3 * expert_bytes / HBM_BW,
           "step_weight_bytes": step_bytes,
           "step_bound_ms": 1e3 * step_bytes / HBM_BW}
    log(f"{cfg.name}: MoE FFN (moe_decode, {cfg.n_layers} layers, B {eng.slots}) "
        f"{ms:.4f} ms of device time per decode step in {out['kernels_per_step']:.0f} "
        f"kernels; its expert-weight read {expert_bytes / 1e9:.2f} GB is "
        f"{out['expert_bound_ms']:.3f} ms at {HBM_BW / 1e12:.2f} TB/s (the whole "
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
# phases 14-19 keep each model's published width and cut its depth to
# whole periods of its layer pattern, to hold the script inside its limit.
# command-r-35b keeps its whole depth: its 64.8 GB of bf16 weights fit the
# card's 80 GB with the pool and slot cache, so phase 16(b) serves the
# published model.  qwen2-vl-72b (145.4 GB whole) and phi3.5-moe-42b-a6.6b
# (83.7 GB whole) do not fit and run 8 layers; each of the three repeats a
# period of one layer.
FULL_WIDTH_LAYERS = {"starcoder2-7b": 8, "gemma3-1b": 6, "olmoe-1b-7b": 4,
                     "command-r-35b": 40, "qwen2-vl-72b": 8,
                     "phi3.5-moe-42b-a6.6b": 8, HYMBA: 8, XLSTM: 8, WHISPER: 6}


def cut_depth(arch):
    """``arch``'s published config with FULL_WIDTH_LAYERS' depth (an
    encoder keeps its own)."""
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(arch), n_layers=FULL_WIDTH_LAYERS[arch])


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
           "bound_ms": 1e3 * 3 * state_bytes / HBM_BW}
    log(f"{eng.cfg.name}: the freeze (freeze_rows, {len(eng._state)} leaves, one select "
        f"each, {state_bytes / 1e6:.1f} MB of state at {eng.slots} slots) {ms:.4f} ms "
        f"of device time per decode step (CUDA events); moving 3 x the state is "
        f"{out['bound_ms']:.4f} ms at {HBM_BW / 1e12:.2f} TB/s")
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
    """Phases 17-19: ``arch`` (hymba, xLSTM or Whisper; unless ``smoke`` at
    FULL_WIDTH_LAYERS' depth) through ``serve.build``
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
    eng = serve.build(args, cfg=None if smoke else cut_depth(arch))
    torch.cuda.synchronize()
    cfg = eng.cfg
    n_params = sum(p.numel() for p in eng.params.parameters())
    kv_mb = sum(eng.cache[n].numel() * 2 for n in ("k", "v") if n in eng.cache) / 1e6
    kept_mb = sum(x.numel() * x.element_size() for x in kept_leaves(eng)) / 1e6
    log(f"{cfg.name}: {cfg.n_layers} layers, {n_params / 1e9:.3f}B parameters "
        f"({n_params * 2 / 1e9:.2f} GB bf16), {cfg.meta_tokens} meta tokens, slot KV {kv_mb:.0f} MB, recurrent state and "
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


def serve_record(eng) -> dict:
    """What a served run reports, kept on the host to hold another run
    against: finish order, prefill split, tokens, ticks, fault log, every
    stats and prefix-cache key, the pool's balance and the backend's table
    (gathered over its ranks)."""
    pool = eng.pool
    return {"order": [r.rid for r in eng.finished],
            "prefill": [(r.rid, r.prefill_skipped, r.prefill_computed) for r in eng.finished],
            "tokens": {r.rid: list(r.out_tokens) for r in eng.finished},
            "ticks": eng.ticks, "fault_log": list(eng.fault_log), "stats": eng.stats(),
            "prefix_cache": eng.prefix_cache.stats(),
            "pool": (pool.refcount.tolist(), pool.free_pages, len(pool._reserved)),
            "table": eng.prefix_cache.cache.gathered_table()}


def sharded_serve(torch, args, reqs, plan=None, buckets=(), mesh=None, keep=None):
    """One serve of ``reqs`` through ``serve.build(args)`` (the weights made
    from ``--seed`` anew), launches counted from zero just before it to just
    after (a megastep engine's window ``buckets`` captured first, as in
    phase 11).  Returns the engine and the serve's numbers (the
    shed/split/throttle stats among them; megastep: the windows a fault's
    tick capped below what ``_plan_window`` plans without the cap; ms per
    applied fault).  With ``mesh`` (a ``ProcessCacheMesh``, on world rank
    0) the backend is on its ranks and this rank leads them through the
    serve and its reads; ``keep`` (a dict) receives ``serve_record``."""
    from repro_torch.launch import serve

    eng = serve.build(args, mesh=mesh)
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
    ms = {"access": [], "placement": [], "fault": []}
    timed_backend(eng.prefix_cache.cache, ms)
    apply_fault = eng.apply_fault

    def timed_fault(ev):
        torch.cuda.synchronize()
        t = time.perf_counter()
        apply_fault(ev)
        torch.cuda.synchronize()
        ms["fault"].append(1e3 * (time.perf_counter() - t))

    eng.apply_fault = timed_fault
    lead = (contextlib.nullcontext() if mesh is None
            else eng.prefix_cache.cache.leading())
    with lead:
        zero_launches()
        wall, decode_ticks = serve_with_faults(torch, eng, fresh(reqs), plan)
        launches = read_launches()
        st, pc = eng.stats(), eng.prefix_cache.stats()
        if keep is not None:
            keep.update(serve_record(eng))
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
           "ms_per_applied_fault": ms["fault"],
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


def run_sharded_serving(torch, phase8, buckets, keep=None):
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
    page leaks, and the tokens equal phase 8's or split at a near-tie.
    ``keep`` (a dict) receives the first bounded serve's ``serve_record``
    (phase 31(b) holds its serve with the cache across processes to it)."""
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
        eng, rec = sharded_serve(torch, bargs, reqs, serve.fault_plan(bargs), buckets,
                                 keep=keep if i == 0 else None)
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
PHI3 = "phi3-mini-3.8b"
CUT_LAYERS = 1              # phases 23(a), 29, 30(b): phi3-mini cut to this depth
FULL_STEPS = 6              # phase 23(b): steps at full width and depth
SMOKE_STEPS = 150           # phase 24: the train_smoke example's run, cut from 300
SMOKE_RESUME = 100          # ... resumed from this step's checkpoint
SMOKE_LOG_EVERY = 20         # the example's


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
    """Phase 23: phi3-mini-3.8b at full width.  (a) Depth cut to CUT_LAYERS,
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
    cut = dataclasses.replace(full, n_layers=CUT_LAYERS)
    args = train_args("--arch", PHI3, "--seq-len", "256", "--global-batch", "1",
                      "--steps", "1")
    card, data = train.build(args, cut)
    card.init_state(resume=False)
    cpu = twin(torch, card, train_args("--arch", PHI3, "--seq-len", "256",
                                       "--global-batch", "1", "--device", "cpu"), cut)
    with recorded_update(torch) as rec:
        want = step_once(torch, cpu, data)
    got = step_once(torch, card, data)
    what = f"phi3-mini-3.8b, {CUT_LAYERS} layer(s)"
    out["depth_cut"] = {"params": cut.param_count(), "loss_cpu": want[0]["loss"],
                      "loss_card": got[0]["loss"], "cpu_step_ms": want[2],
                      "card_step_ms": got[2],
                      **compare_steps(torch, want, got, what),
                      **card_update(torch, rec, f"{what}, AdamW")}
    del rec
    r = out["depth_cut"]
    log(f"{what} ({r['params']:,} parameters), 1 x 256: loss "
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


def example(name: str):
    """``examples/<name>.py`` as a module (its ``main`` not run)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"example_{name}",
                                                  ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_train_smoke(torch):
    """Phase 24: ``examples/torch_train_smoke.py``'s ``main`` on the card
    (its config, 128 x 8, lr 3e-3, warm-up 20, 2 microbatches, logged every
    20 steps) for SMOKE_STEPS steps, cosine to SMOKE_STEPS, checkpoints at
    step 100 and at the end in a temporary directory: the loss drops by
    more than 0.3 from the first logged step to the last; a fresh trainer
    (``build_train_smoke``) restored from step SMOKE_RESUME replays the rest
    with the first run's logged losses bit for bit."""
    import tempfile

    from repro_torch.launch import train
    from repro_torch.train import checkpoint as ckpt

    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        run = example("torch_train_smoke").main(["--steps", str(SMOKE_STEPS), "--ckpt-dir",
                                                 tmp, "--device", DEVICE])
        wall = time.perf_counter() - t
        hist = run["history"]
        replay, data = train.build_train_smoke(SMOKE_STEPS, device=DEVICE)
        replay.init_state(resume=False)
        _, replay.step = ckpt.restore(tmp, {"params": replay.params, "opt": replay.opt_state},
                                      step=SMOKE_RESUME)
        again = replay.run(data, SMOKE_STEPS - SMOKE_RESUME, log_every=SMOKE_LOG_EVERY)
    first, last = hist[0]["loss"], hist[-1]["loss"]
    if run["state"] != "fresh" or not run["learned"] or not last < first - 0.3:
        raise AssertionError(f"train_smoke: {run['state']} run, loss {first} -> {last}, no "
                             f"clear learning")
    want = [(h["step"], h["loss"]) for h in hist if h["step"] > SMOKE_RESUME]
    got = [(h["step"], h["loss"]) for h in again]
    if not got or got != want:
        raise AssertionError(f"train_smoke: the replay from step {SMOKE_RESUME} gave {got}, "
                             f"the first run {want}")
    out = {"params": run["params"], "steps": SMOKE_STEPS,
           "loss_first": first, "loss_last": last, "wall_s": wall,
           "ms_per_step": wall / SMOKE_STEPS * 1e3, "replayed_steps": [s for s, _ in got],
           "replay_bit_equal": True}
    log(f"train_smoke ({out['params']:,} parameters): loss {first:.4f} -> {last:.4f} in "
        f"{SMOKE_STEPS} steps ({out['ms_per_step']:.1f} ms per step with the logging and "
        f"its checkpoints); the replay from step {SMOKE_RESUME} gives the losses at steps "
        f"{out['replayed_steps']} bit for bit")
    return out


# ---------------------------------------------------------------------------
# The Python oracle and the paper's claims on the card (phases 25-26)
# ---------------------------------------------------------------------------

# phase 25: (m, p, sets, key planes, cost planes, policy), 2 value planes
ORACLE_GEOMS = [(1, 4, 2**12, 1, 1, "multistep"),
                (2, 4, 2**11, 2, 1, "multistep"),
                (4, 4, 2**10, 1, 0, "set_lru"),
                (8, 4, 2**10, 2, 1, "multistep"),       # A = 32, the kernels' widest
                (2, 8, 2**11, 1, 1, "set_lru")]
ORACLE_BATCHES = 8
# phase 26: the figures' scale (benchmarks/common.py N_KEYS, N_QUERIES; the
# figure scripts' seeds and capacities)
FIG_KEYS = 1_000_000
FIG_QUERIES = 2_000_000
FIG07_CAPS = [4096, 16384, 65536, 262144]
FIG_CAP = 65536                 # figs 11-15's capacity; claims c1-c3 at it too
FIG15_WINDOWS = [2**i for i in range(12, 21)]
# c6's early window: tests/test_paper_claims.py's 20000 queries at capacity
# 4096, scaled to FIG_CAP
C6_WINDOW = 20_000 * FIG_CAP // 4096
FIG08_QUERIES = 1_000_000
FIG08_CAPS = [16384, 262144]
BASELINE_QUERIES = 300_000      # fig08's Python baselines
HOST_WORKERS = 6                # processes for phase 26's host-only work


def oracle_cases():
    """``tests/torch_oracle_cases.py``: the mixed-op batches and checks the
    CPU tests hold the plain versions to (numpy and the port only)."""
    sys.path.insert(0, str(ROOT / "tests"))
    import torch_oracle_cases

    return torch_oracle_cases


def run_oracle(torch):
    """Phase 25: ``MultiStepLRUOracle.apply_batch`` against
    ``MultiStepLRUCache`` on the card, ``engine="onepass"`` and ``"rounds"``
    (both msl kernels), in each of ``ORACLE_GEOMS``: ORACLE_BATCHES seeded
    batches of BATCH mixed rows (single ops, prefix-cache chains, costs);
    per row hit, pos, value and the evicted (key, value, valid) bit-equal,
    and after each batch the table's keys equal to the oracle's."""
    import numpy as np

    from repro_torch.core import MSLRUConfig, MultiStepLRUCache

    oc = oracle_cases()
    out = {"geometries": [], "batch": BATCH, "batches": ORACLE_BATCHES}
    zero_launches()
    oracle_s = 0.0
    for m, p, sets, kp, cp, policy in ORACLE_GEOMS:
        cfg = MSLRUConfig(num_sets=sets, m=m, p=p, key_planes=kp, value_planes=2,
                          cost_planes=cp, policy=policy)
        rng = np.random.default_rng(SEED + 100 * m + p)
        oracle = oc.oracle_for(cfg)
        caches = {e: MultiStepLRUCache(cfg, engine=e, device=DEVICE)
                  for e in ("onepass", "rounds")}
        rec = {"m": m, "p": p, "sets": sets, "key_planes": kp, "cost_planes": cp,
               "policy": policy, "hits": 0, "evictions": 0, "chain_rows": 0}
        for i in range(ORACLE_BATCHES):
            batch = oc.mixed_batch(rng, cfg, BATCH, 3 * cfg.capacity)
            t = time.perf_counter()
            recs = oc.apply_oracle(oracle, cfg, batch)
            oracle_s += time.perf_counter() - t
            args = [torch.from_numpy(batch[k]).to(DEVICE)
                    for k in ("keys", "vals", "ops", "chain_ids")]
            args.append(torch.from_numpy(batch["costs"]).to(DEVICE) if cp else None)
            for name, cache in caches.items():
                res = cache.access(*args)
                res = type(res)(*(x.cpu().numpy() for x in res))
                bad = oc.mismatches(cfg, recs, res)
                if bad:
                    raise AssertionError(f"{name} engine against the oracle, {cfg}, batch "
                                         f"{i}: rows {bad}")
                bad = oc.table_mismatch(cfg, oracle, cache.table.cpu().numpy())
                if bad:
                    raise AssertionError(f"{name} engine's table against the oracle, {cfg}, "
                                         f"batch {i}: slots {bad}")
            rec["hits"] += sum(r["hit"] for r in recs)
            rec["evictions"] += sum(r["evicted"] is not None for r in recs)
            rec["chain_rows"] += int((batch["chain_ids"] > 0).sum())
        out["geometries"].append(rec)
        log(f"oracle == msl_onepass == msl_access: m={m} p={p} (A = {m * p}), {sets} sets, "
            f"key planes {kp}, cost planes {cp}, {policy}: {ORACLE_BATCHES} x {BATCH} rows "
            f"({rec['chain_rows']} in chains), {rec['hits']} hits, {rec['evictions']} "
            f"evictions; every row and the table bit-equal")
        del caches
    out["launches"] = read_launches()
    for name in ("msl_onepass", "msl_access"):
        if not out["launches"][name]:
            raise AssertionError(f"phase 25 launched no {name}")
    n = len(ORACLE_GEOMS) * ORACLE_BATCHES * BATCH
    out["oracle_us_per_row"] = oracle_s / n * 1e6
    log(f"{n} rows per engine; the oracle {out['oracle_us_per_row']:.2f} µs per row on the "
        f"host; launches {out['launches']}")
    return out


def fig_cfg(cap, m=2, p=4, policy="multistep", cost=False):
    """A figure's geometry at item capacity ``cap``: 32-bit keys, no values
    (benchmarks/common.py ``msl_cfg``)."""
    from repro_torch.core import MSLRUConfig

    return MSLRUConfig(num_sets=cap // (m * p), m=m, p=p, value_planes=0, policy=policy,
                       cost_planes=int(cost))


def kernel_stream(torch, cfg, trace, costs=None, table=None):
    """A trace (int32 on the card) through ``MultiStepLRUCache`` (one-pass,
    the kernel) in BATCH-query batches: hits and pos on the host, ms per
    batch and queries/s (host clock around the whole stream)."""
    from repro_torch.core import MultiStepLRUCache

    cache = MultiStepLRUCache(cfg, device=DEVICE)
    if table is not None:
        cache.load_table(table)
    n = trace.numel()
    hit = torch.empty(n, dtype=torch.bool, device=DEVICE)
    pos = torch.empty(n, dtype=torch.int32, device=DEVICE)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for s in range(0, n, BATCH):
        res = cache.access(trace[s:s + BATCH],
                           costs=None if costs is None else costs[s:s + BATCH])
        hit[s:s + BATCH] = res.hit
        pos[s:s + BATCH] = res.pos
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    return {"hit": hit.cpu().numpy(), "pos": pos.cpu().numpy(),
            "ms_per_batch": wall * 1e3 / math.ceil(n / BATCH), "qps": n / wall}


def msl_record(r, costs=None):
    """A stream's hit ratio, ms per batch and queries/s; with ``costs``
    (per query) the summed cost of the misses."""
    import numpy as np

    rec = {"hit_ratio": float(r["hit"].mean()), "ms_per_batch": r["ms_per_batch"],
           "qps": r["qps"]}
    if costs is not None:
        rec["miss_cost"] = int(costs[~r["hit"]].astype(np.int64).sum())
    return rec


def python_baseline(name, trace, cap):
    """``benchmarks/common.py`` ``run_python_algo`` on the port's classes:
    hit ratio and µs per query on the host (ARC with its t1/t2 hits)."""
    from repro_torch.core import policies

    algo = {"lru": policies.ExactLRU, "gclock": policies.GClock, "arc": policies.ARC,
            "fifo": policies.FIFO}[name](cap)
    hits = t1 = 0
    t = time.perf_counter()
    for k in trace:
        if algo.access(k):
            hits += 1
            t1 += name == "arc" and algo.last_hit_list == "t1"
    dt = time.perf_counter() - t
    rec = {"hit_ratio": hits / len(trace), "us_per_query": dt / len(trace) * 1e6}
    if name == "arc":
        rec.update(t1_hits=t1, t2_hits=hits - t1)
    return rec


_TRACES: dict = {}


def host_trace(spec) -> list:
    """A figure's trace as a host list, made anew from its seed in a worker
    (the last one kept): ``("workload", dist, keys, n, alpha, seed)`` is
    ``make_workload``'s, ``("zipfian", None, keys, n, alpha, seed)``
    ``zipfian``'s."""
    from repro_torch.data.ycsb import make_workload, zipfian

    if spec not in _TRACES:
        kind, dist, n_keys, n, alpha, seed = spec
        trace = (make_workload(dist, n_keys, n, alpha, seed=seed) if kind == "workload"
                 else zipfian(n_keys, n, alpha=alpha, seed=seed))
        _TRACES.clear()
        _TRACES[spec] = trace.tolist()
    return _TRACES[spec]


def host_baseline(name, spec, cap, head=None):
    """``python_baseline`` on the first ``head`` queries of ``spec``'s trace."""
    return python_baseline(name, host_trace(spec)[:head], cap)


def host_reuse_lru(spec, caps) -> dict:
    """The Mattson exact LRU's hit ratio at each capacity, and µs per query."""
    from repro_torch.core import policies

    trace = host_trace(spec)
    t = time.perf_counter()
    rd = policies.ReuseDistanceLRU(len(trace))
    rd.feed(trace)
    out = {str(c): rd.hit_ratio(c) for c in caps}
    out["us_per_query"] = (time.perf_counter() - t) / len(trace) * 1e6
    return out


def host_oracle(spec, cap):
    """``MultiStepLRUOracle`` (m = 2, p = 4) over ``spec``'s trace: (hit,
    pos, µs per query)."""
    import numpy as np

    from repro_torch.core import policies

    trace = host_trace(spec)
    t = time.perf_counter()
    oracle = policies.MultiStepLRUOracle(cap // 8, 2, 4)
    want = [oracle.access(k) for k in trace]
    us = (time.perf_counter() - t) / len(trace) * 1e6
    return (np.fromiter((w[0] for w in want), bool, len(want)),
            np.fromiter((w[1] for w in want), np.int32, len(want)), us)


def run_paper_claims(torch):
    """Phase 26: the paper's figures' configurations through the one-pass
    kernel at the figures' scale (1M keys, 2M queries, Zipf 0.99), the
    whole 2M-query hit and pos stream of fig07 zipfian at 65536, m = 2
    against the port's oracle, and claims c1-c6 of
    tests/test_paper_claims.py with its margins against the port's
    ``ReuseDistanceLRU`` and ``ARC``.  The oracle and the Python baselines
    run on the host in HOST_WORKERS spawned processes meanwhile, each on a
    trace made anew from its seed; their µs per query are taken there."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    with ProcessPoolExecutor(HOST_WORKERS,
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        try:
            return _paper_claims(torch, pool)
        except BaseException:
            pool.shutdown(wait=False, cancel_futures=True)
            raise


def _paper_claims(torch, pool):
    import numpy as np

    from repro_torch.core import init_table, table_to_numpy
    from repro_torch.data.ycsb import make_workload, zipfian

    t_phase = time.perf_counter()
    zero_launches()
    out = {"keys": FIG_KEYS, "queries": FIG_QUERIES, "alpha": ZIPF_ALPHA, "batch": BATCH,
           "host_workers": HOST_WORKERS,
           "cuts": ["fig07: the Mattson LRU, GCLOCK and ARC rows for the zipfian trace only",
                    "fig12: ARC's t1/t2 split not run"]}
    # the host's work first, longest first: it runs while the card streams
    z07 = ("workload", "zipfian", FIG_KEYS, FIG_QUERIES, ZIPF_ALPHA, 7)
    z08 = ("zipfian", None, FIG_KEYS, FIG08_QUERIES, ZIPF_ALPHA, 11)
    host = {"oracle": pool.submit(host_oracle, z07, FIG_CAP),
            "lru": pool.submit(host_reuse_lru, z07, FIG07_CAPS)}
    for name in ("arc", "gclock"):
        for cap in FIG07_CAPS:
            host[name, cap] = pool.submit(host_baseline, name, z07, cap)
    host["fig11_arc"] = pool.submit(
        host_baseline, "arc", ("zipfian", None, FIG_KEYS, FIG_QUERIES, ZIPF_ALPHA, 5), FIG_CAP)
    for cap in FIG08_CAPS:
        for name in ("lru", "gclock", "arc", "fifo"):
            host["fig08", name, cap] = pool.submit(host_baseline, name, z08, cap,
                                                   BASELINE_QUERIES)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(DEVICE)

    # fig07: hit ratio against capacity, three distributions, seed 7
    fig07 = {}
    for dist in ("zipfian", "latest", "scan"):
        trace = make_workload(dist, FIG_KEYS, FIG_QUERIES, ZIPF_ALPHA, seed=7)
        kcost = (1 + trace % 8).astype(np.int32)
        tt, tc = dev(trace), dev(kcost)
        row = {k: {} for k in ("invector", "multistep", "cost", "set_lru")}
        for cap in FIG07_CAPS:
            c = str(cap)
            row["invector"][c] = msl_record(kernel_stream(torch, fig_cfg(cap, m=1), tt))
            ms = kernel_stream(torch, fig_cfg(cap), tt)
            row["multistep"][c] = msl_record(ms, kcost)
            row["cost"][c] = msl_record(kernel_stream(torch, fig_cfg(cap, cost=True), tt,
                                                      costs=tc), kcost)
            row["set_lru"][c] = msl_record(kernel_stream(torch, fig_cfg(cap,
                                                                        policy="set_lru"), tt))
            if dist == "zipfian" and cap == FIG_CAP:
                oracle_ms = ms
        fig07[dist] = row
    out["fig07"] = fig07

    # fig11: M sweep at 65536, seed 5
    trace = zipfian(FIG_KEYS, FIG_QUERIES, alpha=ZIPF_ALPHA, seed=5)
    tt = dev(trace)
    fig11 = {f"M{m}": msl_record(kernel_stream(torch, fig_cfg(FIG_CAP, m=m), tt))
             for m in (1, 2, 4, 8)}
    out["fig11"] = fig11

    # fig12: hits by vector, M 2/4/8, seed 9
    fig12 = {}
    for dist in ("zipfian", "latest", "scan"):
        tt = dev(make_workload(dist, FIG_KEYS, FIG_QUERIES, ZIPF_ALPHA, seed=9))
        fig12[dist] = {}
        for m in (2, 4, 8):
            r = kernel_stream(torch, fig_cfg(FIG_CAP, m=m), tt)
            vec = r["pos"][r["pos"] >= 0] // 4
            frac = np.bincount(vec, minlength=m) / max(1, len(vec))
            fig12[dist][f"M{m}"] = dict(msl_record(r), vector_frac=frac.tolist())
        log(f"fig12 {dist}: " + "; ".join(
            f"{k} [{' '.join(f'{x:.3f}' for x in v['vector_frac'])}]"
            for k, v in fig12[dist].items()))
    out["fig12"] = fig12

    # fig13: P = 8, seed 13
    tt = dev(zipfian(FIG_KEYS, FIG_QUERIES, alpha=ZIPF_ALPHA, seed=13))
    out["fig13"] = {f"p{p}_m{m}": msl_record(kernel_stream(torch, fig_cfg(FIG_CAP, m=m, p=p),
                                                           tt))
                    for p, m in ((4, 2), (8, 2), (8, 1), (4, 4))}
    log("fig13 (65536, zipfian): " + ", ".join(f"{k} {v['hit_ratio']:.4f}"
                                                for k, v in out["fig13"].items()))

    # fig15: warm-up from a garbage-filled table, seed 15
    tt = dev(zipfian(FIG_KEYS, FIG_QUERIES, alpha=ZIPF_ALPHA, seed=15))
    garbage = np.random.default_rng(0).integers(2**29, 2**30, (FIG_CAP // 8, 8))
    fig15, early = {}, {}
    for name, policy, filled in (("multistep_garbage", "multistep", True),
                                 ("set_lru_garbage", "set_lru", True),
                                 ("multistep_empty", "multistep", False)):
        cfg = fig_cfg(FIG_CAP, policy=policy)
        table = None
        if filled:
            table = table_to_numpy(init_table(cfg, "cpu"))
            table[:, :, 0] = garbage
        r = kernel_stream(torch, cfg, tt, table=table)
        cum = np.cumsum(r["hit"])
        fig15[name] = {str(w): float(cum[w - 1] / w) for w in FIG15_WINDOWS}
        early[name] = float(r["hit"][:C6_WINDOW].mean())
    out["fig15"] = fig15
    log("fig15 cumulative hit ratio at " + " ".join(map(str, FIG15_WINDOWS)) + ": " + "; ".join(
        f"{k} " + " ".join(f"{v:.4f}" for v in r.values()) for k, r in fig15.items()))

    # fig08's shape: 1M queries, seed 11, batch's longest chain, baselines
    trace = zipfian(FIG_KEYS, FIG08_QUERIES, alpha=ZIPF_ALPHA, seed=11)
    tt = dev(trace)
    chains = max_chain_per_batch(torch, fig_cfg(FIG08_CAPS[0]),
                                 tt[:len(trace) // BATCH * BATCH])
    fig08 = {"max_chain_per_batch": {"mean": float(chains.float().mean()),
                                     "max": int(chains.max())}}
    for cap in FIG08_CAPS:
        for m in (1, 2):
            fig08[f"msl_m{m}_{cap}"] = msl_record(kernel_stream(torch, fig_cfg(cap, m=m), tt))
    out["fig08"] = fig08

    # the host's results: the oracle's stream against the kernel's, the
    # baselines into their figures
    hit, pos, us = host["oracle"].result()
    if not (np.array_equal(hit, oracle_ms["hit"]) and np.array_equal(pos, oracle_ms["pos"])):
        first = int(np.flatnonzero((hit != oracle_ms["hit"]) | (pos != oracle_ms["pos"]))[0])
        raise AssertionError(f"fig07 zipfian {FIG_CAP}: the kernel's stream differs from the "
                             f"oracle's from query {first}")
    out["oracle_stream"] = {"queries": FIG_QUERIES, "capacity": FIG_CAP, "m": 2,
                            "equal": True, "oracle_us_per_query": us}
    log(f"fig07 zipfian, capacity {FIG_CAP}, m = 2: the kernel's {FIG_QUERIES} hits and "
        f"positions equal the oracle's ({us:.2f} µs per query)")
    fig07["zipfian"]["lru"] = host["lru"].result()
    for name in ("gclock", "arc"):
        fig07["zipfian"][name] = {str(c): host[name, c].result() for c in FIG07_CAPS}
    for dist, row in fig07.items():
        log(f"fig07 {dist}: " + "; ".join(
            f"{algo} " + " ".join(f"{(v if isinstance(v, float) else v['hit_ratio']):.4f}"
                                  for k, v in r.items() if k != "us_per_query")
            for algo, r in row.items()))
        log(f"  kernel ms per batch (multistep) " + " ".join(
            f"{r['ms_per_batch']:.3f}" for r in row["multistep"].values())
            + "; miss cost multistep / cost " + " ".join(
            f"{row['multistep'][str(c)]['miss_cost']}/{row['cost'][str(c)]['miss_cost']}"
            for c in FIG07_CAPS))
    fig11["arc"] = host["fig11_arc"].result()
    log("fig11 (65536, zipfian): " + ", ".join(f"{k} {v['hit_ratio']:.4f}"
                                                for k, v in fig11.items()))
    for cap in FIG08_CAPS:
        for name in ("lru", "gclock", "arc", "fifo"):
            fig08[f"{name}_{cap}"] = host["fig08", name, cap].result()
    log("fig08 (1M queries): " + "; ".join(
        f"{k} {v['hit_ratio']:.4f} " + (f"{v['ms_per_batch']:.3f} ms/batch {v['qps']:.4g} q/s"
                                        if "qps" in v else f"{v['us_per_query']:.2f} µs/q")
        for k, v in fig08.items() if k != "max_chain_per_batch")
        + f"; longest chain per batch mean {fig08['max_chain_per_batch']['mean']:.1f}, max "
          f"{fig08['max_chain_per_batch']['max']}")

    # the claims, with tests/test_paper_claims.py's margins
    z, c = fig07["zipfian"], str(FIG_CAP)
    m1, m2 = z["invector"][c]["hit_ratio"], z["multistep"][c]["hit_ratio"]
    sl, lru = z["set_lru"][c]["hit_ratio"], z["lru"][c]
    f11 = {k: v["hit_ratio"] for k, v in fig11.items()}
    vec = fig12["zipfian"]["M4"]["vector_frac"]
    claims = {
        "c1_multistep_beats_exact_lru": m2 > lru,
        "c2_multistep_beats_invector": m2 > m1,
        "c3_invector_below_set_lru_below_lru": m1 <= sl + 0.002 and sl <= lru + 0.002,
        "c4_rises_with_m_toward_arc": (f11["M1"] < f11["M2"] <= f11["M4"] + 5e-3
                                       and f11["M8"] >= f11["M4"] - 0.01
                                       and max(f11["M4"], f11["M8"]) >= 0.85 * f11["arc"]),
        "c5_vector0_dominates": vec[0] == max(vec),
        "c6_warmup_penalty": (early["multistep_garbage"]
                              <= early["set_lru_garbage"] + 0.005),
    }
    out["claims"] = claims
    out["claims_inputs"] = {"m1": m1, "m2": m2, "set_lru": sl, "lru": lru, "fig11": f11,
                            "fig12_zipfian_M4": vec, "c6_window": C6_WINDOW,
                            "c6_early": early}
    log(f"claims at the figures' scale: {claims}; m1 {m1:.4f} set_lru {sl:.4f} lru "
        f"{lru:.4f} m2 {m2:.4f}; first {C6_WINDOW} queries from garbage: multistep "
        f"{early['multistep_garbage']:.4f}, set_lru {early['set_lru_garbage']:.4f}")
    failed = [k for k, ok in claims.items() if not ok]
    if failed:
        raise AssertionError(f"paper claims that do not hold at the figures' scale: {failed}")
    out["launches"] = read_launches()
    if not out["launches"]["msl_onepass"]:
        raise AssertionError("phase 26 launched no msl_onepass")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 26: {out['seconds']:.1f} s, launches {out['launches']}")
    return out


# ---------------------------------------------------------------------------
# Step bundles, specs and the dry run (phase 27)
# ---------------------------------------------------------------------------

BUNDLE_BATCH = 4            # decode_32k's 128 x 32768 KV is about 1.6 TB:
BUNDLE_SEQ = 4096           # cut to 4 x 4096 (6.4 GB of KV)
BUNDLE_PROMPT = 1024
BUNDLE_STEPS = 8
DRYRUN_TRAIN_CUT = (2, 1024)        # phase 23(b)'s batch and sequence
# Counted FLOPs of the cut train cell against ``train_flops``: non-reentrant
# checkpointing stops each recompute at the last tensor backward needs, so
# no layer recomputes its w_down product (2 d f per token) and no attention
# chunk its p.V product (2 S H Dh per query), which ``train_flops`` counts.
DRYRUN_FLOPS_RTOL = 1e-3    # counted against train_flops less those two
DRYRUN_FLOPS_GAP = 0.06     # counted against train_flops itself


def run_step_bundles(torch):
    """Phase 27(a): phi3-mini-3.8b at full width on the card, random seeded
    weights: ``bundle_for``'s prefill step and its serve step (logits, and
    greedy) over ``decode_specs``'s shapes made real at BUNDLE_BATCH x
    BUNDLE_SEQ; the prompt's cache written into the decode cache, then
    BUNDLE_STEPS decode steps, each against ``model.decode_step`` (plus
    argmax) on a copy of the cache: logits and tokens bit-equal."""
    from repro_torch.configs import get_config
    from repro_torch.configs import specs
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.steps import bundle_for
    from repro_torch.models.model import make_model

    cfg = get_config(PHI3)
    model = make_model(cfg)
    b, s, n = BUNDLE_BATCH, BUNDLE_SEQ, BUNDLE_PROMPT
    pb = bundle_for(cfg, ShapeSpec("prefill_cut", n, b, "prefill"))
    sb = bundle_for(cfg, ShapeSpec("decode_cut", s, b, "decode"))
    gb = bundle_for(cfg, ShapeSpec("decode_cut", s, b, "decode"), greedy=True)
    params = model.init(torch.Generator(device=DEVICE).manual_seed(SEED))
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    batch = {k: torch.randint(0, cfg.vocab_size, v.shape, generator=gen, device=DEVICE,
                              dtype=v.dtype) for k, v in pb.abstract_args[1].items()}
    with torch.no_grad():
        logits, pcache = pb.fn(params, batch)
        want, _ = model.prefill(params, batch)
        if not torch.equal(logits, want):
            raise AssertionError("prefill bundle: logits differ from model.prefill")
        _, cache_spec, len_spec = sb.abstract_args[1:]
        cache = model.init_cache(b, s, device=DEVICE)
        for name, spec in cache_spec.items():
            if (cache[name].shape, cache[name].dtype) != (spec.shape, spec.dtype):
                raise AssertionError(f"decode_specs {name}: {spec.shape} {spec.dtype}, the "
                                     f"cache {cache[name].shape} {cache[name].dtype}")
            cache[name][:, :, :n] = pcache[name]
        del pcache
        twin = {k: v.clone() for k, v in cache.items()}
        tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
        streams = []
        for i in range(BUNDLE_STEPS):
            cur = torch.tensor(n + i, dtype=len_spec.dtype, device=DEVICE)
            got_logits, _ = sb.fn(params, tok, cache, cur)
            got_tok, _ = gb.fn(params, tok, twin, cur)   # writes the same KV again
            want_logits, _ = model.decode_step(params, tok, twin, cur)
            if not torch.equal(got_logits, want_logits):
                raise AssertionError(f"serve bundle, step {i}: logits differ from decode_step")
            want_tok = torch.argmax(want_logits, -1).to(torch.int32)
            if not torch.equal(got_tok, want_tok):
                raise AssertionError(f"greedy serve bundle, step {i}: tokens differ")
            streams.append(got_tok.cpu().tolist())
            tok = got_tok[:, None]
        if not all(torch.equal(cache[k], twin[k]) for k in cache):
            raise AssertionError("the serve bundle's cache differs from decode_step's")
    out = {"arch": PHI3, "batch": b, "max_len": s, "prompt": n, "steps": BUNDLE_STEPS,
           "cut": f"decode_32k's 128 x 32768 to {b} x {s}", "tokens": streams,
           "equal": True}
    log(f"phi3-mini-3.8b bundles at full width, {b} x {s} (prompt {n}): prefill logits and "
        f"{BUNDLE_STEPS} serve steps' logits and greedy tokens equal model.prefill and "
        f"model.decode_step + argmax bit for bit; the cache shapes equal decode_specs'")
    del params, cache, twin
    release(torch)
    return out


def run_dryrun(torch, phase23):
    """Phase 27(b): the dry run of phi3-mini-3.8b's four cells on the meta
    device (``launch/dryrun.py`` ``run_cell``; long_500k skipped: no long
    context), then phase 23(b)'s cut train cell (1024 x 2, remat full, one
    microbatch): its counted FLOPs against ``train_flops`` (DRYRUN_FLOPS_RTOL
    once the recomputes that checkpointing stops early are taken off, and
    DRYRUN_FLOPS_GAP against the whole), its terms beside phase 23(b)'s
    measured step, its memory beside the measured peak."""
    import dataclasses
    import tempfile

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun

    out = {"cells": {}}
    with tempfile.TemporaryDirectory() as tmp:
        for shape in SHAPES:
            rec = dryrun.run_cell(PHI3, shape, Path(tmp))
            out["cells"][shape] = rec
            log(f"dry run {rec['cell']}: " + ("skipped" if rec["skipped"] else
                                              f"{dryrun.summary(rec)} ({rec['trace_s']:.1f} s)"))
        # the production meshes' records (the sharded step traced per device)
        # are phase 30(c)'s
    cfg = get_config(PHI3)
    b, s = DRYRUN_TRAIN_CUT
    rec = dryrun.analyze_cell(cfg, ShapeSpec("train_cut", s, b, "train"), microbatches=1)
    flops = train_flops(dataclasses.replace(cfg, remat="full"), b, s, "full")
    d, f, h, dh, layers = cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.head_dim, cfg.n_layers
    early_stop = 2 * d * f * b * s * layers + 2 * b * s * s * h * dh * layers
    counted = rec["per_device"]["flops"]
    gap = counted / flops["total"] - 1
    rel = abs(counted - (flops["total"] - early_stop)) / counted
    full = phase23["full"]
    rec.update({"train_flops": flops["total"], "early_stop_flops": early_stop,
                "gap_to_train_flops": gap, "rel_to_train_flops_less_early_stop": rel,
                "measured_ms_per_step": full["ms_per_step"],
                "measured_peak_memory_gb": full["peak_memory_gb"],
                "bound_share_of_measured": max(rec["terms_seconds"].values()) * 1e3
                / full["ms_per_step"]})
    out["train_cut"] = rec
    log(f"dry run, phi3-mini-3.8b train {b} x {s}, remat full, 1 microbatch: "
        f"{dryrun.summary(rec)}; {counted / 1e12:.3f} TFLOP counted against train_flops' "
        f"{flops['total'] / 1e12:.3f} ({gap:+.4f}; {early_stop / 1e12:.3f} TFLOP of recompute "
        f"that checkpointing stops early, less which they differ by {rel:.2e}); the bound "
        f"{max(rec['terms_seconds'].values()) * 1e3:.1f} ms against phase 23(b)'s measured "
        f"{full['ms_per_step']:.1f} ms per step; memory "
        f"{rec['memory']['total_bytes'] / 1e9:.1f} GB counted, {full['peak_memory_gb']:.1f} "
        f"GB measured peak")
    if rel > DRYRUN_FLOPS_RTOL or abs(gap) > DRYRUN_FLOPS_GAP:
        raise AssertionError(f"dry run FLOPs {counted:.6g} against train_flops "
                             f"{flops['total']:.6g}: gap {gap:+.4f}, {rel:.2e} off once "
                             f"the early-stopped recompute is taken off")
    return out


# ---------------------------------------------------------------------------
# Slice 12: the route between processes (phase 28) and int8 gradient
# compression (phase 29)
# ---------------------------------------------------------------------------

ROUTE_SHARDS = (2, 4, 8)    # the cache on the first D ranks of one world of 8
ROUTE_SHORT_BATCHES = 256   # D = 2 and 4: the first batches of phase 5's stream
ROUTE_D8_BATCHES = 512      # D = 8: its first batches (of 4096), to hold the time
# D = 8: a per-peer depth of half the expected load (a slab of 8192 / 8
# queries sends 128 to each owner on average), so rows shed
ROUTE_CAP = BATCH // 8 // 8 // 2
ROUTE_CAP_BATCHES = 4
COMPRESS_RANKS = 4
COMPRESS_LEAVES = ("attn.wq", "mlp.w_down", "ln1.scale")  # phase 29(b): layer 0's
COMPRESS_ROUNDS = 2


def _npy(workdir, name, x=None):
    """Write ``x`` (a tensor) as ``workdir/name.npy``, or read it back
    mapped (read-only) when ``x`` is None."""
    import numpy as np

    path = Path(workdir) / f"{name}.npy"
    if x is None:
        return np.load(path, mmap_mode="r")
    np.save(path, x.cpu().numpy())
    return None


def _host(torch, a):
    """A tensor copy of ``a`` (a read-only mapped array)."""
    import numpy as np

    return torch.from_numpy(np.array(a))


def _sync(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def route_sizes() -> dict:
    """Phase 28's sizes, handed to every rank (a spawned rank imports this
    script afresh)."""
    return {"device": DEVICE, "num_sets": MAIN_SETS, "batch": BATCH,
            "check_batches": CHECK_BATCHES, "cap": ROUTE_CAP,
            "cap_batches": ROUTE_CAP_BATCHES}


def route_rank(workdir, plan, run):
    """One rank of phase 28 (spawned by ``run_on_ranks``, gloo, sharing the
    card): for each (D, batches, check) of ``plan`` in turn, every rank
    makes the cache on the first D ranks (``ProcessCacheMesh(D)``) and the
    ranks inside it run ``route_shard``; a rank outside it takes part in the
    stream runner's gather of the counts (two calls), as
    ``ProcessCacheMesh`` asks; the world then meets before the next D.  ``run`` holds the sizes (``route_sizes``).  Returns
    {D: this rank's record} for the D it took part in."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.sharded import gather_shards
    from repro_torch.launch.mesh import ProcessCacheMesh

    device = run["device"]
    keys = _host(torch, _npy(workdir, "keys")).to(device)
    vals = torch.stack([keys, -keys], dim=1)
    out = {}
    for ndev, n_batches, check in plan:
        mesh = ProcessCacheMesh(ndev, device)
        if mesh.rank >= 0:
            out[ndev] = route_shard(torch, workdir, mesh, keys, vals, n_batches, check, run)
        else:       # the stream runner's one gather per call, of its counts
            for _ in range(2):
                gather_shards(mesh, torch.zeros((1, 2), dtype=torch.int64, device=device))
        dist.barrier()
    return out


def route_shard(torch, workdir, mesh, keys, vals, n_batches, check, run):
    """Rank ``mesh.rank`` of a cache of ``mesh.ndev`` ranks in phase 28: its
    shard of the main table, its slab of every batch.  The one-pass stream
    runner over ``n_batches`` of phase 5's stream from a cold table (the
    first half warm, the second timed); its rows (gathered to group rank 0
    when the group is the world) and the timed half's hits against the
    parent's local-cache results.  With ``check``: the rounds engine on the
    ``check_batches`` batches after them, and the per-peer depth ``cap`` on
    the first ``cap_batches`` batches, against the parent's one-process
    results.  Launches are counted on each path from 0 on this rank."""
    import torch.distributed as dist

    from repro_torch.core import MSLRUConfig, init_table
    from repro_torch.core.sharded import (gather_shards, make_sharded_engine,
                                          make_sharded_stream_runner, sets_per_shard,
                                          shard_table)

    device, batch, ndev, rank = run["device"], run["batch"], mesh.ndev, mesh.rank
    cfg = MSLRUConfig(num_sets=run["num_sets"], m=2, p=4, key_planes=1, value_planes=2)
    s_local = sets_per_shard(cfg.num_sets, ndev)
    rows = slice(rank * s_local, (rank + 1) * s_local)
    q = batch // ndev
    qk = keys[:, None]
    want = _npy(workdir, f"want_{n_batches}")

    def mine(name):
        """This rank's rows of a table the parent wrote."""
        return _host(torch, _npy(workdir, name)[rows]).to(device)

    stream = make_sharded_stream_runner(cfg, mesh, cap="full", batch=batch, engine="onepass")
    table = shard_table(init_table(cfg, device), mesh)
    half = n_batches // 2
    zero_launches()
    _sync(torch, device)
    dist.barrier(group=mesh.group)
    t0 = time.perf_counter()
    table, _, _ = stream(table, qk[: half * batch], vals[: half * batch])
    _sync(torch, device)
    t1 = time.perf_counter()
    stage0, wire0, ex0 = mesh.stage_seconds, mesh.wire_seconds, mesh.exchanges
    table, hits, served = stream(table, qk[half * batch: n_batches * batch],
                                 vals[half * batch: n_batches * batch])
    _sync(torch, device)
    t2 = time.perf_counter()
    exchanges = mesh.exchanges - ex0
    out = {"rank": rank, "batches": n_batches, "warm_seconds": t1 - t0,
           "seconds": t2 - t1, "launches_stream": read_launches(),
           "exchanges_timed": exchanges,
           "stage_ms_per_exchange": 1e3 * (mesh.stage_seconds - stage0) / exchanges,
           "wire_ms_per_exchange": 1e3 * (mesh.wire_seconds - wire0) / exchanges}
    if out["launches_stream"]["msl_onepass"] != n_batches:
        raise AssertionError(f"D = {ndev}, rank {rank}: "
                             f"{out['launches_stream']['msl_onepass']} msl_onepass "
                             f"launches for {n_batches} batches")
    if int(hits) != int(want[0]) or int(served) != (n_batches - half) * batch:
        raise AssertionError(f"D = {ndev}, rank {rank}: timed hits {int(hits)} (served "
                             f"{int(served)}), the local cache's {int(want[0])}")
    if ndev == mesh.world_size:
        whole = gather_shards(mesh, table)
        if rank == 0 and not torch.equal(
                whole, _host(torch, _npy(workdir, f"want_table_{n_batches}")).to(device)):
            raise AssertionError(f"D = {ndev}: the routed table gathered to rank 0 differs")
        del whole
    elif not torch.equal(table, mine(f"want_table_{n_batches}")):
        raise AssertionError(f"D = {ndev}, rank {rank}: its rows differ from the local table")
    if not check:
        return out

    # the rounds engine on the batches after the stream (the access kernel)
    rounds = make_sharded_engine(cfg, mesh, cap="full", engine="rounds")
    w_hit, w_val = _npy(workdir, "check_hit"), _npy(workdir, "check_val")
    zero_launches()
    for j in range(run['check_batches']):
        i = n_batches + j
        sl = slice(i * batch + rank * q, i * batch + (rank + 1) * q)
        table, hit, val, srv = rounds(table, qk[sl], vals[sl])
        mine_q = slice(rank * q, (rank + 1) * q)
        if not (bool(srv.all()) and torch.equal(hit.cpu(), _host(torch, w_hit[j, mine_q]))
                and torch.equal(val[hit].cpu(), _host(torch, w_val[j, mine_q])[hit.cpu()])):
            raise AssertionError(f"rank {rank}: rounds check batch {j} differs")
    out["launches_rounds_check"] = read_launches()
    if out["launches_rounds_check"]["msl_access"] == 0:
        raise AssertionError(f"rank {rank}: the routed rounds engine launched no msl_access")
    if not torch.equal(table, mine("check_table")):
        raise AssertionError(f"rank {rank}: rows differ after the rounds check")

    # a per-peer depth below the expected load: sheds
    bounded = make_sharded_engine(cfg, mesh, cap=run['cap'], engine="onepass")
    table = shard_table(init_table(cfg, device), mesh)
    w_srv, w_hit, w_val = (_npy(workdir, f"cap_{n}") for n in ("served", "hit", "val"))
    shed = 0
    zero_launches()
    for i in range(run['cap_batches']):
        sl = slice(i * batch + rank * q, i * batch + (rank + 1) * q)
        table, hit, val, srv = bounded(table, qk[sl], vals[sl])
        mine_q = slice(rank * q, (rank + 1) * q)
        if not (torch.equal(srv.cpu(), _host(torch, w_srv[i, mine_q]))
                and torch.equal(hit.cpu(), _host(torch, w_hit[i, mine_q]))
                and torch.equal(val.cpu(), _host(torch, w_val[i, mine_q]))):
            raise AssertionError(f"rank {rank}: cap {run['cap']} batch {i} differs")
        shed += int((~srv).sum())
    if not torch.equal(table, mine("cap_table")):
        raise AssertionError(f"rank {rank}: rows differ after the bounded batches")
    out["cap_shed"] = shed
    out["launches_cap"] = read_launches()
    return out


def _local_stream(torch, cfg, keys, vals, n_batches):
    """Phase 5's engine (``MultiStepLRUCache``, one table) over the first
    ``n_batches`` batches from a cold table, the first half warming:
    (table, the second half's hits)."""
    from repro_torch.core import MultiStepLRUCache

    cache = MultiStepLRUCache(cfg, device=DEVICE)
    hits = torch.zeros((), dtype=torch.int64, device=DEVICE)
    for i in range(n_batches):
        q = slice(i * BATCH, (i + 1) * BATCH)
        res = cache.access(keys[q], vals[q])
        if i >= n_batches // 2:
            hits += res.hit.sum()
    return cache.table, int(hits)


def run_route(torch, cfg, host_stream, main):
    """Phase 28: the sharded cache with one shard per process.  One world
    of 8 ranks shares the card through ``run_on_ranks(..., backend="gloo")``
    (the route exchanges through host memory, since NCCL does not put two
    ranks on one card); the cache runs on its first D ranks for each D of
    ROUTE_SHARDS.  The parent writes phase 5's stream and its own results
    to a temporary directory first; every rank checks its part, and any
    rank's failure fails the phase."""
    import tempfile

    from repro_torch.core import MultiStepLRUCache, init_table
    from repro_torch.core.sharded import make_sharded_engine, shard_table
    from repro_torch.launch.mesh import make_cache_mesh, run_on_ranks

    keys_h = host_stream[0]
    world = max(ROUTE_SHARDS)
    plan = [(d, ROUTE_D8_BATCHES if d == world else ROUTE_SHORT_BATCHES, d == world)
            for d in ROUTE_SHARDS]
    out = {"transport": "gloo all_to_all_single through pinned host buffers, D ranks on "
                        "one card (not NCCL)", "cap": ROUTE_CAP, "world": world}
    with tempfile.TemporaryDirectory() as workdir:
        keys = keys_h.to(DEVICE)
        vals = torch.stack([keys, -keys], dim=1)
        _npy(workdir, "keys", keys_h)
        for n in sorted({n for _, n, _ in plan}):
            want_table, hits = _local_stream(torch, cfg, keys, vals, n)
            _npy(workdir, f"want_table_{n}", want_table)
            _npy(workdir, f"want_{n}", torch.tensor([hits]))
            if n == ROUTE_D8_BATCHES:
                local = MultiStepLRUCache(cfg, device=DEVICE)
                local.load_table(want_table)
                got = [local.access(keys[i * BATCH:(i + 1) * BATCH], vals[i * BATCH:(i + 1)
                                                                          * BATCH])
                       for i in range(n, n + CHECK_BATCHES)]
                _npy(workdir, "check_hit", torch.stack([r.hit for r in got]))
                _npy(workdir, "check_val", torch.stack([r.value for r in got]))
                _npy(workdir, "check_table", local.table)
                del local, got
            del want_table
        mesh = make_cache_mesh(world, device=DEVICE)
        bounded = make_sharded_engine(cfg, mesh, cap=ROUTE_CAP, engine="onepass")
        t = shard_table(init_table(cfg, DEVICE), mesh)
        res = []
        for i in range(ROUTE_CAP_BATCHES):
            t, hit, val, srv = bounded(t, keys[i * BATCH:(i + 1) * BATCH, None],
                                       vals[i * BATCH:(i + 1) * BATCH])
            res.append((srv, hit, val))
        for j, name in enumerate(("served", "hit", "val")):
            _npy(workdir, f"cap_{name}", torch.stack([r[j] for r in res]))
        _npy(workdir, "cap_table", t)
        out["cap_shed_one_process"] = int(sum(int((~r[0]).sum()) for r in res))
        del t, res, keys, vals
        release(torch)
        t = time.perf_counter()
        ranks = run_on_ranks(route_rank, world, "gloo", DEVICE,
                             args=(workdir, plan, route_sizes()), timeout=900)
        out["phase_seconds"] = time.perf_counter() - t
    for ndev, n, check in plan:
        mine = [r[ndev] for r in ranks if ndev in r]
        timed = (n - n // 2) * BATCH
        slowest = max(r["seconds"] for r in mine)
        rec = {"ranks": ndev, "batches": n, "timed_queries": timed, "seconds": slowest,
               "qps": timed / slowest, "ms_per_batch": 1e3 * slowest / (n - n // 2),
               "stage_ms_per_exchange": sum(r["stage_ms_per_exchange"] for r in mine) / ndev,
               "wire_ms_per_exchange": sum(r["wire_ms_per_exchange"] for r in mine) / ndev,
               "exchanges_per_batch": mine[0]["exchanges_timed"] / (n - n // 2),
               "msl_onepass_per_rank": [r["launches_stream"]["msl_onepass"] for r in mine]}
        if len(mine) != ndev:
            raise AssertionError(f"D = {ndev}: {len(mine)} ranks reported")
        if check:
            rec["msl_access_per_rank"] = [r["launches_rounds_check"]["msl_access"]
                                          for r in mine]
            rec["cap_shed"] = sum(r["cap_shed"] for r in mine)
            if rec["cap_shed"] != out["cap_shed_one_process"] or rec["cap_shed"] == 0:
                raise AssertionError(f"cap {ROUTE_CAP}: {rec['cap_shed']} rows shed, the "
                                     f"one-process engine {out['cap_shed_one_process']}")
        out[f"d{ndev}"] = rec
        log(f"D = {ndev} of {world} ranks on one card (gloo through host memory, not NCCL): "
            f"{n} batches, table and hits == phase 5's engine's on them; "
            f"{rec['qps']:.4g} queries/s, {rec['ms_per_batch']:.3f} ms per batch (phase 5: "
            f"{main['qps']:.4g}), {rec['exchanges_per_batch']:.0f} exchanges per batch per "
            f"rank at {rec['stage_ms_per_exchange']:.4f} ms host staging + "
            f"{rec['wire_ms_per_exchange']:.4f} ms gloo; msl_onepass launches per rank "
            f"{rec['msl_onepass_per_rank']} (one per batch)")
    d = out[f"d{world}"]
    log(f"D = {world}: rounds engine on {CHECK_BATCHES} batches after its stream == the local "
        f"cache (msl_access per rank {d['msl_access_per_rank']}); cap {ROUTE_CAP}: "
        f"{d['cap_shed']} of {ROUTE_CAP_BATCHES * BATCH} rows shed on "
        f"{ROUTE_CAP_BATCHES} cold batches, served masks, hits, values and tables == the "
        f"one-process engine's; {out['phase_seconds']:.1f} s for the world")
    return out


def compress_card_rank(workdir, rounds, leaves, device):
    """One rank of phase 29(b): its gradient tree (``g<rank>_<leaf>.npy``)
    through ``compress_tree`` on the card ``rounds`` times, carrying the
    residual; each round's reduced tree and the last residuals against the
    parent's CPU formula, bit for bit."""
    import torch
    import torch.distributed as dist

    from repro_torch.train.compression import compress_tree, zeros_residuals

    rank = dist.get_rank()
    g = {k: _host(torch, _npy(workdir, f"g{rank}_{k}")).to(device) for k in leaves}
    res = zeros_residuals(g)
    ms = []
    for r in range(rounds):
        _sync(torch, device)
        t = time.perf_counter()
        out, res = compress_tree(g, None, res)
        _sync(torch, device)
        ms.append(1e3 * (time.perf_counter() - t))
        for k in leaves:
            if not torch.equal(out[k].cpu(), _host(torch, _npy(workdir, f"out{r}_{k}"))):
                raise AssertionError(f"rank {rank}: round {r} {k} differs from the CPU")
    for k in leaves:
        if not torch.equal(res[k].cpu(), _host(torch, _npy(workdir, f"res{rank}_{k}"))):
            raise AssertionError(f"rank {rank}: residual {k} differs from the CPU")
    return {"rank": rank, "ms_per_round": ms}


def run_compression(torch):
    """Phase 29.  (a) ``quantize_int8``/``dequantize_int8`` on the card
    against the CPU, bit for bit, on seeded gradients shaped like every
    leaf of phi3-mini-3.8b cut to CUT_LAYERS of its 32 layers (phase 23(a)'s
    cut).
    (b) ``compress_tree`` over COMPRESS_RANKS gloo ranks on the card,
    COMPRESS_ROUNDS rounds carrying the residuals, against the formula on
    the CPU (every rank's int8 values summed as int32 times the largest
    scale; the residuals), bit for bit; the wire bytes of the int32 sum."""
    import dataclasses
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.configs.specs import abstract_params
    from repro_torch.launch.mesh import run_on_ranks
    from repro_torch.models.model import make_model
    from repro_torch.train.compression import _residual, dequantize_int8, quantize_int8

    cut = dataclasses.replace(get_config(PHI3), n_layers=CUT_LAYERS)
    leaves = dict(abstract_params(make_model(cut)).named_parameters())
    gen = torch.Generator().manual_seed(SEED)
    n = 0
    t = time.perf_counter()
    for i, (name, p) in enumerate(leaves.items()):
        g = torch.randn(p.shape, generator=gen) * 10.0 ** -(i % 4)
        q, s = quantize_int8(g)
        qd, sd = quantize_int8(g.to(DEVICE))
        if not (torch.equal(qd.cpu(), q) and sd.cpu().view(torch.int32) == s.view(torch.int32)
                and torch.equal(dequantize_int8(qd, sd).cpu(), dequantize_int8(q, s))):
            raise AssertionError(f"quantize_int8 on the card differs from the CPU: {name}")
        n += g.numel()
    del g, q, qd
    out = {"quantize": {"leaves": len(leaves), "elements": n, "equal": True,
                        "seconds": time.perf_counter() - t}}
    log(f"quantize_int8 / dequantize_int8: {len(leaves)} seeded gradient leaves of "
        f"phi3-mini-3.8b at {CUT_LAYERS} layer(s) ({n:,} elements) bit-equal on the card and "
        f"the CPU")

    full = {k: v for k, v in leaves.items() if k.startswith("blocks.0.")}
    shapes = {k: tuple(full[f"blocks.0.{k}"].shape) for k in COMPRESS_LEAVES}
    with tempfile.TemporaryDirectory() as workdir:
        grads = []
        for r in range(COMPRESS_RANKS):
            gen = torch.Generator().manual_seed(SEED + 1 + r)
            grads.append({k: torch.randn(sh, generator=gen) * 1e-2 for k, sh in shapes.items()})
            for k, g in grads[r].items():
                _npy(workdir, f"g{r}_{k}", g)
        res = [{k: torch.zeros(sh) for k, sh in shapes.items()} for _ in range(COMPRESS_RANKS)]
        for rnd in range(COMPRESS_ROUNDS):
            for k in shapes:
                qs = []
                for r in range(COMPRESS_RANKS):
                    gc = grads[r][k] + res[r][k]
                    q, s = quantize_int8(gc)
                    res[r][k] = _residual(gc, q, s)
                    qs.append((q, s))
                total = torch.stack([q.to(torch.int32) for q, _ in qs]).sum(0)
                smax = torch.stack([s for _, s in qs]).max()
                _npy(workdir, f"out{rnd}_{k}", total.float() * smax)
        for r in range(COMPRESS_RANKS):
            for k in shapes:
                _npy(workdir, f"res{r}_{k}", res[r][k])
        del grads, res
        t = time.perf_counter()
        ranks = run_on_ranks(compress_card_rank, COMPRESS_RANKS, "gloo", DEVICE,
                             args=(workdir, COMPRESS_ROUNDS, COMPRESS_LEAVES, DEVICE),
                             timeout=600)
        wall = time.perf_counter() - t
    elements = sum(math.prod(sh) for sh in shapes.values())
    out["compress_tree"] = {
        "ranks": COMPRESS_RANKS, "rounds": COMPRESS_ROUNDS,
        "leaves": {k: list(sh) for k, sh in shapes.items()}, "elements": elements,
        "wire_bytes_per_rank": 4 * elements + 4 * len(shapes),
        "f32_all_reduce_bytes": 4 * elements, "int8_bytes": elements,
        "ms_per_round": [r["ms_per_round"] for r in ranks], "phase_seconds": wall,
        "transport": "gloo all_reduce through host memory, 4 ranks on one card"}
    c = out["compress_tree"]
    log(f"compress_tree over {COMPRESS_RANKS} gloo ranks on the card, {COMPRESS_ROUNDS} rounds "
        f"of {elements:,} elements ({', '.join(COMPRESS_LEAVES)} of layer 0): reduced trees "
        f"and residuals bit-equal to the CPU formula; the int32 sum puts "
        f"{c['wire_bytes_per_rank']:,} bytes per rank into the all-reduce (an f32 one "
        f"{c['f32_all_reduce_bytes']:,}; the int8 values {c['int8_bytes']:,}); ms per round "
        f"per rank {[[round(x, 1) for x in r] for r in c['ms_per_round']]}")
    return out


# ---------------------------------------------------------------------------
# Slice 13: the sharded step (phase 30)
# ---------------------------------------------------------------------------

MESH_STEPS = 3                  # 30(a): phase 23(b)'s run on a (1, 1) mesh
# 30(b): phase 23(a)'s depth cut (CUT_LAYERS) ...
CUT_SEQ, CUT_ROWS = 256, 4      # ... at 256 tokens x 4 rows (a data axis of 2)
CUT_PROMPT, CUT_DECODE = 128, 3
# (data, model) meshes by the size of the world of gloo ranks that runs them:
# one world, a mesh smaller than it replicated over a "replica" axis (no
# rule names it, so every tensor is whole over it)
RANK_MESHES = {4: ((2, 1), (1, 2), (2, 2))}


def _bf16_ulps(torch, want, got) -> float:
    """max |want - got| in bf16 ulps of max |want| (0 for an all-zero leaf
    equal to it)."""
    m = float(want.abs().max())
    d = float((want.float() - got.float()).abs().max())
    return d / 2.0 ** (math.floor(math.log2(m)) - 7) if m > 0 else (0.0 if d == 0 else math.inf)


def _cut_config():
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(PHI3), n_layers=CUT_LAYERS)


def _cut_batches(workdir, cfg):
    """30(b)'s seeded train batch and prompts, as files for the ranks."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    t = rng.integers(0, cfg.vocab_size, (CUT_ROWS, CUT_SEQ + 1)).astype(np.int32)
    prompts = rng.integers(0, cfg.vocab_size, (CUT_ROWS, CUT_PROMPT)).astype(np.int32)
    for name, x in (("tokens", t[:, :-1]), ("labels", t[:, 1:]), ("prompts", prompts)):
        np.save(Path(workdir) / f"{name}.npy", x)


def _cut_inputs(workdir, device):
    import numpy as np
    import torch

    def load(name):
        return torch.from_numpy(np.load(Path(workdir) / f"{name}.npy")).to(device)

    return {"tokens": load("tokens"), "labels": load("labels")}, load("prompts")


def redo_update(torch, opt_mod, start, grads, norm, params, opt) -> dict:
    """The one-device AdamW update (the plain path) of this rank's shard of
    every leaf, from the shard it ``start``-ed with, its gradient shard and
    the step's global norm, with ``build_train_step``'s schedule: the
    elements of the step's parameters, master, m and v it does not give bit
    for bit, by kind (all 0 when the mesh step updated every shard once, in
    the right direction, and copied the master back)."""
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.layers import local

    kw = build_train_step.__kwdefaults__
    norm_t = torch.tensor(norm, dtype=torch.float32, device=DEVICE)
    global_norm, opt_mod.global_norm = opt_mod.global_norm, lambda tree: norm_t
    try:
        _, st, _ = opt_mod.adamw_update(
            {n: local(g) for n, g in grads.items()}, opt_mod.adamw_init(start), start,
            lr_fn=opt_mod.cosine_schedule(kw["lr"], kw["warmup"], kw["total_steps"]))
    finally:
        opt_mod.global_norm = global_norm

    def bits(t):
        return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)

    got = {"params": {n: local(p).detach() for n, p in params.named_parameters()},
           **{k: {n: local(x) for n, x in getattr(opt, k).items()} for k in ("master", "m", "v")}}
    want = {"params": start, "master": st.master, "m": st.m, "v": st.v}
    return {k: sum(int((bits(want[k][n]) != bits(t)).sum()) for n, t in got[k].items())
            for k in got}


def cut_steps(torch, workdir, mesh=None, ref=None, staged=None):
    """30(b)'s steps of phi3-mini at full width, CUT_LAYERS, on ``mesh`` (None:
    one device): one train step from the seeded weights (the collectives it
    issues read from ``staged``, the ``HostStagedCollectives`` they go
    through), then one more timed; the prefill of the prompts from the
    seeded weights and CUT_DECODE serve steps on its cache, fed ``ref``'s
    tokens (None: the greedy ones).  With ``ref`` (the one-device record's
    ``state`` file), the updated parameters and the f32 gradients that
    reached AdamW are held against it here (their largest gap in bf16 ulps,
    on rank 0), and every rank redoes the step's update of its shards
    (``update_mismatches``)."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.steps import (build_prefill_step, build_serve_step,
                                          build_train_step, place_params)
    from repro_torch.models.layers import local
    from repro_torch.models.model import make_model
    from repro_torch.train import optimizer as opt_mod

    cfg = _cut_config()
    model = make_model(cfg)

    def fresh():
        p = model.init(torch.Generator(device=DEVICE).manual_seed(SEED))
        return p if mesh is None else place_params(cfg, mesh, p)

    def rows(x):
        return x if mesh is None else shd.local_batch(mesh, {"x": x}, CUT_ROWS)["x"]

    def full(x):
        x = x.detach()
        return x.full_tensor() if hasattr(x, "full_tensor") else x

    batch, prompts = _cut_inputs(workdir, DEVICE)
    batch = {k: rows(v) for k, v in batch.items()}
    bundle = build_train_step(model, ShapeSpec("cut", CUT_SEQ, CUT_ROWS, "train"), mesh=mesh)
    params = fresh()
    opt = opt_mod.adamw_init(params)
    start = {n: local(p).detach().clone() for n, p in params.named_parameters()}
    update, seen = opt_mod.adamw_update, []

    def recording(grads, *args, **kw):      # the gradients that reach AdamW
        seen.append(dict(opt_mod.leaves(grads)))
        return update(grads, *args, **kw)

    opt_mod.adamw_update = recording
    try:
        params, opt, metrics = bundle.fn(params, opt, batch)
    finally:
        opt_mod.adamw_update = update
    rec = {"metrics": {k: float(v) for k, v in metrics.items()}}
    if staged is not None:
        rec["collective_calls"], rec["collective_bytes"] = dict(staged.calls), dict(staged.bytes)
    if mesh is not None:
        rec["update_mismatches"] = redo_update(torch, opt_mod, start, seen[0],
                                               rec["metrics"]["grad_norm"], params, opt)
    del start
    if ref is not None or mesh is None:
        state = {"params": {n: full(p) for n, p in params.named_parameters()},
                 "grads": {n: full(g).float() for n, g in seen[0].items()}}
        if ref is None:
            torch.save({k: {n: t.cpu() for n, t in v.items()} for k, v in state.items()},
                       Path(workdir) / "state.pt")
        elif mesh.get_rank() == 0:
            want = torch.load(ref, map_location=DEVICE)
            rec["ulps"] = {k: max(_bf16_ulps(torch, want[k][n], t) for n, t in v.items())
                           for k, v in state.items()}
        del state
    del seen
    _sync(torch, DEVICE)
    t = time.perf_counter()
    params, opt, metrics = bundle.fn(params, opt, batch)
    float(metrics["loss"])
    rec["ms_per_step"] = (time.perf_counter() - t) * 1e3
    del params, opt

    params = fresh()
    with torch.no_grad():
        logits, pcache = build_prefill_step(
            model, ShapeSpec("p", CUT_PROMPT, CUT_ROWS, "prefill"), mesh=mesh).fn(
                params, {"tokens": rows(prompts)})
        rec["prefill"] = full(logits).float().cpu().numpy()
        cache = model.init_cache(CUT_ROWS, CUT_PROMPT + CUT_DECODE, device=DEVICE)
        for k in cache:
            cache[k][:, :, :CUT_PROMPT] = full(pcache[k])
        del pcache
        if mesh is not None:
            cache = shd.distribute_tree(mesh, cache,
                                        shd.cache_shardings(cfg, mesh, cache, CUT_ROWS))
        serve = build_serve_step(model, ShapeSpec("d", CUT_PROMPT + CUT_DECODE, CUT_ROWS,
                                                  "decode"), mesh=mesh)
        import numpy as np

        tok = np.argmax(rec["prefill"], -1).astype(np.int32)
        rec["fed"], rec["logits"] = [], []
        for i in range(CUT_DECODE):
            if ref is not None:
                tok = np.load(Path(workdir) / f"fed{i}.npy")
            rec["fed"].append(tok)
            lg, cache = serve.fn(params, rows(torch.from_numpy(tok[:, None]).to(DEVICE)), cache,
                                 CUT_PROMPT + i)
            rec["logits"].append(full(lg).float().cpu().numpy())
            tok = np.argmax(rec["logits"][-1], -1).astype(np.int32)
    return rec


def mesh_step_rank(workdir, shapes):
    """One rank of phase 30(b): ``cut_steps`` on each (data, model) mesh
    (one smaller than the world replicated over a "replica" axis),
    DTensor's collectives through host memory (``HostStagedCollectives``:
    they crash over gloo on CUDA tensors otherwise), which counts them."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import HostStagedCollectives, make_debug_mesh

    out = {}
    for shape in shapes:
        replicas = dist.get_world_size() // math.prod(shape)
        mesh = (make_debug_mesh(shape, device_type="cuda") if replicas == 1 else
                make_debug_mesh((replicas, *shape), ("replica", "data", "model"),
                                device_type="cuda"))
        with HostStagedCollectives() as staged:
            out[shape] = cut_steps(torch, workdir, mesh, Path(workdir) / "state.pt", staged)
        out[shape]["staged_seconds"] = staged.seconds
        release(torch)
    return out


def run_mesh_training(torch, phase23):
    """Phase 30(a): phase 23(b)'s run (phi3-mini-3.8b at full width and depth,
    remat full, 1024 x 2) for MESH_STEPS steps on one device, then on a
    (1, 1) ``DeviceMesh`` in a process group of one NCCL rank (this
    process): the losses within LOSS_RTOL of the one-device run's (and of
    phase 23(b)'s first steps), every updated parameter within GRAD_ULPS
    bf16 ulps; ms per step and peak memory beside phase 23(b)'s."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.launch.mesh import _free_port, make_debug_mesh

    cfg = dataclasses.replace(get_config(PHI3), remat="full")
    b, s = 2, 1024
    args = train_args("--arch", PHI3, "--seq-len", str(s), "--global-batch", str(b),
                      "--microbatches", "1", "--steps", str(FULL_STEPS))
    tr, data = train.build(args, cfg)
    tr.init_state(resume=False)
    want_hist = tr.run(data, MESH_STEPS, log_every=1)
    want_losses = [h["loss"] for h in want_hist]
    want_ms = sorted(h["sec_per_step"] * 1e3 for h in want_hist[1:])
    want = {n: p.detach().cpu() for n, p in tr.params.named_parameters()}
    del tr
    release(torch)

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_debug_mesh((1, 1), device_type="cuda")
        tr, data = train.build(args, cfg, mesh=mesh)
        torch.cuda.reset_peak_memory_stats()
        tr.init_state(resume=False)
        hist = tr.run(data, MESH_STEPS, log_every=1)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        ulps = max(_bf16_ulps(torch, want[n].to(DEVICE), p.detach().to_local())
                   for n, p in tr.params.named_parameters())
        del tr
        release(torch)
    finally:
        dist.destroy_process_group()
    losses = [h["loss"] for h in hist]
    ms = sorted(h["sec_per_step"] * 1e3 for h in hist[1:])
    rel = max(abs(x - y) / abs(y) for x, y in zip(losses, want_losses))
    rel23 = max((abs(x - y) / abs(y) for x, y in zip(losses, phase23["full"]["losses"])),
                default=0.0)
    out = {"mesh": [1, 1], "backend": "nccl", "steps": MESH_STEPS, "losses": losses,
           "losses_one_device": want_losses, "loss_rel": rel, "loss_rel_phase23": rel23,
           "param_ulps": ulps, "ms_per_step": ms[len(ms) // 2], "ms_per_step_all": ms,
           "one_device_ms_per_step": want_ms[len(want_ms) // 2],
           "one_device_ms_per_step_all": want_ms,
           "peak_memory_gb": peak_gb, "phase23_ms_per_step": phase23["full"]["ms_per_step"],
           "phase23_peak_memory_gb": phase23["full"]["peak_memory_gb"]}
    log(f"phi3-mini-3.8b at full width and depth on a (1, 1) DeviceMesh (one NCCL rank), "
        f"{b} x {s}, remat full, {MESH_STEPS} steps: losses {[round(x, 5) for x in losses]} "
        f"against one device's {[round(x, 5) for x in want_losses]} (gap {rel:.2e}; phase "
        f"23(b)'s {rel23:.2e}), parameters within {ulps:.2f} bf16 ulps; "
        f"{out['ms_per_step']:.1f} ms per step (one device in this phase: "
        f"{out['one_device_ms_per_step']:.1f}; phase 23(b): "
        f"{out['phase23_ms_per_step']:.1f}), peak memory {peak_gb:.1f} GB (phase 23(b): "
        f"{out['phase23_peak_memory_gb']:.1f})")
    if rel > LOSS_RTOL or rel23 > LOSS_RTOL or ulps > GRAD_ULPS:
        raise AssertionError(f"the (1, 1) mesh's run differs from one device's: loss gap "
                             f"{rel:.2e} ({rel23:.2e} from phase 23(b)), {ulps:.2f} ulps")
    return out


def _logits_close(want, got, what) -> int:
    """``got`` logits (rows, V) within LOGIT_ULPS bf16 ulps of each row's
    largest |logit| of ``want`` (phase 9's bound for two full-width paths:
    the logits are bf16 products, an ulp of 0.03-0.06 at this width), and
    their argmax equal but where ``want`` puts the two tokens within that
    bound (a tie): returns the rows split at a tie."""
    import numpy as np

    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max(-1))) - 7)
    diff = np.abs(got - want).max(-1)
    if np.any(diff > LOGIT_ULPS * ulp):
        raise AssertionError(f"{what}: logits off by {float((diff / ulp).max()):.2f} bf16 "
                             f"ulps of the row's largest |logit| (allowed {LOGIT_ULPS})")
    w, g = np.argmax(want, -1), np.argmax(got, -1)
    rows = np.flatnonzero(w != g)
    gaps = np.abs(want[rows, w[rows]] - want[rows, g[rows]])
    if np.any(gaps > LOGIT_ULPS * ulp[rows]):
        raise AssertionError(f"{what}: greedy tokens split beyond a tie: {gaps}")
    return len(rows)


def run_rank_meshes(torch):
    """Phase 30(b): phi3-mini at full width, CUT_LAYERS of 32, 256 x 4: the
    one-device steps on the card (``cut_steps``), then one world of 4 gloo
    ranks sharing the card on meshes (2, 1) and (1, 2) (each replicated
    twice, ``mesh_step_rank``) and (2, 2): each
    mesh's train step (metrics within LOSS_RTOL / NORM_RTOL, parameters and
    the gradients that reached AdamW within GRAD_ULPS bf16 ulps: the CPU
    tests' bounds; every rank's parameters, master, m and v those of the
    one-device update of its shards, bit for bit), prefill and serve
    logits (``_logits_close``) and greedy tokens (equal, or a tie) against
    one device; per-rank ms per step and the collectives by kind."""
    import tempfile

    import numpy as np

    from repro_torch.launch.mesh import run_on_ranks

    out = {}
    with tempfile.TemporaryDirectory() as workdir:
        _cut_batches(workdir, _cut_config())
        ref = cut_steps(torch, workdir)
        release(torch)
        for i, tok in enumerate(ref["fed"]):
            np.save(Path(workdir) / f"fed{i}.npy", tok)
        out["one_device"] = {"metrics": ref["metrics"], "ms_per_step": ref["ms_per_step"]}
        log(f"30(b) one device: loss {ref['metrics']['loss']:.6f}, grad norm "
            f"{ref['metrics']['grad_norm']:.6f}, {ref['ms_per_step']:.1f} ms per step")
        for world, shapes in RANK_MESHES.items():
            t = time.perf_counter()
            ranks = run_on_ranks(mesh_step_rank, world, "gloo", DEVICE,
                                 args=(workdir, shapes), timeout=600)
            wall = time.perf_counter() - t
            for shape in shapes:
                recs = [r[shape] for r in ranks]
                got = recs[0]
                what = (f"phi3-mini-3.8b, {CUT_LAYERS} layer(s), mesh {shape} in a world of "
                        f"{world} gloo ranks")
                for k, v in got["metrics"].items():
                    rtol = NORM_RTOL if k == "grad_norm" else LOSS_RTOL
                    if abs(v - ref["metrics"][k]) > rtol * abs(ref["metrics"][k]):
                        raise AssertionError(f"{what}: {k} {v} against {ref['metrics'][k]}")
                if any(u > GRAD_ULPS for u in got["ulps"].values()):
                    raise AssertionError(f"{what}: {got['ulps']} bf16 ulps")
                if any(any(x["update_mismatches"].values()) for x in recs):
                    raise AssertionError(f"{what}: the update is not the one-device update of "
                                         f"the same gradients: "
                                         f"{[x['update_mismatches'] for x in recs]}")
                gap = max(float((np.abs(g - w).max(-1) / 2.0 ** (
                    np.floor(np.log2(np.abs(w).max(-1))) - 7)).max())
                    for w, g in zip([ref["prefill"], *ref["logits"]],
                                    [got["prefill"], *got["logits"]]))
                split = sum(_logits_close(w, g, f"{what}, step {i}") for i, (w, g) in
                            enumerate(zip([ref["prefill"], *ref["logits"]],
                                          [got["prefill"], *got["logits"]])))
                out[f"{shape[0]}x{shape[1]}"] = r = {
                    "ranks": world, "metrics": got["metrics"], "ulps": got["ulps"],
                    "update_mismatches_per_rank": [x["update_mismatches"] for x in recs],
                    "logits_max_gap_ulps": gap,
                    "greedy_split_at_ties_of": [split, (CUT_DECODE + 1) * CUT_ROWS],
                    "ms_per_step_per_rank": [x["ms_per_step"] for x in recs],
                    "collective_calls": got["collective_calls"],
                    "collective_bytes": got["collective_bytes"],
                    "staged_seconds_per_rank": [x["staged_seconds"] for x in recs],
                    "group_wall_s": wall}
                log(f"{what}: loss {got['metrics']['loss']:.6f} (one device "
                    f"{ref['metrics']['loss']:.6f}), parameters within "
                    f"{got['ulps']['params']:.2f} and gradients within "
                    f"{got['ulps']['grads']:.2f} bf16 ulps, every rank's update the one-device "
                    f"update of its shards bit for bit, prefill and serve logits within "
                    f"{gap:.2f} bf16 ulps of the row's largest, greedy tokens {split} of "
                    f"{(CUT_DECODE + 1) * CUT_ROWS} split at "
                    f"ties; ms per step per "
                    f"rank {[round(x, 1) for x in r['ms_per_step_per_rank']]}; collectives per "
                    f"rank in the first train step: " + ", ".join(
                        f"{k} {got['collective_calls'][k]} ({got['collective_bytes'][k]:,} B)"
                        for k in got["collective_bytes"] if got["collective_calls"][k])
                    + f"; {got['staged_seconds']:.2f} s in host-staged collectives over the "
                    f"whole phase on rank 0")
    return out


# 30(c): (arch, shapes) traced on both production meshes.  Beside
# phi3-mini's cells, one cell of each fault the grid found: xLSTM's decode
# (4 heads over a 'model' axis of 16: rows_local), olmoe's prefill (torch
# 2.11 has no DTensor rule for the MoE dispatch's index_put_) and hymba's
# prefill (2.11's DTensor cannot plan the causal conv's pad: pad_local).
# command-r-35b's pod2 train_4k (16 microbatches of 16 rows, 8 rows a rank)
# traces for 2 min on the host, longer than 30(b): the grid run
# (dryrun_grid.sh) and tests/test_torch_dryrun.py carry it
MESH_DRYRUN = ((PHI3, None), ("xlstm-1.3b", ("decode_32k",)),
               ("olmoe-1b-7b", ("prefill_32k",)), ("hymba-1.5b", ("prefill_32k",)))


def start_mesh_dryrun(workdir):
    """Phase 30(c), started first: ``launch/dryrun.py --mesh`` for each of
    MESH_DRYRUN's cells on pod1 and pod2, one process per (arch, mesh) on
    the host (meta tensors, a process group that moves nothing), while 30(a)
    and 30(b) run."""
    env = {**__import__("os").environ, "PYTHONPATH": str(ROOT / "src")}
    procs = []
    for arch, shapes in MESH_DRYRUN:
        for mesh in ("pod1", "pod2"):
            out = open(Path(workdir) / f"{arch}_{mesh}.log", "w")
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--mesh",
                   mesh, "--out", str(workdir), "--force"]
            for shape in shapes or ():
                cmd += ["--shape", shape]
            procs.append(((arch, mesh), subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=out,
                                                         stderr=subprocess.STDOUT)))
            out.close()
    return procs


def finish_mesh_dryrun(procs, workdir):
    """Phase 30(c): the records of ``start_mesh_dryrun``'s runs, each
    checked to count activations, collectives and terms."""
    from repro_torch.configs import SHAPES
    from repro_torch.launch import dryrun

    for (arch, mesh), p in procs:
        if p.wait(timeout=900) != 0:
            text = (Path(workdir) / f"{arch}_{mesh}.log").read_text()
            raise AssertionError(f"the mesh dry run failed:\n{text[-4000:]}")
    out = {}
    for arch, shapes in MESH_DRYRUN:
        for mesh, shape in ((m, sh) for m in ("pod1", "pod2") for sh in shapes or SHAPES):
            rec = json.loads((Path(workdir) / f"{dryrun.cell_id(arch, shape, mesh)}.json")
                             .read_text())
            out[rec["cell"]] = rec
            log(f"dry run {rec['cell']}: " + ("skipped" if rec["skipped"]
                                              else dryrun.summary(rec)
                                              + f" ({rec['trace_s']:.1f} s)"))
            if rec["skipped"]:
                continue
            dev = rec["per_device"]
            if not (dev["activation_bytes"] and dev["flops"] and dev["collective_bytes"]
                    and rec["terms_seconds"] and rec["dominant"]
                    and rec["roofline_fraction"] is not None):
                raise AssertionError(f"{rec['cell']}: a field is not counted")
    return out


# ---------------------------------------------------------------------------
# Faults across processes (phase 31): reshard and mark_degraded with one
# cache shard per gloo rank on the card, and phase 21's bounded serve with
# its cache on those ranks
# ---------------------------------------------------------------------------

FAULT_WORLD = 8                 # 31(b) uses SHARDS ranks of this world: the same 8
# 31(a) at test scale: tests/test_reshard.py's workload, (D, D', engine,
# seed), every pair starting on the first D ranks of one world of
# FAULT_WORLD; one of the workload's seeds 0-2 per pair, to keep the
# script's time (a cache call over 8 gloo ranks sharing one H100 takes
# about 45 ms, PERF.md), every seed on every pair in the CPU tests
FAULT_PAIRS = ((8, 4, "onepass", 0), (4, 8, "onepass", 1), (8, 7, "onepass", 2),
               (2, 1, "onepass", 0), (8, 7, "rounds", 1))
# 31(a) at the real size: 2^11 sets x M=2 x P=4 = 16384 entries, about as
# many as one card holds 16-token KV pages of phi3-mini-3.8b (6.3 MB a page,
# about 11.5k pages after the weights); chains of 1-5 chunks picked Zipf 0.99
# from REAL_CHAINS, REAL_PER_CALL chains to a cache call
REAL_SETS = 2**11
REAL_CHAINS = 100_000
REAL_CALLS = 96
REAL_PER_CALL = 128


def fault_sizes() -> dict:
    """Phase 31(a)'s sizes, handed to every rank (a spawned rank imports
    this script afresh)."""
    return {"device": DEVICE, "pairs": FAULT_PAIRS, "real_sets": REAL_SETS,
            "real_chains": REAL_CHAINS, "real_calls": REAL_CALLS,
            "real_per_call": REAL_PER_CALL}


def real_calls(n_chains, n_calls, per_call, seed=SEED):
    """Cache calls at the real size: ``n_chains`` chains of 1-5 odd 31-bit
    chunk hashes, each call ``per_call`` of them picked Zipf 0.99, laid out
    as the prefix cache lays out a tick (a CHAIN_GET island, then a
    CHAIN_PUT island staging a fresh page per chunk).  Yields (keys, vals,
    ops, chain_ids, chains)."""
    import numpy as np

    sys.path.insert(0, str(ROOT / "tests"))
    import torch_sharded_cases as cases

    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 6, n_chains)
    hashes = (rng.integers(1, 2**31 - 1, int(lens.sum())) | 1).tolist()
    ends = np.cumsum(lens)
    chains = [hashes[e - n:e] for n, e in zip(lens.tolist(), ends.tolist())]
    p = 1.0 / np.arange(1, n_chains + 1) ** ZIPF_ALPHA
    picks = rng.choice(n_chains, (n_calls, per_call), p=p / p.sum())
    page = 1
    for row in picks:
        tick = [chains[i] for i in row]
        staged = []
        for c in tick:
            staged.append(list(range(page, page + len(c))))
            page += len(c)
        yield (*cases.chain_batch(tick, staged), tick)


def _digest(x) -> str:
    import hashlib
    import pickle

    return hashlib.sha256(pickle.dumps(x, protocol=4)).hexdigest()


def _rebuilt_right(torch, client, cfg, table, device, resident=False) -> bool:
    """The rebuilt ``table`` equals a cold ``MultiStepLRUCache`` on the card
    fed ``client.last_drain_stream``; with ``resident``, every re-inserted
    chain is resident too (one LOOKUP call through ``client`` over every
    re-inserted key).  Its launches are the check's: the caller reads the
    path's counts before it and zeroes them after it."""
    import numpy as np

    from repro_torch.core import OP_LOOKUP, MultiStepLRUCache

    cold = MultiStepLRUCache(cfg, engine="onepass", device=device)
    for b in client.last_drain_stream:
        cold.access(b["keys"], b["vals"], ops=b["ops"], chain_ids=b["chain_ids"])
    if not np.array_equal(cold.table.cpu().numpy(), table):
        return False
    if not resident or not client.last_drain_stream:
        return True
    keys = np.concatenate([b["keys"] for b in client.last_drain_stream])
    return bool(client.access(keys, ops=np.full(keys.size, OP_LOOKUP, np.int32)).hit.all())


def _timed_sweeps(torch, client, ms):
    """Record the ms of each of ``client``'s drain (CHAIN_GET) and
    re-insert (CHAIN_PUT) sweeps into ``ms["drain"]``/``ms["reinsert"]``."""
    from repro_torch.core import OP_CHAIN_GET

    inner = client._sweep_access

    def sweep(keys, vals, ops, chain_ids, costs=None):
        _sync(torch, client.device)
        t = time.perf_counter()
        try:
            return inner(keys, vals, ops, chain_ids, costs=costs)
        finally:
            _sync(torch, client.device)
            ms["drain" if int(ops[0]) == OP_CHAIN_GET else "reinsert"].append(
                1e3 * (time.perf_counter() - t))

    client._sweep_access = sweep


def _real_size(torch, mesh, run):
    """The real-size run on ``mesh`` (a process or one-process cache mesh of
    8 shards): the Zipf calls, then D = 8 -> 7, ``mark_degraded(3)``, 7 -> 8.
    Returns the record of each step (orphans, drain stream, table, client
    state), the checks, the launches of the path on this rank (the calls,
    the reshards and ``mark_degraded``; not the checks' own), and the
    times."""
    import numpy as np

    from repro_torch.core import MSLRUConfig
    from repro_torch.core.sharded import ShardedCacheClient

    sys.path.insert(0, str(ROOT / "tests"))
    import torch_sharded_cases as cases

    device = mesh.device
    cfg = MSLRUConfig(num_sets=run["real_sets"], m=2, p=4, value_planes=1)
    cl = ShardedCacheClient(cfg, mesh)
    ms = {"drain": [], "reinsert": [], "access": [], "reshard": [], "degrade": []}
    _timed_sweeps(torch, cl, ms)
    launches = {k: 0 for k in read_launches()}

    def path_launches():
        """Add the launches since the last zero to the path's."""
        for k, v in read_launches().items():
            launches[k] += v

    zero_launches()
    for keys, vals, ops, cids, tick in real_calls(run["real_chains"], run["real_calls"],
                                                  run["real_per_call"]):
        t = time.perf_counter()
        cl.access(keys, vals, ops=ops, chain_ids=cids)
        ms["access"].append(1e3 * (time.perf_counter() - t))
        for c in tick:
            cl.note_chain(c)
    path_launches()
    out = {"occupancy_before": cl.occupancy, "chains": len(cl._chain_registry),
           "steps": [], "checks": [], "mesh_ranks": []}
    for what, arg in (("reshard", 7), ("degrade", 3), ("reshard", 8)):
        zero_launches()
        _sync(torch, device)
        t = time.perf_counter()
        orphans = cl.reshard(arg) if what == "reshard" else cl.mark_degraded(arg)
        _sync(torch, device)
        ms[what].append(1e3 * (time.perf_counter() - t))
        path_launches()
        table = cl.gathered_table()
        out["steps"].append({"what": what, "arg": arg, "orphans": orphans, "table": table,
                             "state": cases.client_state(cl)})
        out["mesh_ranks"].append(cl.mesh.rank)
        if what == "reshard":
            out["checks"].append(_rebuilt_right(torch, cl, cfg, table, device, resident=True))
    out["occupancy_after"] = cl.occupancy
    out["launches"] = launches
    out["ms"] = ms
    return out


def _pair_records(torch, make_mesh, d, dp, engine, seed, device):
    """A client on ``make_mesh(d)`` through ``tests/test_reshard.py``'s
    workload of ``seed``, then ``reshard(dp)``: its orphans, drain stream,
    table, occupancies and ``ndev``; whether the rebuilt table is a cold
    cache's fed the drain stream with every chain resident; the client's
    calls; the launches of the workload and the reshard on this rank,
    counted from 0 and read before the cold cache's check."""
    from repro_torch.core import MSLRUConfig
    from repro_torch.core.sharded import ShardedCacheClient

    sys.path.insert(0, str(ROOT / "tests"))
    import torch_sharded_cases as cases

    cfg = MSLRUConfig(**cases.RESHARD_CFG)
    cl = ShardedCacheClient(cfg, make_mesh(d), engine=engine)
    calls = [0]
    access = cl.access

    def counted(*a, **k):
        calls[0] += 1
        return access(*a, **k)

    cl.access = counted
    zero_launches()
    r = cases.drive_reshard(cl, seed, dp, lambda c: c.gathered_table())
    launches = read_launches()
    ok = r["resident"] and r["occ_before"] > 0.5 and r["ndev"] == dp
    ok = ok and _rebuilt_right(torch, cl, cfg, r["table"], device)
    return {k: r[k] for k in ("orphans", "drain", "table", "occ_before", "occ_after",
                              "ndev")}, ok, calls[0], launches


def fault_rank(run, argv, phase21_tokens):
    """One rank of phase 31 (spawned by ``run_on_ranks``, gloo, sharing the
    card).  (a) For each (D, D', engine, seed): ``_pair_records`` on the
    first D ranks; then the real size (``_real_size``); rank 0 then makes
    the one-process client's digests (``one_process_reference``) while the
    others wait for (b).  (b) ``_bounded_serve``.  Returns digests of every
    record of (a) (the parent holds every rank's to the one-process
    client's), its launches per pair and the real size's times, and (b)'s
    record."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import ProcessCacheMesh

    device = run["device"]
    out = {"rank": dist.get_rank(), "pairs": {}}
    t0 = time.perf_counter()
    for d, dp, engine, seed in run["pairs"]:
        t = time.perf_counter()
        rec, ok, calls, launches = _pair_records(
            torch, lambda n: ProcessCacheMesh(n, device), d, dp, engine, seed, device)
        out["pairs"][(d, dp, engine, seed)] = {
            "digest": _digest(rec), "ok": ok, "launches": launches, "calls": calls,
            "ms_per_call": 1e3 * (time.perf_counter() - t) / calls}
    out["pairs_seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    real = _real_size(torch, ProcessCacheMesh(8, device), run)
    out["real_seconds"] = time.perf_counter() - t0
    out["real"] = {"digest": _digest(real["steps"]), "checks": real["checks"],
                   "launches": real["launches"], "ms": real["ms"],
                   "occupancy": (real["occupancy_before"], real["occupancy_after"]),
                   "chains": real["chains"], "mesh_ranks": real["mesh_ranks"],
                   "orphans": [len(s["orphans"]) for s in real["steps"]],
                   "drain_rows": [sum(b["keys"].size for b in s["state"]["drain"])
                                  for s in real["steps"]]}
    if out["rank"] == 0:
        t0 = time.perf_counter()
        out["one_process"] = one_process_reference(torch, run)
        out["reference_seconds"] = time.perf_counter() - t0
    release(torch)
    t0 = time.perf_counter()
    out["serve"] = _bounded_serve(argv, phase21_tokens)
    out["serve_seconds"] = time.perf_counter() - t0
    return out


def one_process_reference(torch, run) -> dict:
    """The digests of the one-process client's records (D logical shards
    on the card) of phase 31(a)'s calls."""
    from repro_torch.launch.mesh import make_cache_mesh

    device = run["device"]
    ref = {pair: _digest(_pair_records(torch, lambda n: make_cache_mesh(n, device), *pair,
                                       device)[0]) for pair in run["pairs"]}
    ref["real"] = _digest(_real_size(torch, make_cache_mesh(8, device), run)["steps"])
    return ref


def check_reshards(ranks) -> dict:
    """Phase 31(a): ``reshard`` and ``mark_degraded`` over FAULT_WORLD gloo
    ranks sharing the card (one world, every pair on its subgroups).  Every
    rank's records equal rank 0's and the one-process client's; every
    rebuilt table is a cold cache's fed the drain stream, every re-inserted
    chain resident; each engine's kernel ran on every rank that held rows,
    and on no other."""
    ref = ranks[0]["one_process"]
    out = {"world": FAULT_WORLD, "pairs_seconds": ranks[0]["pairs_seconds"],
           "real_seconds": ranks[0]["real_seconds"],
           "reference_seconds": ranks[0]["reference_seconds"], "pairs": {}}
    for d, dp, engine, seed in FAULT_PAIRS:
        recs = [r["pairs"][(d, dp, engine, seed)] for r in ranks]
        if not all(r["ok"] for r in recs):
            raise AssertionError(f"D = {d} -> {dp} ({engine}): a rebuilt table differs from "
                                 "the cold cache, or a chain was lost")
        if any(r["digest"] != ref[(d, dp, engine, seed)] for r in recs):
            raise AssertionError(f"D = {d} -> {dp} ({engine}): a rank's orphans, drain stream "
                                 "or table differ from the one-process client's")
        kernel = "msl_access" if engine == "rounds" else "msl_onepass"
        per_rank = [r["launches"][kernel] for r in recs]
        held = max(d, dp)
        if not all(per_rank[:held]) or any(per_rank[held:]):
            raise AssertionError(f"D = {d} -> {dp}: {kernel} launches per rank {per_rank}, "
                                 f"not on exactly the {held} ranks that held rows")
        out["pairs"][f"{d}->{dp} {engine}"] = {"seed": seed, "calls": recs[0]["calls"],
                                               "ms_per_call": recs[0]["ms_per_call"],
                                               f"{kernel}_per_rank": per_rank}
        log(f"D = {d} -> {dp} ({engine}), seed {seed}: every rank's rebuilt "
            f"table == a cold cache fed the drain stream, orphans and drain stream == the "
            f"one-process client's, every chain resident; {recs[0]['calls']} cache calls at "
            f"{recs[0]['ms_per_call']:.3f} ms (rank 0); {kernel} launches per rank "
            f"{per_rank}")
    real = [r["real"] for r in ranks]
    if not all(all(r["checks"]) for r in real) or any(
            r["digest"] != ref["real"] for r in real):
        raise AssertionError("the real-size reshards differ from the one-process client's, "
                             "or a rebuilt table from the cold cache")
    r0 = real[0]
    if not r0["occupancy"][0] > 0.5:
        raise AssertionError(f"the real-size workload filled only {r0['occupancy'][0]:.3f}")

    def mean(xs):
        return sum(xs) / max(1, len(xs))

    rec = {"sets": REAL_SETS, "entries": REAL_SETS * 8, "chains_registered": r0["chains"],
           "occupancy": r0["occupancy"], "orphans": r0["orphans"],
           "drain_rows": r0["drain_rows"],
           "ms_per_cache_call": mean(r0["ms"]["access"]),
           "ms_per_drain_sweep": mean(r0["ms"]["drain"]),
           "ms_per_reinsert_sweep": mean(r0["ms"]["reinsert"]),
           "drain_sweeps": len(r0["ms"]["drain"]), "reinsert_sweeps": len(r0["ms"]["reinsert"]),
           "ms_per_reshard": r0["ms"]["reshard"], "ms_per_mark_degraded": r0["ms"]["degrade"],
           "ms_per_reshard_slowest_rank": [max(r["ms"]["reshard"][i] for r in real)
                                           for i in range(2)],
           "msl_onepass_per_rank": [r["launches"]["msl_onepass"] for r in real],
           "rank7_mesh_rank_per_step": real[7]["mesh_ranks"]}
    if not all(rec["msl_onepass_per_rank"]):
        raise AssertionError(f"msl_onepass launches per rank at the real size "
                             f"{rec['msl_onepass_per_rank']}")
    if rec["rank7_mesh_rank_per_step"] != [-1, -1, 7]:
        raise AssertionError(f"rank 7's place in the cache per step: "
                             f"{rec['rank7_mesh_rank_per_step']}")
    out["real"] = rec
    log(f"real size, {REAL_SETS} sets x 8 ways ({rec['entries']} entries), "
        f"{rec['chains_registered']} chains registered, occupancy {r0['occupancy'][0]:.4f}: "
        f"8 -> 7, mark_degraded(3), 7 -> 8 on every rank == the one-process client's "
        f"(orphans {rec['orphans']}, drain rows {rec['drain_rows']}); "
        f"{rec['ms_per_cache_call']:.3f} ms per cache call, {rec['ms_per_drain_sweep']:.3f} ms "
        f"per drain sweep ({rec['drain_sweeps']}), {rec['ms_per_reinsert_sweep']:.3f} ms per "
        f"re-insert sweep ({rec['reinsert_sweeps']}), ms per reshard "
        f"{[round(x, 3) for x in rec['ms_per_reshard']]}, per mark_degraded "
        f"{[round(x, 3) for x in rec['ms_per_mark_degraded']]}; msl_onepass launches per "
        f"rank {rec['msl_onepass_per_rank']}; {out['pairs_seconds']:.1f} s for the pairs, "
        f"{out['real_seconds']:.1f} s for the real size, {out['reference_seconds']:.1f} s for "
        f"the one-process reference")
    return out


def _bounded_serve(argv, phase21_tokens):
    """Phase 31(b) on one rank: ``serve --processes``'s ranks with phase
    21's first bounded serve.  Rank 0 builds phi3-mini-3.8b at full width
    (``serve.build`` on a ``ProcessCacheMesh`` of all ranks) and serves
    leading the cache (``sharded_serve``), keeps ``serve_record`` and checks
    any token that differs from phase 21's for a near-tie; the others
    follow.  Every rank returns its launches, its transport counts and
    where it ends."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import ProcessCacheMesh

    args = serve.parser().parse_args(argv)
    mesh = ProcessCacheMesh(args.sharded, args.device)
    out = {"rank": dist.get_rank()}
    if out["rank"]:
        client = serve.cache_client(args, mesh)
        zero_launches()
        out["calls"] = client.follow()
        out["launches"] = read_launches()
    else:
        reqs = serve.make_requests(get_config(args.arch, smoke=args.smoke), args)
        keep = {}
        eng, rec = sharded_serve(torch, args, reqs, serve.fault_plan(args), mesh=mesh,
                                 keep=keep)
        client = eng.prefix_cache.cache
        got = keep["tokens"]
        out.update(rec=rec, keep=keep, launches=rec["launches"],
                   near_ties=near_ties(torch, eng, reqs, got, phase21_tokens))
        del eng
        release(torch)
    out.update(mesh_rank=client.mesh.rank, ndev=client.ndev,
               stage_s=client.mesh.stage_seconds, wire_s=client.mesh.wire_seconds,
               exchanges=client.mesh.exchanges)
    return out


def check_bounded_serve(ranks, argv, phase21, kept) -> dict:
    """Phase 31(b): phase 21's first bounded serve (``BOUNDED``, in-flight,
    paged, phi3-mini-3.8b at full width and depth) with the cache on
    SHARDS gloo ranks sharing the card and the engine on rank 0 (``serve
    --processes``).  Ticks, fault log, finish order, prefill split, every
    stats and prefix-cache key, the pool and the gathered table equal phase
    21's (``kept``); tokens equal its or split at a near-tie; rank 7 ends
    outside the cache's group."""
    import numpy as np

    want = {k: v for k, v in kept.items() if k != "tokens"}
    r0 = ranks[0]
    got = {k: v for k, v in r0["keep"].items() if k != "tokens"}
    differ = [k for k in want if not (np.array_equal(got[k], want[k]) if k == "table"
                                      else got[k] == want[k])]
    if differ:
        raise AssertionError(f"the serve with its cache across processes differs from phase "
                             f"21's in {differ}")
    if ranks[7]["mesh_rank"] != -1 or ranks[0]["ndev"] != 7:
        raise AssertionError("rank 7 did not end outside a cache of 7 ranks")
    onepass = [r["launches"]["msl_onepass"] for r in ranks]
    if not all(onepass[:7]) or onepass[7] >= onepass[0]:
        raise AssertionError(f"msl_onepass launches per rank {onepass}")
    ex = sum(r["exchanges"] for r in ranks)
    rec = r0["rec"]
    out = {"argv": argv, "phase_seconds": ranks[0]["serve_seconds"], "ticks": rec["ticks"],
           "fault_log": rec["fault_log"], "equal_phase21": True,
           "tokens_equal": len(r0["near_ties"]) == 0, "near_ties": r0["near_ties"],
           "ms_per_decode_tick": rec["ms_per_decode_tick"],
           "phase21_ms_per_decode_tick": phase21["ms_per_decode_tick"],
           "host_ms_per_cache_call": rec["host_ms_per_cache_call"],
           "phase21_host_ms_per_cache_call": phase21["host_ms_per_cache_call"],
           "placement_ms_per_cache_call": rec["placement_ms_per_cache_call"],
           "ms_per_applied_fault": rec["ms_per_applied_fault"],
           "phase21_ms_per_applied_fault": phase21["ms_per_applied_fault"],
           "cache_calls": rec["cache_calls"], "wall_s": rec["wall_s"],
           "phase21_wall_s": phase21["wall_s"],
           "exchanges": ex, "stage_ms_per_exchange": 1e3 * sum(r["stage_s"] for r in ranks) / ex,
           "wire_ms_per_exchange": 1e3 * sum(r["wire_s"] for r in ranks) / ex,
           "msl_onepass_per_rank": onepass,
           "paged_attn_rank0": r0["launches"]["paged_attn"],
           "follower_calls": [r.get("calls") for r in ranks[1:]],
           "mesh_rank_at_end": [r["mesh_rank"] for r in ranks]}
    log(f"bounded serve, cache on {SHARDS} gloo ranks, engine on rank 0: {out['ticks']} ticks, "
        f"faults {out['fault_log']}; ticks, fault log, finish order, prefill split, stats, "
        f"prefix-cache counters, pool and table == phase 21's; tokens "
        f"{'equal' if out['tokens_equal'] else 'equal but near-ties'}; "
        f"{out['ms_per_decode_tick']:.3f} ms per decode tick (phase 21 "
        f"{out['phase21_ms_per_decode_tick']:.3f}), {out['host_ms_per_cache_call']:.3f} host ms "
        f"per cache call (phase 21 {out['phase21_host_ms_per_cache_call']:.3f}); "
        f"{out['stage_ms_per_exchange']:.4f} ms staging + {out['wire_ms_per_exchange']:.4f} ms "
        f"gloo per exchange ({ex}); ms per applied fault "
        f"{[round(x, 2) for x in out['ms_per_applied_fault']]} (phase 21 "
        f"{[round(x, 2) for x in out['phase21_ms_per_applied_fault']]}); msl_onepass per rank "
        f"{onepass}, paged_attn on rank 0 {out['paged_attn_rank0']}; ranks at the end "
        f"{out['mesh_rank_at_end']}; {out['phase_seconds']:.1f} s")
    return out


def run_faults(torch, phase21, kept):
    """Phase 31: one world of FAULT_WORLD gloo ranks sharing the card runs
    (a) and then (b) (``fault_rank``); any rank's failure fails the phase.
    Returns (a)'s and (b)'s records."""
    from repro_torch.launch.mesh import run_on_ranks

    argv = ["--no-smoke", "--device", DEVICE, "--kv-mode", "paged", *BOUNDED, "--processes"]
    t = time.perf_counter()
    ranks = run_on_ranks(fault_rank, FAULT_WORLD, "gloo", DEVICE,
                         args=(fault_sizes(), argv, kept["tokens"]), timeout=900)
    wall = time.perf_counter() - t
    reshards = check_reshards(ranks)
    phase(f"31(b). phi3-mini-3.8b at full width, phase 21's bounded serve with the cache on "
          f"{SHARDS} gloo ranks and the engine on rank 0 (run in 31's world, after (a))")
    bounded = check_bounded_serve([r["serve"] | {"serve_seconds": r["serve_seconds"]}
                                   for r in ranks], argv, phase21, kept)
    reshards["phase_seconds"] = wall
    return reshards, bounded


# ---------------------------------------------------------------------------
# The port's examples on the card (phase 32)
# ---------------------------------------------------------------------------

# the examples' results on the CPU, which the card's runs must give:
# tests/test_torch_examples.py holds them to the JAX examples
# (examples/quickstart.py, distributed_cache.py, serve_prefix_cache.py)
EXAMPLE_RESULTS = {
    "quickstart": {"capacity": 4096, "queries": 200_000, "hits": 144_807, "occupancy": 1.0,
                   "value_integrity": True, "reaccess_hits": 7, "evictions": 51_097},
    "distributed_cache": {"capacity": 32768, "shards": 8, "queries": 65536, "hits": 48_417,
                          "served": 65536, "oracle_hits": 48_417, "table_identical": True},
    "serve_prefix_cache": {
        "requests": 24, "served": 24, "served_without": 24, "tokens": 144,
        "tokens_without": 144, "prefill_computed": 463, "prefill_skipped": 1280,
        "prefill_computed_without": 1743,
        "cache_stats": {"hits": 72, "misses": 6, "hit_ratio": 72 / 78, "evictions": 0,
                        "occupancy": 0.0078125, "device_calls": 6, "shed": 0,
                        "partial_served": 0, "retried": 0, "fallbacks": 0,
                        "service_ticks_p50": 15.0, "service_ticks_p99": 25.0,
                        "reprefill_flops": 5120, "evicted_cost": 0}},
}
# the kernels each example's run must launch
EXAMPLE_KERNELS = {"quickstart": ("msl_onepass",),
                   "distributed_cache": ("msl_onepass", "msl_seq"),
                   "serve_prefix_cache": ("msl_onepass", "paged_attn")}


def run_examples(torch):
    """Phase 32: ``examples/torch_quickstart.py``, ``torch_distributed_cache.py``
    and ``torch_serve_prefix_cache.py`` in this process on the card
    (``main(["--device", DEVICE])``): their own checks (value integrity
    "OK", final table "YES"), every number of EXAMPLE_RESULTS equal, and each
    example's kernels launched (counted from 0 for each run)."""
    out = {}
    for name, want in EXAMPLE_RESULTS.items():
        zero_launches()
        t = time.perf_counter()
        got = example(f"torch_{name}").main(["--device", DEVICE])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = {k: v for k, v in read_launches().items() if v}
        wrong = {k: (got[k], v) for k, v in want.items() if got[k] != v}
        if wrong:
            raise AssertionError(f"examples/torch_{name}.py on the card: (card, CPU) {wrong}")
        missing = [k for k in EXAMPLE_KERNELS[name] if not launches.get(k)]
        if missing:
            raise AssertionError(f"examples/torch_{name}.py launched no {missing}: {launches}")
        out[name] = {"results": {k: got[k] for k in want}, "launches": launches,
                     "wall_s": wall}
        log(f"examples/torch_{name}.py on the card: every result equal to the CPU's; "
            f"launches {launches}; {wall:.1f} s")
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
    print(smi, flush=True)
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
    seq_rec = seq_record(torch, keys, vals, summary, records[1]["chain_step_ns"], smi)
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
    records.append(seq_rec)
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

    phase(f"14. starcoder2-7b at full width, {FULL_WIDTH_LAYERS['starcoder2-7b']} layers, "
          "paged: in-flight and megastep")
    serving["starcoder2-7b"], rec = run_full_width(torch, "starcoder2-7b",
                                                  errs["paged_attn"], buckets)
    shapes.append(rec)
    release(torch)

    phase(f"15. gemma3-1b at full width, {FULL_WIDTH_LAYERS['gemma3-1b']} layers, paged")
    serving["gemma3-1b"], rec = run_full_width(torch, "gemma3-1b", errs["paged_attn"])
    shapes.append(rec)
    release(torch)

    phase(f"16. olmoe-1b-7b at full width, {FULL_WIDTH_LAYERS['olmoe-1b-7b']} layers, paged: "
          "in-flight and megastep")
    serving["olmoe-1b-7b"], rec = run_full_width(torch, "olmoe-1b-7b", errs["paged_attn"],
                                                buckets)
    shapes.append(rec)
    release(torch)

    for label, arch, what in (
            ("16(b)", "command-r-35b", "whole depth; in-flight, megastep and the contiguous "
                                       "cross-check"),
            ("16(c)", "qwen2-vl-72b", "M-RoPE; in-flight and megastep"),
            ("16(d)", "phi3.5-moe-42b-a6.6b", "in-flight and megastep")):
        phase(f"{label}. {arch} at full width, {FULL_WIDTH_LAYERS[arch]} layers, paged, {what}")
        serving[arch], rec = run_full_width(torch, arch, errs["paged_attn"], buckets,
                                            cross=arch == "command-r-35b")
        shapes.append(rec)
        release(torch)
    for arch in ("olmoe-1b-7b", "phi3.5-moe-42b-a6.6b"):
        m = serving[arch]["moe_ffn"]
        log(f"{arch}: MoE FFN {m['device_ms_per_step']:.4f} ms per decode step against its "
            f"{m['expert_bytes'] / 1e9:.2f} GB expert read, {m['expert_bound_ms']:.3f} ms "
            f"({m['expert_bound_ms'] / m['device_ms_per_step']:.3f} of the memory rate)")

    phase(f"17. hymba at smoke width and at full width, {FULL_WIDTH_LAYERS[HYMBA]} layers, "
          "contiguous")
    serving["hymba-smoke"] = run_contiguous(torch, HYMBA, smoke=True)
    release(torch)
    serving[HYMBA] = run_contiguous(torch, HYMBA, smoke=False)
    release(torch)

    phase(f"18. xlstm at smoke width and at full width, {FULL_WIDTH_LAYERS[XLSTM]} blocks, "
          "contiguous")
    serving["xlstm-smoke"] = run_contiguous(torch, XLSTM, smoke=True, roundrobin="exact")
    release(torch)
    serving[XLSTM] = run_contiguous(torch, XLSTM, smoke=False, roundrobin="exact")
    release(torch)

    phase(f"19. whisper at smoke width and at full width, {FULL_WIDTH_LAYERS[WHISPER]} "
          "decoder layers, contiguous")
    serving["whisper-smoke"] = run_contiguous(torch, WHISPER, smoke=True, roundrobin=None)
    release(torch)
    serving[WHISPER] = run_contiguous(torch, WHISPER, smoke=False, roundrobin=None)
    release(torch)
    # the paged kernel's record at every other path's shapes
    records[2]["shapes"] = shapes

    phase(f"20. the sharded cache: {SHARDS} logical shards on the card at the main "
          "path's size")
    keys, vals, stream_table = (x.to(DEVICE) for x in host_stream)
    summary["sharded"] = run_sharded_cache(torch, cfg, keys, vals, stream_table, summary)
    records[0]["launches_sharded_path"] = summary["sharded"]["launches_rounds_check"][
        "msl_access"]
    records[1]["launches_sharded_path"] = summary["sharded"]["launches_stream"]["msl_onepass"]
    del keys, vals, stream_table
    release(torch)

    phase(f"21. phi3-mini-3.8b at full width behind {SHARDS} shards: sheds, retries, "
          "split placement, throttling, faults")
    phase21 = {}     # the first bounded serve's record, kept for phase 31(b)
    serving["sharded"] = run_sharded_serving(torch, phase8, buckets, keep=phase21)
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

    phase(f"23. phi3-mini-3.8b training at full width: {CUT_LAYERS} layer(s) against the "
          "CPU, then "
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

    phase("25. the Python oracle against both msl kernels on the card")
    claims = {"oracle": run_oracle(torch)}
    records[0]["launches_oracle_path"] = claims["oracle"]["launches"]["msl_access"]
    records[1]["launches_oracle_path"] = claims["oracle"]["launches"]["msl_onepass"]
    release(torch)

    phase("26. the paper's claims at the figures' scale through the one-pass kernel")
    claims["figures"] = run_paper_claims(torch)
    records[1]["launches_figures_path"] = claims["figures"]["launches"]["msl_onepass"]
    release(torch)

    phase("27. step bundles, input specs and the dry run: phi3-mini-3.8b")
    claims["bundles"] = run_step_bundles(torch)
    claims["dryrun"] = run_dryrun(torch, training[PHI3])
    release(torch)

    phase("28. the route between processes: D = 2, 4, 8 gloo ranks sharing the card at the "
          "main path's size")
    summary["route"] = run_route(torch, cfg, host_stream, summary)
    del host_stream
    records[0]["launches_route_path"] = summary["route"]["d8"]["msl_access_per_rank"]
    records[1]["launches_route_path"] = summary["route"]["d8"]["msl_onepass_per_rank"]
    release(torch)

    phase("29. int8 gradient compression: the card against the CPU, then over 4 gloo ranks")
    training["compression"] = run_compression(torch)
    release(torch)

    # 30(c) traces on the host while 30(a) and 30(b) run on the card; the
    # training path launches none of the three kernels
    import tempfile

    zero_launches()
    with tempfile.TemporaryDirectory() as dry_dir:
        dry = start_mesh_dryrun(dry_dir)
        try:
            phase("30. the sharded step on the card: (a) phi3-mini-3.8b on a (1, 1) mesh of one "
                  "NCCL rank")
            sharded = {"one_rank_mesh": run_mesh_training(torch, training[PHI3])}
            release(torch)
            phase(f"30(b). phi3-mini-3.8b, {CUT_LAYERS} layer(s), on meshes (2, 1), (1, 2), "
                  "(2, 2) in one world of gloo "
                  "ranks sharing the card")
            sharded["rank_meshes"] = run_rank_meshes(torch)
            release(torch)
            phase("30(c). the dry run's pod1 and pod2 records of phi3-mini-3.8b, counted from "
                  "the sharded step")
            claims["dryrun"]["mesh_cells"] = finish_mesh_dryrun(dry, dry_dir)
        finally:
            for _, p in dry:
                p.kill()
    launches = read_launches()
    if any(launches.values()):
        raise AssertionError(f"the sharded step launched kernels: {launches}")
    training["sharded_step"] = sharded

    phase(f"31. faults across processes, {FAULT_WORLD} gloo ranks sharing the card: (a) "
          "reshard and mark_degraded")
    summary["reshard_processes"], serving["sharded_processes"] = run_faults(
        torch, serving["sharded"]["bounded"], phase21)
    d87 = summary["reshard_processes"]["pairs"]["8->7 rounds"]["msl_access_per_rank"]
    records[0]["launches_process_reshard_path"] = d87
    records[1]["launches_process_reshard_path"] = summary["reshard_processes"]["real"][
        "msl_onepass_per_rank"]
    records[1]["launches_process_serving_path"] = serving["sharded_processes"][
        "msl_onepass_per_rank"]
    records[2]["launches_process_serving_path"] = serving["sharded_processes"][
        "paged_attn_rank0"]
    release(torch)

    phase("32. the port's examples on the card: quickstart, distributed cache, prefix-cached "
          "serving")
    serving["examples"] = run_examples(torch)
    for r in records:
        r["launches_examples_path"] = sum(x["launches"].get(r["name"], 0)
                                          for x in serving["examples"].values())
    release(torch)

    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(smi, flush=True)
    print(json.dumps({"main_path": summary, "card": smi}))
    print(json.dumps({"serving": serving, "card": smi}))
    print(json.dumps({"training": training, "card": smi}))
    print(json.dumps({"oracle_claims_steps": claims, "card": smi}))
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
