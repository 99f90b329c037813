"""Serving entry point: ``python -m repro_torch.launch.serve [--no-smoke] [--kv-mode paged] [--decode-mode megastep] [--sharded D]``.

Port of ``repro.launch.serve``.  Brings up the continuous-batching engine
with the multi-step-LRU prefix cache and runs the launcher's synthetic
request workload: shared-prefix templates with Zipf popularity, each
followed by a short random suffix.  ``build(args)`` returns the engine and
``make_requests(cfg, args)`` the requests, so that other scripts (the
repository's ``chip_smoke.py``) run exactly this path.

``--arch`` picks any architecture of ``configs.list_archs()``: the
attention decoders phi3-mini-3.8b, gemma3-1b, starcoder2-7b, command-r-35b
and qwen2-vl-72b, the MoE decoders olmoe-1b-7b and phi3.5-moe-42b-a6.6b,
the hymba-1.5b hybrid, xlstm-1.3b and the whisper-medium encoder-decoder.
hymba, xLSTM and Whisper serve with ``--kv-mode contiguous`` only, through
plain admission (their recurrent state, or a decoder KV that depends on the
request's audio, cannot resume from cached KV pages, so the prefix cache
stays unused, as in the JAX engine); ``--kv-mode paged`` raises for them.
A Whisper request carries audio frames (enc_len, d_model) drawn from
``--seed``, standard normal, in place of the stubbed conv frontend.
Defaults as in the JAX launcher: phi3-mini-3.8b at smoke size, 24
requests over 8 templates of 64 tokens, suffixes of 4-16 tokens, 8 new
tokens each; ``PrefixCache(num_sets=256, m=2, p=4, chunk_tokens=16)``,
``PagedKVPool(n_pages=256, page_tokens=16)``,
``ServeEngine(slots=4, max_len=256)``.  ``--no-smoke`` serves the published
widths and depth (the JAX launcher's ``--smoke`` cannot be turned off).
``--device`` defaults to ``cuda``; ``--device cpu`` serves on the CPU
through the kernels' plain versions.  Weights are random, from a seeded
``torch.Generator`` on the device.  ``--decode-mode`` picks in-flight,
round-robin or megastep decode (on a CUDA device a megastep window is one
replay of a captured CUDA graph per pow2 bucket of ``--max-window``).

``--sharded D`` backs the prefix cache with a ``ShardedCacheClient`` over D
logical shards on the engine's device (``launch/mesh.py``; the JAX launcher
runs D devices of a mesh), ``MSLRUConfig(num_sets=256, m=2, p=4,
value_planes=1)`` as there.  ``--cap`` bounds its per-peer buffers (0:
``"full"``), ``--placement`` picks its chain placement, and
``--throttle-threshold`` turns on the engine's owner-aware admission
throttling.  ``--chaos-seed`` serves under ``FaultPlan.seeded(seed,
ticks=--requests, ndev=D, n_events=--chaos-events)`` (``fault_plan(args)``).

``--processes`` (with ``--sharded D``) puts the D shards in D processes
instead, one shard each, as the JAX launcher puts them on D devices:
``run_on_ranks`` spawns D ranks over gloo (``--cache-backend nccl``: one
card per rank), rank 0 builds the engine on ``--device`` and its client on
a ``ProcessCacheMesh`` of all D ranks, and serves inside the client's
``leading()``; every other rank holds the same client and replays rank
0's calls (``ShardedCacheClient.follow``).  A resize to D' < D leaves
ranks D'..D-1 outside the cache's group, still replaying; a later grow
takes them back.  The report adds the host-staging and gloo ms per
exchange.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.core import MSLRUConfig, resolve_device
from repro_torch.core.sharded import ShardedCacheClient
from repro_torch.data.ycsb import zipfian
from repro_torch.launch.elastic import FaultPlan
from repro_torch.launch.mesh import ProcessCacheMesh, make_cache_mesh, run_on_ranks
from repro_torch.models.model import make_model
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.serving.kv_cache import PagedKVPool
from repro_torch.serving.prefix_cache import PrefixCache


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="phi3-mini-3.8b", choices=list_archs())
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction, default=True,
                    help="reduced same-family config (--no-smoke: published "
                         "widths and depth)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the weights and the request mix")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--templates", type=int, default=8)
    ap.add_argument("--prefix-tokens", type=int, default=64)
    ap.add_argument("--chunk-tokens", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--no-prefix-cache", action="store_true")
    ap.add_argument("--decode-mode", choices=["inflight", "roundrobin", "megastep"],
                    default="inflight",
                    help="inflight: one decode launch per tick advances every "
                         "slot at its own length; roundrobin: the legacy "
                         "min-length schedule (equivalence oracle); megastep: "
                         "K pure-decode ticks as one device program (a CUDA "
                         "graph replay on the card) with one host sync per "
                         "window (token-identical to inflight)")
    ap.add_argument("--max-window", type=int, default=16, metavar="K",
                    help="megastep window cap (windows pad to pow2 buckets, "
                         "one captured graph each)")
    ap.add_argument("--kv-mode", choices=["contiguous", "paged"],
                    default="contiguous",
                    help="contiguous: gather cached prefix pages into each "
                         "slot's private KV (the oracle); paged: decode "
                         "walks a per-slot block table over the shared pool "
                         "(on a CUDA device, the paged-attention kernel)")
    ap.add_argument("--sharded", type=int, default=0, metavar="D",
                    help="back the prefix cache with a ShardedCacheClient over "
                         "D logical shards on the device")
    ap.add_argument("--cap", type=float, default=0.0,
                    help="per-peer cap multiplier for --sharded (0 = 'full', "
                         "no shedding)")
    ap.add_argument("--placement", choices=["load", "roundrobin", "split"],
                    default=None,
                    help="sharded chain placement (default: split under a "
                         "bounded --cap, load otherwise); split packs chunk "
                         "fragments across slabs and sheds only the "
                         "un-placeable suffix")
    ap.add_argument("--throttle-threshold", type=float, default=0.0,
                    help="owner-aware admission throttling: defer new "
                         "admissions whose home shards report pressure >= "
                         "this level (0 = off; needs --sharded)")
    ap.add_argument("--chaos-seed", type=int, default=-1,
                    help="serve under a seeded FaultPlan (needs --sharded); "
                         "faults apply at tick boundaries")
    ap.add_argument("--chaos-events", type=int, default=3,
                    help="events in the seeded FaultPlan")
    ap.add_argument("--processes", action="store_true",
                    help="the --sharded D shards in D spawned processes, one "
                         "each; rank 0 serves, the others replay its cache calls")
    ap.add_argument("--cache-backend", choices=["gloo", "nccl"], default="gloo",
                    help="the process group of --processes: gloo through host "
                         "memory (ranks may share a card), nccl (one card per rank)")
    return ap


def cache_client(args, mesh) -> ShardedCacheClient:
    """The sharded prefix-cache backend of ``--sharded`` on ``mesh``."""
    return ShardedCacheClient(MSLRUConfig(num_sets=256, m=2, p=4, value_planes=1), mesh,
                              cap=args.cap if args.cap > 0 else "full",
                              placement=args.placement)


def build(args, mesh=None, cfg=None) -> ServeEngine:
    """The engine the arguments describe, weights made on ``args.device``;
    with ``mesh`` (a ``ProcessCacheMesh``) the sharded backend on it in
    place of ``--sharded`` logical shards on the device; with ``cfg`` that
    architecture in place of ``--arch``'s (its depth cut, say)."""
    if args.kv_mode == "paged" and args.no_prefix_cache:
        raise ValueError("--kv-mode paged requires the prefix cache (the pool "
                         "is the resident prefix store)")
    if args.throttle_threshold > 0 and not args.sharded:
        raise ValueError("--throttle-threshold needs --sharded (pressure comes "
                         "from the sharded backend's load mirror)")
    if args.chaos_seed >= 0 and not args.sharded:
        raise ValueError("--chaos-seed needs --sharded (the faults' targets)")
    if args.processes and mesh is None:
        raise ValueError("--processes builds on each rank with its ProcessCacheMesh "
                         "(serve_rank)")
    fault_plan(args)    # refuses a plan the mesh cannot apply
    device = resolve_device(args.device)
    model = make_model(cfg or get_config(args.arch, smoke=args.smoke))
    params = model.init(torch.Generator(device=device).manual_seed(args.seed))
    cfg = model.cfg
    pool = pc = None
    if not args.no_prefix_cache:
        pool = PagedKVPool(cfg, n_pages=256, page_tokens=args.chunk_tokens,
                           device=device)
        backend = None
        if args.sharded:
            backend = cache_client(args, mesh if mesh is not None
                                   else make_cache_mesh(args.sharded, device=device))
        pc = PrefixCache(num_sets=256, m=2, p=4, chunk_tokens=args.chunk_tokens,
                         device=device, backend=backend)
    return ServeEngine(model, params, slots=4, max_len=256, prefix_cache=pc,
                       pool=pool, decode_mode=args.decode_mode, kv_mode=args.kv_mode,
                       max_window=args.max_window,
                       throttle_threshold=(args.throttle_threshold
                                           if args.throttle_threshold > 0 else None))


def fault_plan(args) -> FaultPlan | None:
    """The seeded fault plan ``--chaos-seed`` asks for (None without one).

    ``FaultPlan.seeded`` (as the JAX package's) may degrade a shard that an
    earlier resize removed, or the last healthy shard of a smaller mesh;
    such a plan is refused here, before the serve, rather than failing
    mid-serve at its degrade."""
    if args.chaos_seed < 0:
        return None
    plan = FaultPlan.seeded(args.chaos_seed, ticks=args.requests, ndev=args.sharded,
                            n_events=args.chaos_events)
    ndev, degraded = args.sharded, set()
    for ev in plan.events:
        if ev.kind == "resize":
            ndev, degraded = ev.arg, set()
        elif ev.kind == "degrade":
            degraded.add(ev.arg)
            if ev.arg >= ndev or len(degraded) >= ndev:
                raise ValueError(
                    f"--chaos-seed {args.chaos_seed}: the plan degrades shard {ev.arg} "
                    f"at tick {ev.tick} on a mesh of {ndev} shards with "
                    f"{sorted(degraded - {ev.arg})} already degraded; pick another seed")
    return plan


def make_requests(cfg, args) -> list[Request]:
    """The launcher's request mix: ``args.requests`` prompts, each a Zipf(1.0)
    pick of ``args.templates`` shared templates plus a 4-16 token suffix;
    for an encoder-decoder, each with its own frames (enc_len, d_model) bf16,
    standard normal from a generator seeded ``args.seed + 2``."""
    rng = np.random.default_rng(args.seed)
    frames_rng = np.random.default_rng(args.seed + 2)
    templates = [rng.integers(1, cfg.vocab_size, args.prefix_tokens).astype(np.int32)
                 for _ in range(args.templates)]
    picks = zipfian(args.templates, args.requests, alpha=1.0, seed=args.seed + 1) - 1
    reqs = []
    for i in range(args.requests):
        suffix = rng.integers(1, cfg.vocab_size, 4 + i % 13).astype(np.int32)
        prompt = np.concatenate([templates[int(picks[i]) % args.templates], suffix])
        frames = None
        if cfg.enc_dec:
            frames = torch.from_numpy(frames_rng.standard_normal(
                (cfg.enc_len, cfg.d_model), np.float32)).to(torch.bfloat16)
        reqs.append(Request(rid=i, prompt=prompt, max_new_tokens=args.max_new,
                            frames=frames))
    return reqs


def serve(eng, args, plan) -> tuple[list[str], dict]:
    """Serve the launcher's requests through ``eng`` under ``plan``: the
    report's lines and its record (ticks, fault log, finish order, prefill
    split, stats)."""
    t0 = time.time()
    for req in make_requests(eng.cfg, args):
        eng.submit(req)
    ticks = eng.run_until_done(fault_plan=plan)
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    dt = time.time() - t0
    lines = []
    if plan is not None:
        lines.append(f"[serve] faults applied: {eng.fault_log}, fallbacks={eng.fallbacks}")

    skipped = sum(r.prefill_skipped for r in eng.finished)
    computed = sum(r.prefill_computed for r in eng.finished)
    lines.append(f"[serve] {len(eng.finished)} requests in {ticks} ticks, {dt:.1f}s "
                 f"on {eng.device}")
    lines.append(f"[serve] prefill tokens: computed={computed} skipped={skipped} "
                 f"({skipped / (skipped + computed):.1%} saved)")
    st = eng.stats()
    lines.append(f"[serve] decode: {st['decode_launches']} launches, "
                 f"{st['decode_tokens']} tokens, "
                 f"{st['launches_per_token']:.3f} rows/token, host_syncs="
                 f"{st['host_syncs']}, admit wait p50/p99 "
                 f"{st['service_ticks_p50']:.0f}/{st['service_ticks_p99']:.0f} ticks")
    if args.decode_mode == "megastep":
        lines.append(f"[serve] megastep: {st['megastep_windows']} windows "
                     f"(mean {st['mean_window']:.1f} ticks, cap {st['max_window']}), "
                     f"host_syncs={st['host_syncs']} ({st['host_syncs_per_token']:.3f}/token), "
                     f"drain rows/token={st['drain_launches_per_token']:.3f}")
    lines.append(f"[serve] kv: mode={st['kv_mode']} gather_calls={st['gather_calls']} "
                 f"resident_kv_peak={st['resident_kv_tokens_peak']} tok "
                 f"({st['resident_kv_bytes_peak'] / 2**20:.1f} MiB)")
    if args.sharded:
        lines.append(f"[serve] sharded: D={args.sharded} placement="
                     f"{eng.prefix_cache.cache.placement} split_chains={st['split_chains']} "
                     f"partial_sheds={st['partial_sheds']} "
                     f"partial_served={st['partial_served']} "
                     f"slab_occupancy_peak={st['slab_occupancy_peak']:.2f} "
                     f"throttled={st['throttled_admissions']} "
                     f"fallback_rate={st['fallback_rate']:.3f}")
    pc = None
    if eng.prefix_cache is not None:
        pc = eng.prefix_cache.stats()
        lines.append(f"[serve] prefix cache: {pc}")
    record = {"ticks": ticks, "fault_log": list(eng.fault_log),
              "order": [r.rid for r in eng.finished],
              "prefill": [(r.rid, r.prefill_skipped, r.prefill_computed)
                          for r in eng.finished],
              "stats": st, "prefix_cache": pc}
    return lines, record


def serve_rank(args) -> dict:
    """One rank of ``--processes`` (spawned by ``run_on_ranks``): rank 0
    builds the engine and serves, leading the cache; the others follow.
    Rank 0 returns the report and its record; every rank its transport
    counts and its client calls."""
    import torch.distributed as dist

    mesh = ProcessCacheMesh(args.sharded, args.device)
    out = {}
    if dist.get_rank() == 0:
        eng = build(args, mesh=mesh)
        client = eng.prefix_cache.cache
        with client.leading():
            out["lines"], out["record"] = serve(eng, args, fault_plan(args))
    else:
        client = cache_client(args, mesh)
        out["calls"] = client.follow()
    out.update(stage_s=client.mesh.stage_seconds, wire_s=client.mesh.wire_seconds,
               exchanges=client.mesh.exchanges, ndev=client.ndev, rank=client.mesh.rank)
    return out


def main(argv=None) -> dict:
    """Run the launcher; prints the report and returns its record."""
    args = parser().parse_args(argv)
    plan = fault_plan(args)
    if args.processes and not args.sharded:
        raise ValueError("--processes needs --sharded (one process per shard)")
    if plan is not None:
        print(f"[serve] fault plan: {plan.events}")
    if args.processes:
        ranks = run_on_ranks(serve_rank, args.sharded, args.cache_backend, args.device,
                             args=(args,))
        lines, record = ranks[0]["lines"], ranks[0]["record"]
        ex = sum(r["exchanges"] for r in ranks)
        lines.append(f"[serve] processes: {args.sharded} ranks ({args.cache_backend}), "
                     f"{ex} exchanges, "
                     f"{1e3 * sum(r['stage_s'] for r in ranks) / max(1, ex):.4f} ms host "
                     f"staging + {1e3 * sum(r['wire_s'] for r in ranks) / max(1, ex):.4f} "
                     f"ms {args.cache_backend} per exchange; cache on "
                     f"{ranks[0]['ndev']} ranks at the end")
        record["ranks"] = ranks
    else:
        lines, record = serve(build(args), args, plan)
    for line in lines:
        print(line)
    return record


if __name__ == "__main__":
    main()
