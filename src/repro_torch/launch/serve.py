"""Serving entry point: ``python -m repro_torch.launch.serve [--no-smoke] [--kv-mode paged] [--decode-mode megastep]``.

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
replay of a captured CUDA graph per pow2 bucket of ``--max-window``).  The
sharded backend, fault plans and throttling are not ported yet.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.core import resolve_device
from repro_torch.data.ycsb import zipfian
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
    return ap


def build(args) -> ServeEngine:
    """The engine the arguments describe, weights made on ``args.device``."""
    if args.kv_mode == "paged" and args.no_prefix_cache:
        raise ValueError("--kv-mode paged requires the prefix cache (the pool "
                         "is the resident prefix store)")
    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    model = make_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(args.seed))
    pool = pc = None
    if not args.no_prefix_cache:
        pool = PagedKVPool(cfg, n_pages=256, page_tokens=args.chunk_tokens,
                           device=device)
        pc = PrefixCache(num_sets=256, m=2, p=4, chunk_tokens=args.chunk_tokens,
                         device=device)
    return ServeEngine(model, params, slots=4, max_len=256, prefix_cache=pc,
                       pool=pool, decode_mode=args.decode_mode, kv_mode=args.kv_mode,
                       max_window=args.max_window)


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


def main(argv=None):
    args = parser().parse_args(argv)
    eng = build(args)
    t0 = time.time()
    for req in make_requests(eng.cfg, args):
        eng.submit(req)
    ticks = eng.run_until_done()
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    dt = time.time() - t0

    skipped = sum(r.prefill_skipped for r in eng.finished)
    computed = sum(r.prefill_computed for r in eng.finished)
    print(f"[serve] {len(eng.finished)} requests in {ticks} ticks, {dt:.1f}s "
          f"on {eng.device}")
    print(f"[serve] prefill tokens: computed={computed} skipped={skipped} "
          f"({skipped / (skipped + computed):.1%} saved)")
    st = eng.stats()
    print(f"[serve] decode: {st['decode_launches']} launches, "
          f"{st['decode_tokens']} tokens, "
          f"{st['launches_per_token']:.3f} rows/token, host_syncs="
          f"{st['host_syncs']}, admit wait p50/p99 "
          f"{st['service_ticks_p50']:.0f}/{st['service_ticks_p99']:.0f} ticks")
    if args.decode_mode == "megastep":
        print(f"[serve] megastep: {st['megastep_windows']} windows "
              f"(mean {st['mean_window']:.1f} ticks, cap {st['max_window']}), "
              f"host_syncs={st['host_syncs']} ({st['host_syncs_per_token']:.3f}/token), "
              f"drain rows/token={st['drain_launches_per_token']:.3f}")
    print(f"[serve] kv: mode={st['kv_mode']} gather_calls={st['gather_calls']} "
          f"resident_kv_peak={st['resident_kv_tokens_peak']} tok "
          f"({st['resident_kv_bytes_peak'] / 2**20:.1f} MiB)")
    if eng.prefix_cache is not None:
        print(f"[serve] prefix cache: {eng.prefix_cache.stats()}")


if __name__ == "__main__":
    main()
