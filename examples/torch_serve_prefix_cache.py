"""Serving with multi-step-LRU prefix caching: batched requests sharing
prompt templates, in the PyTorch port, on the card.

    python examples/torch_serve_prefix_cache.py [--device cpu]

The port's counterpart of ``examples/serve_prefix_cache.py``: the same model
config, requests, prefix cache, pool and printed lines, with and without
the cache.  With it, the engine keeps the KV in the pool's pages
(``kv_mode="paged"``): each tick's admission is one ``msl_onepass`` launch
on the card and each decode step reads the pages through the
``paged_attn`` CUDA kernel; the contiguous engine of the JAX example gives
the same prefill counts and cache stats.  The parameters are the port's
seeded init (the integer results do not depend on them).  ``main`` returns
the numbers it prints.
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import resolve_device
from repro_torch.data.ycsb import zipfian
from repro_torch.models.model import make_model
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.serving.kv_cache import PagedKVPool
from repro_torch.serving.prefix_cache import PrefixCache


def run(with_cache: bool, requests, model, params, cfg, device):
    pool = pc = None
    if with_cache:
        pool = PagedKVPool(cfg, n_pages=256, page_tokens=16, device=device)
        pc = PrefixCache(num_sets=256, m=2, p=4, chunk_tokens=16, device=device)
    eng = ServeEngine(model, params, slots=4, max_len=256, prefix_cache=pc, pool=pool,
                      kv_mode="paged" if with_cache else "contiguous")
    for r in requests:
        eng.submit(Request(rid=r.rid, prompt=r.prompt, max_new_tokens=r.max_new_tokens))
    t0 = time.time()
    eng.run_until_done()
    dt = time.time() - t0
    skipped = sum(r.prefill_skipped for r in eng.finished)
    computed = sum(r.prefill_computed for r in eng.finished)
    return eng, dt, skipped, computed


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config("phi3-mini-3.8b", smoke=True)
    model = make_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0))

    rng = np.random.default_rng(0)
    templates = [rng.integers(1, cfg.vocab_size, 64).astype(np.int32)
                 for _ in range(8)]
    picks = zipfian(8, 24, alpha=1.0, seed=1) - 1
    requests = []
    for i in range(24):
        suffix = rng.integers(1, cfg.vocab_size, 4 + i % 11).astype(np.int32)
        prompt = np.concatenate([templates[int(picks[i]) % 8], suffix])
        requests.append(Request(rid=i, prompt=prompt, max_new_tokens=6))

    eng, dt, skipped, computed = run(True, requests, model, params, cfg, device)
    stats = eng.prefix_cache.stats()
    print(f"[with prefix cache] {dt:.1f}s; prefill computed={computed} "
          f"skipped={skipped} ({skipped/(computed+skipped):.1%} saved)")
    print(f"  cache stats: {stats}")

    eng0, dt0, _, computed0 = run(False, requests, model, params, cfg, device)
    print(f"[without]           {dt0:.1f}s; prefill computed={computed0}")
    return {"requests": len(requests), "served": len(eng.finished),
            "served_without": len(eng0.finished),
            "tokens": sum(len(r.out_tokens) for r in eng.finished),
            "tokens_without": sum(len(r.out_tokens) for r in eng0.finished),
            "prefill_computed": computed, "prefill_skipped": skipped,
            "prefill_computed_without": computed0, "cache_stats": stats,
            "seconds": dt, "seconds_without": dt0}


if __name__ == "__main__":
    main()
