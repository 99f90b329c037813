"""Quickstart: the multi-step LRU cache as a standalone key-value cache, in
the PyTorch port, on the card.

    python examples/torch_quickstart.py [--device cpu]

The port's counterpart of ``examples/quickstart.py``: the same cache, trace
and printed lines.  The batched call runs the one-pass engine, which on the
card launches the ``msl_onepass`` CUDA kernel.  ``main`` returns the numbers
it prints.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import numpy as np

from repro_torch.core import MSLRUConfig, MultiStepLRUCache
from repro_torch.data.ycsb import zipfian


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    # 4096 items: 512 sets x (M=2 vectors x P=4 lanes); 32-bit keys,
    # 64-bit values (2 planes) — the paper's pointer-cache shape.
    cfg = MSLRUConfig(num_sets=512, m=2, p=4, value_planes=2)
    cache = MultiStepLRUCache(cfg, engine="onepass", device=args.device)
    print(f"cache: {cfg.capacity} items = {cfg.num_sets} sets x M{cfg.m} x P{cfg.p}")

    # the paper's benchmark loop: get; on miss, put
    trace = zipfian(n_keys=50_000, n_queries=200_000, alpha=0.99, seed=1)
    vals = np.stack([trace, trace * 2], axis=1).astype(np.int32)

    res = cache.access(trace, vals)            # batched engine (exact)
    hits = res.hit.cpu().numpy()
    print(f"zipfian 200k queries over 50k keys -> hit ratio {hits.mean():.3f}")
    occupancy = cache.occupancy
    print(f"occupancy {occupancy:.2%}")

    # values come back on hits
    res2 = cache.access(trace[:10], vals[:10])
    got, hit2 = res2.value.cpu().numpy(), res2.hit.cpu().numpy()
    ok = bool((got[hit2, 0] == trace[:10][hit2]).all())
    print(f"value integrity on re-access: {'OK' if ok else 'FAIL'}")

    # evictions surface their victim (key AND value planes) — this is what
    # lets the serving stack recycle KV pages with zero extra metadata
    evictions = int(res.evicted_valid.sum())
    print(f"evictions reported this run: {evictions}")
    return {"capacity": cfg.capacity, "queries": len(trace), "hits": int(hits.sum()),
            "hit_ratio": float(hits.mean()), "occupancy": occupancy,
            "value_integrity": ok, "reaccess_hits": int(hit2.sum()), "evictions": evictions}


if __name__ == "__main__":
    main()
