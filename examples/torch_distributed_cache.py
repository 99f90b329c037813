"""The memcached analogue: a key-value cache sharded 8 ways, bit-exact with
the single-device oracle, in the PyTorch port, on the card.

    python examples/torch_distributed_cache.py [--device cpu]

The port's counterpart of ``examples/distributed_cache.py``: the same cache,
shards, cap, trace and printed lines.  The JAX example spreads its 8 shards
over 8 devices with an all_to_all route; here the 8 are logical shards on
one device (``launch.mesh.CacheMesh``), whose engine places each query as
the route would (sheds included) and runs one update, on the card through
the ``msl_onepass`` CUDA kernel.  The sequential oracle (``access_seq``,
one query at a time, in order) runs on the same device: on the card one
launch of the ``msl_seq`` kernel walks the whole trace.  ``main`` returns
the numbers it prints.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import numpy as np
import torch

from repro_torch.core import MSLRUConfig, MultiStepLRUCache, init_table, resolve_device
from repro_torch.core.sharded import make_sharded_engine, shard_table
from repro_torch.data.ycsb import zipfian
from repro_torch.launch.mesh import make_cache_mesh


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    mesh = make_cache_mesh(8, device)
    cfg = MSLRUConfig(num_sets=4096, m=2, p=4, value_planes=1)
    print(f"sharded cache: {cfg.capacity} items over {mesh.shape['cache']} "
          f"shards ({cfg.num_sets // 8} sets/shard)")

    engine = make_sharded_engine(cfg, mesh, cap=2048, engine="onepass")
    table = shard_table(init_table(cfg, device), mesh)

    trace = zipfian(100_000, 65536, alpha=0.99, seed=5)
    vals = trace[:, None].astype(np.int32)
    hits = served = 0
    for i in range(0, len(trace), 8192):
        table, hit, val, srv = engine(
            table, torch.as_tensor(trace[i:i + 8192, None], device=device).to(torch.int32),
            torch.as_tensor(vals[i:i + 8192], device=device))
        hits += int(hit.sum())
        served += int(srv.sum())
    print(f"sharded: hits={hits} served={served}/{len(trace)} "
          f"(overflow={(1 - served / len(trace)):.2%})")

    ref = MultiStepLRUCache(cfg, device=device)
    out = ref.access_seq(trace, vals=vals)
    oracle_hits = int(out.hit.sum())
    print(f"single-device oracle hits: {oracle_hits}")
    same = bool(torch.equal(table[:cfg.num_sets], ref.table))
    print(f"final table state identical: {'YES' if same else 'NO'}")
    return {"capacity": cfg.capacity, "shards": mesh.shape["cache"], "queries": len(trace),
            "hits": hits, "served": served, "oracle_hits": oracle_hits,
            "table_identical": same}


if __name__ == "__main__":
    main()
