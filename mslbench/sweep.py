"""The knee sweep of an open-loop serve cell, outside the benchmark's runs.

    python3 mslbench/sweep.py --workload <cell> --seconds <s> --seed <n> --rates <r> [<r> ...]

Runs the cell once per offered rate (requests/s) in this process and prints
one JSON line per rate: requests due, finished, with a first token, the
queue at the window's half and end, and the latency tails.  The knee is the
highest rate whose queue does not grow over the window; a mix offered
below it reports its latency tails, one offered above it what it
completes.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parent.parent / "src"),
                str(Path(__file__).resolve().parent.parent)]

from mslbench.run import _pin_caches, run_cell  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    _pin_caches()
    import torch

    from mslbench.lib import spec

    if not torch.cuda.is_available():
        print("mslbench sweep: needs a CUDA device", file=sys.stderr)
        return 3
    base = spec.cell(args.workload)
    for rate in args.rates:
        cell = copy.deepcopy(base)
        cell.traffic["rate_per_s"] = rate
        out = run_cell(cell, args.seed, args.seconds, False, torch.device("cuda"))
        print(json.dumps({"rate_per_s": rate, "metrics": out.metrics, "info": out.info,
                          "correct": out.correct}), flush=True)
        del out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
