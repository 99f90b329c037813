"""Readings for the limits of a cell's check, outside the benchmark's runs.

    python3 mslbench/control.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]

Runs the cell once per seed in this one process (each seed makes its own
inputs and weights) with the control switched on: the cache cell serves
through the reference's ``UnorderedCache`` in the program's place; the
serve cell serves through the program and judges, on the same sampled
requests, the float8 control's first choices in the served tokens' place
(``checks``), with the program's own gap beside them (``info``).  Prints
one JSON line per seed with every compared number and whether the run
came out correct.  Needs the card(s)
the cell asks for.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parent.parent / "src"),
                str(Path(__file__).resolve().parent.parent)]

from mslbench.run import _pin_caches, forbidden_modules, run_cell  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    _pin_caches()
    import torch

    from mslbench.lib import spec

    if not torch.cuda.is_available():
        print("mslbench control: needs a CUDA device", file=sys.stderr)
        return 3
    cell = spec.cell(args.workload)
    for seed in args.seeds:
        out = run_cell(cell, seed, args.seconds, False, torch.device("cuda"), control=True)
        print(json.dumps({"seed": seed, "correct": out.correct,
                          "checks": {c.name: c.record() for c in out.checks},
                          "info": out.info, "metrics": out.metrics}), flush=True)
        del out
        torch.cuda.empty_cache()
    if forbidden_modules():
        print(f"loaded: {forbidden_modules()}", file=sys.stderr)
        return 4
    return 0


if __name__ == "__main__":
    sys.exit(main())
