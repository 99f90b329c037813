"""The benchmark of the PyTorch and CUDA port: one run of one cell.

    python3 mslbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the card(s) the cell
asks for.  The run makes its inputs (and weights) from ``--seed``, builds
and warms the system under test (``setup_s``), measures for ``--seconds``,
checks what the timed path produced against the plain reference under
``mslbench/reference/``, and prints as its last line one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics, read from a device
trace of part of the window), ``device``, ``breakdown`` (``--trace 1``)
and ``checks``, each compared number beside its limit.  A line before it
holds the counts and medians that are not metrics; the last lines on
standard error repeat the checks.

Everything a cell names is found by name: ``BENCHMARK.json`` gives the
cell's configuration (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``, which names its client, ``clients/<client>.py``)
and its metrics (``metrics/<metric>.py`` for each per-layer one).

The run exits non-zero and prints no result without a card (or with fewer
than the cell asks for), when the program cannot be imported, and when
JAX or the JAX package has been loaded into the process.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _paths() -> None:
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))


def _pin_caches() -> None:
    """Kernel and compiler caches at fixed paths inside the checkout, so
    that only the first run of a checkout builds."""
    cache = ROOT / ".mslbench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda"), ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels")):
        os.environ[var] = str(cache / sub)


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules (``sys.modules`` by default) whose top-level name is
    JAX's, its libraries' or the JAX package's (``repro_torch`` is not
    ``repro``: whole names only)."""
    names = sys.modules if modules is None else modules
    return sorted({name.split(".")[0] for name in names if name.split(".")[0] in FORBIDDEN})


def run_cell(cell, seed: int, seconds: float, trace: bool, device, control: bool = False):
    from mslbench.lib import spec
    from mslbench.lib.outcome import RunContext

    client = spec.client(cell.traffic["client"])
    return client.run(RunContext(cell=cell, seed=seed, seconds=seconds, trace=trace,
                                 device=device, control=control))


def result_line(cell, outcome, trace: bool, device_info: dict) -> dict:
    from mslbench.lib import spec

    metrics = {}
    if trace:
        if outcome.trace is None:
            raise RuntimeError("a traced run kept no trace")
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"]).read(outcome.trace)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": outcome.metrics[m["name"]], "unit": m["unit"]}
    device = dict(device_info, memory_peak_bytes=int(outcome.memory_peak_bytes))
    line = {"correct": outcome.correct, "attempted": int(outcome.attempted),
            "failed": int(outcome.failed), "metrics": metrics, "device": device}
    if trace:
        device.update(busy_s=outcome.trace.busy_s, window_s=outcome.trace.window_s)
        line["breakdown"] = outcome.trace.breakdown()
    line["checks"] = {c.name: c.record() for c in outcome.checks}
    return line


def _power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() or None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _paths()
    _pin_caches()
    from mslbench.lib import spec

    cell = spec.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"mslbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 3
    import repro_torch  # noqa: F401  (the program under test must be there)

    outcome = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda"))
    found = forbidden_modules()
    if found:
        print(f"mslbench: modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 4
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": cell.chips}
    line = result_line(cell, outcome, bool(args.trace), device_info)
    info = dict(outcome.info, card=_power_limit(), workload=args.workload, seed=args.seed)
    print(json.dumps({"info": info}))
    for c in outcome.checks:
        print(c.line(), file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
