"""Dry run: trace every (arch × shape) cell's step on the meta device and
write its roofline record for one H100.

Port of ``repro.launch.dryrun`` on one device.  The JAX dry run lowers and
compiles each cell on the production meshes of 256 and 512 chips and reads
the counts from the compiled HLO; the port runs one device (``chips = 1``)
and traces each step once on meta tensors (``configs.specs``: nothing is
allocated), counting its FLOPs, bytes and memory as it runs
(``roofline.counts``), then the three terms (``roofline.analysis``).  Train
cells use ``remat="full"`` and ``launch.steps.default_microbatches``;
``long_500k`` runs only where the arch ``supports_long``.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun                # all cells
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-1b --shape train_4k

Records go to ``results/dryrun_torch/`` as JSON, one per cell; a cell that
already has one is skipped unless ``--force``.  ``--multi-pod`` raises: the
port has no mesh of pods.  Exits 1 if a cell failed.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path

from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.launch.steps import bundle_for, default_microbatches
from repro_torch.roofline import analysis as roofline
from repro_torch.roofline.counts import count_step

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"

# train cells checkpoint every layer (recompute in backward), as the JAX
# dry run's; serve cells never remat.
TRAIN_REMAT = "full"


def cell_id(arch: str, shape: str) -> str:
    return f"{arch}__{shape}__1dev"


def applicable(cfg: ArchConfig, shape_name: str) -> bool:
    return not (shape_name == "long_500k" and not cfg.supports_long)


def analyze_cell(cfg: ArchConfig, shape: ShapeSpec, *,
                 microbatches: int | None = None) -> dict:
    """Trace one cell's step on the meta device and return its roofline
    record (train cells: ``cfg`` with ``TRAIN_REMAT``; ``microbatches``
    defaults to ``default_microbatches``)."""
    train = shape.kind == "train"
    if train:
        cfg = dataclasses.replace(cfg, remat=TRAIN_REMAT)
        microbatches = microbatches or default_microbatches(cfg)
    t0 = time.perf_counter()
    bundle = bundle_for(cfg, shape, microbatches=microbatches)
    args = bundle.abstract_args
    counts = count_step(bundle.fn, args, params=args[0], opt_state=args[1] if train else None,
                        microbatches=microbatches or 1)
    rec = roofline.analyze(counts, chips=1,
                           model_flops_total=roofline.model_flops_for(cfg, shape))
    rec.update({"trace_s": time.perf_counter() - t0, "ops": counts["ops"],
                "remat": cfg.remat, "microbatches": microbatches,
                "batch": shape.global_batch, "seq_len": shape.seq_len,
                "params": cfg.param_count(), "active_params": cfg.active_param_count()})
    return rec


def run_cell(arch: str, shape_name: str, out_dir: Path, force: bool = False) -> dict:
    out_path = out_dir / (cell_id(arch, shape_name) + ".json")
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())
    cfg = get_config(arch)
    if not applicable(cfg, shape_name):
        rec = {"cell": cell_id(arch, shape_name), "skipped": True,
               "reason": cfg.long_skip_reason}
    else:
        rec = analyze_cell(cfg, SHAPES[shape_name])
        rec.update({"cell": cell_id(arch, shape_name), "arch": arch, "shape": shape_name,
                    "multi_pod": False, "skipped": False})
    out_path.write_text(json.dumps(rec, indent=1))
    return rec


def summary(rec: dict) -> str:
    t = rec["terms_seconds"]
    m = rec["memory"]
    return (f"terms: compute={t['compute'] * 1e3:.2f}ms memory={t['memory'] * 1e3:.2f}ms "
            f"collective={t['collective'] * 1e3:.2f}ms dominant={rec['dominant']} "
            f"roofline_frac={rec['roofline_fraction']:.3f} "
            f"memory={m['total_bytes'] / 1e9:.1f}GB of {m['device_bytes'] / 1e9:.0f}")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="one arch id (default: all)")
    ap.add_argument("--shape", default=None, help="one shape (default: all)")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=str(RESULTS_DIR))
    ap.add_argument("--multi-pod", action="store_true",
                    help="the JAX dry run's mesh of TPU pods; not ported")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    if args.multi_pod:
        raise NotImplementedError("--multi-pod: the port runs one device, "
                                  "with no mesh of pods")
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    archs = [args.arch] if args.arch else list_archs()
    shapes = [args.shape] if args.shape else list(SHAPES)

    failures = []
    for arch in archs:
        for shape_name in shapes:
            try:
                rec = run_cell(arch, shape_name, out_dir, force=args.force)
                if rec.get("skipped"):
                    print(f"[{rec['cell']}] SKIP: {rec.get('reason', '')}")
                else:
                    print(f"[{rec['cell']}] {summary(rec)} ({rec['trace_s']:.1f} s)",
                          flush=True)
            except Exception as e:  # noqa: BLE001 - a cell's failure is reported, the rest run
                failures.append((arch, shape_name, repr(e)))
                print(f"[{cell_id(arch, shape_name)}] FAILED: {e}")
                traceback.print_exc()

    print(f"\n{'=' * 70}\ndry-run complete; failures: {len(failures)}")
    for f in failures:
        print("  FAIL:", f)
    if failures:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
