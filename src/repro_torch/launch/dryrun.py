"""Dry run: every (arch × shape) cell's step on the meta device, as a
roofline record for one H100, or per device on a production mesh.

Port of ``repro.launch.dryrun``.  The JAX dry run lowers and compiles each
cell on the production meshes of 256 and 512 chips and reads the counts
from the compiled HLO.  The port has two kinds of record:

* one device (the default, ``__1dev``): each step traced once on meta
  tensors (``configs.specs``: nothing is allocated), its FLOPs, bytes and
  memory counted as it runs (``roofline.counts``), then the three terms
  (``roofline.analysis``).  Train cells use ``remat="full"`` and
  ``launch.steps.default_microbatches``.
* ``--mesh pod1`` or ``pod2`` (the JAX cells ``__pod1``/``__pod2``; 256 or
  512 chips; ``--multi-pod`` is ``--mesh pod2``): the cell's sharded step
  (``launch.steps.bundle_for`` on the mesh) traced on meta DTensors over a
  process group of 256 or 512 ranks in this process that moves nothing
  (``launch.mesh.fake_mesh``), counted per device (rank 0's shards): FLOPs,
  bytes, the peak of what the step makes beside its inputs
  (``activation_bytes``: activations, gradients, temporaries), and the
  collectives' result bytes by kind; then the three terms, the collective
  one over one 400 Gb/s link per GPU.  Beside them, the bytes per device of
  the state the step's inputs and outputs hold under the sharding rules:
  the parameters, AdamW's f32 master, m and v (train), the batch, and the
  KV or recurrent cache (prefill and decode), and whether that state alone
  fits the card.

``long_500k`` runs only where the arch ``supports_long``.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun                # all cells
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-1b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh pod2

Records go to ``results/dryrun_torch/`` as JSON, one per cell; a cell that
already has one is skipped unless ``--force``.  Exits 1 if a cell failed.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.configs import specs
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import (MeshShape, axis_sizes, batch_axes, fake_mesh,
                                    make_production_mesh)
from repro_torch.launch.steps import bundle_for, default_microbatches
from repro_torch.models.model import make_model
from repro_torch.roofline import analysis as roofline
from repro_torch.roofline.counts import count_step

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"

# train cells checkpoint every layer (recompute in backward), as the JAX
# dry run's; serve cells never remat.
TRAIN_REMAT = "full"


# the production meshes by record name: multi_pod for make_production_mesh
MESHES = {"pod1": False, "pod2": True}


def cell_id(arch: str, shape: str, mesh: str | None = None) -> str:
    return f"{arch}__{shape}__{mesh or '1dev'}"


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


def _bytes_per_device(mesh, t, spec) -> int:
    """Bytes of ``t``'s shard on one device under ``spec`` (the rules shard
    only dims their axes divide)."""
    sizes = axis_sizes(mesh)
    n = 1
    for e in spec:
        for a in (e if isinstance(e, tuple) else (e,) if e else ()):
            n *= sizes[a]
    return t.numel() * t.element_size() // n


def _mesh_shape(mesh) -> MeshShape:
    """A production mesh by record name ("pod1", "pod2"), or a ``MeshShape``."""
    return mesh if isinstance(mesh, MeshShape) else make_production_mesh(
        multi_pod=MESHES[mesh])


def mesh_state_cell(cfg: ArchConfig, shape: ShapeSpec, mesh_name) -> dict:
    """The state record of one cell on the production mesh ``mesh_name`` (or
    a ``MeshShape``): per device, the parameters, the optimizer state
    (train: f32 master, m and v of each parameter, and the step counter),
    the batch (decode: the tokens and ``cur_len``) and the cache (prefill's
    output and decode's input, ``init_cache``'s shapes).  The step's own
    counts are ``mesh_cell``'s."""
    mesh = _mesh_shape(mesh_name)
    model = make_model(cfg)
    b = shape.global_batch
    leaves = list(shd.tree_key_paths(specs.abstract_params(model)))
    param_bytes = sum(_bytes_per_device(mesh, p, shd.param_spec(cfg, mesh, path, p))
                      for path, p in leaves)
    dev = {"param_bytes": param_bytes, "optimizer_bytes": 0, "batch_bytes": 0,
           "cache_bytes": 0}
    if shape.kind == "train":
        elems = sum(_bytes_per_device(mesh, p, shd.param_spec(cfg, mesh, path, p))
                    // p.element_size() for path, p in leaves)
        dev["optimizer_bytes"] = 3 * 4 * elems + 4
    if shape.kind == "decode":
        tokens = specs.sds((b, 1), torch.int32)
        dev["batch_bytes"] = _bytes_per_device(
            mesh, tokens, (shd._if_div(mesh, batch_axes(mesh), b), None)) + 4
    else:
        batch = (specs.train_batch_specs if shape.kind == "train"
                 else specs.prefill_batch_specs)(cfg, shape)
        spec = shd.batch_shardings(cfg, mesh, batch, b)
        dev["batch_bytes"] = sum(_bytes_per_device(mesh, t, spec[k]) for k, t in batch.items())
    if shape.kind != "train":
        cache = model.init_cache(b, shape.seq_len, device=specs.META)
        cspec = shd.cache_shardings(cfg, mesh, cache, b)

        def walk(t, sp):
            if isinstance(t, dict):
                return sum(walk(t[k], sp[k]) for k in t)
            return _bytes_per_device(mesh, t, sp)

        dev["cache_bytes"] = walk(cache, cspec)
    dev["state_bytes"] = sum(dev.values())
    return {"mesh": mesh_name if isinstance(mesh_name, str) else repr(mesh),
            "mesh_shape": dict(mesh.shape), "chips": mesh.size,
            "per_device": dev, "device_bytes": roofline.HBM_BYTES,
            "state_fits": dev["state_bytes"] <= roofline.HBM_BYTES,
            "model_flops": roofline.model_flops_for(cfg, shape),
            "batch": b, "seq_len": shape.seq_len,
            "params": cfg.param_count(), "active_params": cfg.active_param_count()}


def gathered_over_model(cfg: ArchConfig, shape: ShapeSpec, mesh_name) -> list:
    """The regions of the cell's step that run on each rank's rows with a
    dim whole that 'model' shards (``layers.rows_local``,
    ``attention.per_head``), so gather over 'model' what GSPMD could leave
    sharded or pad: where there is one, the record's collective term is an
    upper bound."""
    tp = axis_sizes(_mesh_shape(mesh_name)).get("model", 1)
    if tp == 1:
        return []
    out = []
    if cfg.mixer == "xlstm":
        out.append("xLSTM's mLSTM and sLSTM run on each rank's rows (layers.rows_local): "
                   f"their inputs are gathered over 'model' ({cfg.n_heads} heads over {tp})")
    if cfg.mixer == "hymba" and shape.kind != "decode":
        out.append("the Mamba scan runs on each rank's rows (layers.rows_local): its inputs "
                   "are gathered over 'model'")
    if cfg.ffn == "moe" and shape.kind != "decode" and not shd.moe_experts_replicated(cfg):
        out.append("the MoE combine runs on each rank's rows (layers.rows_local): the "
                   "expert outputs are gathered over 'model'")
    if cfg.mixer != "xlstm" and (cfg.n_heads % tp or cfg.n_kv_heads % tp):
        out.append("attention.per_head gathers q, k and v over 'model' (heads "
                   f"{cfg.n_heads}/{cfg.n_kv_heads} over {tp})"
                   + ("; the decode cache is split over the sequence" if shape.kind == "decode"
                      else ""))
    return out


def mesh_cell(cfg: ArchConfig, shape: ShapeSpec, mesh_name, *,
              microbatches: int | None = None) -> dict:
    """One cell on the production mesh ``mesh_name`` (or a ``MeshShape``):
    ``mesh_state_cell``'s state record, and the sharded step traced on a
    ``fake_mesh`` of that shape and counted per device: FLOPs, bytes,
    ``activation_bytes`` (the peak of what the step makes), the collectives'
    result bytes by kind, the three terms, the dominant one and the
    roofline fraction (train cells: ``TRAIN_REMAT``; ``microbatches``
    defaults to ``default_microbatches``)."""
    rec = mesh_state_cell(cfg, shape, mesh_name)
    train = shape.kind == "train"
    if train:
        cfg = dataclasses.replace(cfg, remat=TRAIN_REMAT)
        microbatches = microbatches or default_microbatches(cfg)
    t0 = time.perf_counter()
    with fake_mesh(_mesh_shape(mesh_name)) as mesh:
        bundle = bundle_for(cfg, shape, mesh=mesh, microbatches=microbatches)
        args = bundle.abstract_args
        counts = count_step(bundle.fn, args, params=args[0],
                            opt_state=args[1] if train else None,
                            microbatches=microbatches or 1)
    terms = roofline.analyze(counts, chips=rec["chips"], model_flops_total=rec["model_flops"])
    rec["per_device"].update({"activation_bytes": counts["memory"]["peak_live_bytes"],
                              "flops": counts["flops"], "bytes": counts["bytes"],
                              "collective_bytes": counts["collective_bytes"]})
    rec.update({k: terms[k] for k in ("totals", "collectives", "terms_seconds", "dominant",
                                      "useful_flop_ratio", "roofline_fraction", "memory")})
    rec.update({"fits": counts["memory"]["fits"], "trace_s": time.perf_counter() - t0,
                "ops": counts["ops"], "remat": cfg.remat, "microbatches": microbatches})
    upper = gathered_over_model(cfg, shape, mesh_name)
    if upper:
        rec["collective_upper_bound"] = upper
    return rec


def run_cell(arch: str, shape_name: str, out_dir: Path, force: bool = False,
             mesh: str | None = None) -> dict:
    """One cell's record: the one-device trace, or with ``mesh`` ("pod1",
    "pod2") the sharded step's per device on that production mesh."""
    out_path = out_dir / (cell_id(arch, shape_name, mesh) + ".json")
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())
    cfg = get_config(arch)
    if not applicable(cfg, shape_name):
        rec = {"cell": cell_id(arch, shape_name, mesh), "skipped": True,
               "reason": cfg.long_skip_reason}
    else:
        rec = (analyze_cell(cfg, SHAPES[shape_name]) if mesh is None
               else mesh_cell(cfg, SHAPES[shape_name], mesh))
        rec.update({"cell": cell_id(arch, shape_name, mesh), "arch": arch,
                    "shape": shape_name, "multi_pod": mesh == "pod2", "skipped": False})
    out_path.write_text(json.dumps(rec, indent=1))
    return rec


def summary(rec: dict) -> str:
    t = rec["terms_seconds"]
    if rec.get("mesh"):
        d = rec["per_device"]
        coll = ", ".join(f"{k} {v / 1e9:.3f}" for k, v in rec["collectives"].items()
                         if not k.startswith("_") and v)
        return (f"{rec['mesh']} ({rec['chips']} chips), per device: params "
                f"{d['param_bytes'] / 1e9:.3f}GB optimizer {d['optimizer_bytes'] / 1e9:.3f}GB "
                f"batch {d['batch_bytes'] / 1e9:.4f}GB cache {d['cache_bytes'] / 1e9:.3f}GB "
                f"state {d['state_bytes'] / 1e9:.3f}GB, activations "
                f"{d['activation_bytes'] / 1e9:.3f}GB of {rec['device_bytes'] / 1e9:.0f} "
                f"(fits: {rec['fits']}); {d['flops'] / 1e12:.3f} TFLOP, "
                f"{d['bytes'] / 1e9:.2f} GB, collectives {coll or 'none'} GB; terms: "
                f"compute={t['compute'] * 1e3:.2f}ms memory={t['memory'] * 1e3:.2f}ms "
                f"collective={t['collective'] * 1e3:.2f}ms dominant={rec['dominant']} "
                f"roofline_frac={rec['roofline_fraction']:.3f}")
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
    ap.add_argument("--mesh", choices=sorted(MESHES), default=None,
                    help="the sharded step per device on a production mesh (default: one "
                         "device)")
    ap.add_argument("--multi-pod", action="store_true", help="the same as --mesh pod2")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    mesh = "pod2" if args.multi_pod else args.mesh
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    archs = [args.arch] if args.arch else list_archs()
    shapes = [args.shape] if args.shape else list(SHAPES)

    failures = []
    for arch in archs:
        for shape_name in shapes:
            try:
                rec = run_cell(arch, shape_name, out_dir, force=args.force, mesh=mesh)
                if rec.get("skipped"):
                    print(f"[{rec['cell']}] SKIP: {rec.get('reason', '')}")
                else:
                    print(f"[{rec['cell']}] {summary(rec)}"
                          + (f" ({rec['trace_s']:.1f} s)" if "trace_s" in rec else ""),
                          flush=True)
            except Exception as e:  # noqa: BLE001 - a cell's failure is reported, the rest run
                failures.append((arch, shape_name, repr(e)))
                print(f"[{cell_id(arch, shape_name, mesh)}] FAILED: {e}")
                traceback.print_exc()

    print(f"\n{'=' * 70}\ndry-run complete; failures: {len(failures)}")
    for f in failures:
        print("  FAIL:", f)
    if failures:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
