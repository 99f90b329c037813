"""Training entry point: ``python -m repro_torch.launch.train --arch <id> [--smoke]
[--multi-pod] [--device cpu]``.

Port of ``repro.launch.train``, with its flags and its log lines.
``--device`` (default ``cuda``; ``--device cpu`` trains on the CPU).
``--smoke`` trains the reduced config at 128 tokens x 4 rows on JAX's
``make_debug_mesh((1, 1))``: a (1, 1) ``DeviceMesh`` inside a process group
of one rank, one device outside any.  Without it, the published widths and
depth at ``train_4k``'s 4096 x 256 unless ``--seq-len``/``--global-batch``
say otherwise, on the production mesh, as the JAX launcher trains: inside a
process group of 256 ranks, the (16, 16) mesh; with ``--multi-pod``, a group
of 512 ranks and the (2, 16, 16) mesh.  A process group of another size, or
``--multi-pod`` outside one, raises a ``ValueError`` naming the ranks it
needs: the launcher never trains on one device in place of a mesh.  A launch
outside any process group (and without ``--multi-pod``) trains on one
device.  Checkpoint and restart: rerunning with the same ``--ckpt-dir``
resumes (the directory may be one the JAX launcher wrote, or a run on
another mesh: checkpoints hold full tensors).

The data is ``SyntheticLM``.  Whisper's batches also carry frames (B,
enc_len, d_model) drawn from the step in place of the stubbed frontend
(``WithFrames``), as the serve launcher draws a request's frames; the JAX
launcher's batches have none, and its Whisper training stops there.

``build(args)`` returns the trainer and the data, so that other scripts
(the repository's ``chip_smoke.py``) run exactly this path, on a mesh of
their own when they pass one; ``build_train_smoke`` is the run of
``examples/train_smoke.py``.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import SHAPES, ShapeSpec, get_config, list_archs
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.launch.mesh import MeshShape, make_debug_mesh, make_production_mesh
from repro_torch.launch.steps import build_train_step
from repro_torch.models.model import make_model
from repro_torch.train.trainer import Trainer


class WithFrames:
    """``data``'s batches plus ``"frames"`` (B, enc_len, d_model) f32,
    standard normal from a generator seeded (0, step): the same frames for
    the same step (the model casts them to bf16)."""

    def __init__(self, data, cfg):
        self.data, self.cfg = data, cfg

    def batch(self, step: int) -> dict:
        b = self.data.batch(step)
        rng = np.random.default_rng((0, step))
        b["frames"] = rng.standard_normal(
            (len(b["tokens"]), self.cfg.enc_len, self.cfg.d_model), np.float32)
        return b


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config at 128 x 4 (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=None)
    ap.add_argument("--global-batch", type=int, default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--multi-pod", action="store_true",
                    help="train on the (2, 16, 16) mesh of 512 ranks (in a process "
                         "group of that size)")
    ap.add_argument("--device", default="cuda")
    return ap


def _data(cfg, shape: ShapeSpec):
    data = SyntheticLM(cfg.vocab_size, shape.seq_len, shape.global_batch, n_hosts=1)
    return WithFrames(data, cfg) if cfg.enc_dec else data


def launch_mesh(args):
    """The mesh the arguments train on: a ``DeviceMesh``, or None for one
    device (see the module docstring)."""
    import torch.distributed as dist

    device_type = torch.device(args.device).type
    in_group = dist.is_available() and dist.is_initialized()
    if args.smoke:
        mesh = make_debug_mesh((1, 1), device_type=device_type)
        return None if isinstance(mesh, MeshShape) else mesh
    if not (args.multi_pod or in_group):
        return None
    mesh = make_production_mesh(multi_pod=args.multi_pod, device_type=device_type)
    if isinstance(mesh, MeshShape):
        what = "--multi-pod trains" if args.multi_pod else "a run in a process group trains"
        here = (f"this process group has {dist.get_world_size()}" if in_group
                else "this process is in no process group")
        raise ValueError(f"{what} on the {tuple(mesh.shape.values())} mesh: it needs a "
                         f"process group of {mesh.size} ranks; {here}")
    return mesh


def build(args, cfg=None, mesh=None):
    """(the Trainer, the data) the arguments describe; ``cfg`` replaces the
    arch's config (a depth cut or another ``remat``), ``mesh`` (a
    ``DeviceMesh``) the mesh the arguments give."""
    mesh = mesh if mesh is not None else launch_mesh(args)
    cfg = cfg or get_config(args.arch, smoke=args.smoke)
    model = make_model(cfg)
    if args.smoke:
        shape = ShapeSpec("smoke", args.seq_len or 128, args.global_batch or 4, "train")
    else:
        base = SHAPES["train_4k"]
        shape = ShapeSpec("train", args.seq_len or base.seq_len,
                          args.global_batch or base.global_batch, "train")
    bundle = build_train_step(model, shape, mesh=mesh, lr=args.lr,
                              microbatches=args.microbatches, total_steps=args.steps)
    trainer = Trainer(model, bundle, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                      device=args.device)
    return trainer, _data(cfg, shape)


def train_smoke_config():
    """``examples/train_smoke.py``'s model: gemma3-smoke widened to 4
    layers, d_model 256, 4 heads of 64 on one KV head, d_ff 1024, vocab
    2048, windows (32, 32, 0)."""
    return dataclasses.replace(
        get_config("gemma3-1b", smoke=True), n_layers=4, d_model=256, n_heads=4,
        d_head=64, d_ff=1024, vocab_size=2048, window_pattern=(32, 32, 0),
        loss_chunk=64, attn_chunk=64)


def build_train_smoke(steps: int = 300, *, ckpt_dir=None, device="cuda"):
    """(the Trainer, the data) of ``examples/train_smoke.py``'s run: 128 x 8,
    lr 3e-3, warm-up 20, cosine to ``steps``, 2 microbatches, a checkpoint
    every 100 steps under ``ckpt_dir``.  The example counts it learned when
    the last logged loss (log_every 20) is 0.3 below the first."""
    cfg = train_smoke_config()
    shape = ShapeSpec("smoke", 128, 8, "train")
    model = make_model(cfg)
    bundle = build_train_step(model, shape, lr=3e-3, warmup=20, total_steps=steps,
                              microbatches=2)
    trainer = Trainer(model, bundle, ckpt_dir=ckpt_dir, ckpt_every=100, device=device)
    return trainer, _data(cfg, shape)


def main(argv=None):
    args = parser().parse_args(argv)
    trainer, data = build(args)
    mode = trainer.init_state(resume=True)
    cfg = trainer.model.cfg
    mesh = trainer.bundle.mesh
    print(f"[train] arch={cfg.name} params={cfg.param_count():,} "
          f"state={mode} start_step={trainer.step} device={trainer.device}"
          + (f" mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))}" if mesh is not None
             else ""))
    trainer.run(data, args.steps)
    print("[train] done; final loss:",
          trainer.history[-1]["loss"] if trainer.history else None)


if __name__ == "__main__":
    main()
