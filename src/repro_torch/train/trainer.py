"""Training loop: step bundle, data, checkpoints.

Port of ``repro.train.trainer``: the same loop, history and log lines.  The
parameters and optimizer state live on ``device`` (default ``cuda``, which
raises without a card); a fresh state draws the weights from a
``torch.Generator`` seeded ``seed`` on that device (not ``jax.random``'s
numbers), a resumed one restores the latest checkpoint under ``ckpt_dir``,
which may be one the JAX ``Trainer`` wrote.

With a bundle built on a mesh (``bundle.mesh``), every rank draws the same
weights and keeps its block of each (``launch.steps.place_params``); each
step's batch is the data's global batch, of which the rank takes its rows
(``launch.sharding.local_batch``).  Checkpoints hold full tensors, written
by rank 0; the ranks meet at a barrier once the last save is written, so
any of them may restore at once.
"""

from __future__ import annotations

import time
from pathlib import Path

import torch

from repro_torch.core import resolve_device
from repro_torch.launch.sharding import local_batch
from repro_torch.launch.steps import StepBundle, place_params
from repro_torch.train import checkpoint as ckpt_mod
from repro_torch.train import optimizer as opt_mod


class Trainer:
    def __init__(self, model, bundle: StepBundle, *, ckpt_dir: str | None = None,
                 ckpt_every: int = 100, seed: int = 0, device="cuda"):
        self.model = model
        self.bundle = bundle
        self.device = resolve_device(device)
        self.ckpt_dir = Path(ckpt_dir) if ckpt_dir else None
        self.ckpt_every = ckpt_every
        self.async_ckpt = (ckpt_mod.AsyncCheckpointer(self.ckpt_dir)
                           if self.ckpt_dir else None)
        self.seed = seed
        self.step = 0
        self.params = None
        self.opt_state = None
        self.history: list[dict] = []

    def init_state(self, resume: bool = True) -> str:
        """"resumed" (from the latest checkpoint) or "fresh"."""
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self.params = self.model.init(gen)
        if self.bundle.mesh is not None:
            self.params = place_params(self.model.cfg, self.bundle.mesh, self.params)
        self.params.requires_grad_(True)
        self.opt_state = opt_mod.adamw_init(self.params)
        if resume and self.ckpt_dir and ckpt_mod.latest_step(self.ckpt_dir) is not None:
            _, self.step = ckpt_mod.restore(self.ckpt_dir,
                                            {"params": self.params, "opt": self.opt_state})
            return "resumed"
        return "fresh"

    def run(self, data, n_steps: int, log_every: int = 10):
        """``n_steps`` steps on ``data.batch(step)``; every ``log_every``-th
        step (and the first) logs its metrics (one host sync) into
        ``history``; a checkpoint every ``ckpt_every`` steps and at the end."""
        t_last = time.time()
        mesh = self.bundle.mesh
        for _ in range(n_steps):
            batch = data.batch(self.step)
            if mesh is not None:
                batch = local_batch(mesh, batch, len(batch["tokens"]))
            batch = {k: torch.from_numpy(v).to(self.device) for k, v in batch.items()}
            self.params, self.opt_state, metrics = self.bundle.fn(
                self.params, self.opt_state, batch)
            self.step += 1
            if self.step % log_every == 0 or self.step == 1:
                m = {k: float(v) for k, v in metrics.items()}
                dt = time.time() - t_last
                t_last = time.time()
                m.update(step=self.step, sec_per_step=dt / log_every)
                self.history.append(m)
                print(f"step {self.step:5d} loss={m['loss']:.4f} "
                      f"gnorm={m['grad_norm']:.3f} lr={m['lr']:.2e}")
            if self.async_ckpt and self.step % self.ckpt_every == 0:
                self._save()
        if self.async_ckpt:
            self._save()
            self.async_ckpt.wait()
            if mesh is not None:
                import torch.distributed as dist

                dist.barrier()
        return self.history

    def _save(self):
        self.async_ckpt.save(self.step, {"params": self.params, "opt": self.opt_state})
