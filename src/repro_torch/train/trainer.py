"""Training loop: step bundle, data, checkpoints.

Port of ``repro.train.trainer``: the same loop, history and log lines.  The
parameters and optimizer state live on ``device`` (default ``cuda``, which
raises without a card); a fresh state draws the weights from a
``torch.Generator`` seeded ``seed`` on that device (not ``jax.random``'s
numbers), a resumed one restores the latest checkpoint under ``ckpt_dir``,
which may be one the JAX ``Trainer`` wrote.
"""

from __future__ import annotations

import time
from pathlib import Path

import torch

from repro_torch.core import resolve_device
from repro_torch.launch.steps import StepBundle
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
        for _ in range(n_steps):
            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in data.batch(self.step).items()}
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
                self.async_ckpt.save(self.step, {"params": self.params, "opt": self.opt_state})
        if self.async_ckpt:
            self.async_ckpt.save(self.step, {"params": self.params, "opt": self.opt_state})
            self.async_ckpt.wait()
        return self.history
