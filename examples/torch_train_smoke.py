"""End-to-end training driver in the PyTorch port: a ~5M-parameter
gemma3-family model, a few hundred steps, on the card.

    python examples/torch_train_smoke.py [--steps 300] [--ckpt-dir D] [--device cpu]

The port's counterpart of ``examples/train_smoke.py``, through
``launch.train.build_train_smoke``: the same config (4 layers, d 256,
vocab 2048, windows 32/32/global), 128 x 8 batches of ``SyntheticLM``, the
train step with 2 microbatches, lr 3e-3 with 20 warm-up steps, a checkpoint
every 100 steps; it resumes from the latest checkpoint under ``--ckpt-dir``
as the JAX example does.  The loss must drop by 0.3 from the first logged
step to the last.  ``main`` returns the numbers it prints and the logged
history.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.launch.train import build_train_smoke


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoints here, resumed from the latest (default: none kept)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    trainer, data = build_train_smoke(args.steps, ckpt_dir=args.ckpt_dir, device=args.device)
    cfg = trainer.model.cfg
    print(f"model: {cfg.param_count():,} params "
          f"({cfg.n_layers}L d={cfg.d_model})")
    state = trainer.init_state()
    print("state:", state)
    hist = trainer.run(data, args.steps, log_every=20)
    l0, l1 = hist[0]["loss"], hist[-1]["loss"]
    learned = l1 < l0 - 0.3
    print(f"loss {l0:.3f} -> {l1:.3f} "
          f"({'LEARNED' if learned else 'no clear learning'})")
    return {"params": cfg.param_count(), "state": state, "start_step": trainer.step - args.steps,
            "loss_first": l0, "loss_last": l1, "learned": learned, "history": hist}


if __name__ == "__main__":
    main()
