"""The port's training step, trainer, checkpoints and launcher against the
JAX package's, on the CPU, at phi3-mini's smoke size.

The JAX step is jitted: XLA folds the schedule's constants and sums in
other orders, so the port's numbers match it within tolerances stated
here, not bit for bit.  Checkpoints are bit-exact in both directions: a
directory the JAX ``Trainer`` wrote restores in the port, and the other way
round, to the same bits and step.
"""

import dataclasses
import math
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import ShapeSpec as JaxShapeSpec
from repro.data.synthetic import SyntheticLM as JaxSyntheticLM
from repro.launch.mesh import make_debug_mesh
from repro.launch.steps import build_train_step as jax_build_train_step
from repro.models.model import make_model as jax_make_model
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro.train.trainer import Trainer as JaxTrainer
from repro_torch.configs import ShapeSpec, get_config, list_archs
from repro_torch.core import params_from_numpy
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.launch import train
from repro_torch.launch.steps import build_train_step
from repro_torch.models.model import make_model
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt
from repro_torch.train.trainer import Trainer
from test_torch_train_layers import _ulp
from test_torch_train_models import GRAD_ULPS, LOSS_RTOL

ARCH = "phi3-mini-3.8b"
LR_RTOL = 2 ** -20          # the jitted schedule's folded constants
# the global norm of bf16 gradients GRAD_ULPS apart: measured 7.4e-4
# relative on phi3-mini-smoke
NORM_RTOL = 2 ** -8
# the same f32 gradients' squares summed in XLA's order and in PyTorch's:
# measured 1.3e-7 relative (2 ulps)
NORM_SUM_RTOL = 2 ** -20
# master = master - lr (u + wd master) on the same m and v: XLA's fused
# update rounds the product in other places than the unfused one, up to 2
# ulps of the larger operand (measured 2.0; where the master crosses zero
# that is dozens of ulps of the result, 38 measured)
MASTER_ULPS = 2
# a loss history over 12 AdamW steps: each step's forward rounds as in one
# loss (LOSS_RTOL); measured 2e-5 to 3e-5 relative at steps 1, 4, 8 and 12,
# with no drift
HISTORY_RTOL = 2 ** -12


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's tests: they take the same time
    with 1 as with 8 alone, and under several pytest workers sharing the
    cores, 8 spinning threads per worker slowed them tenfold and more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state(tr) -> dict:
    """A trainer's parameters and optimizer state by JAX checkpoint key, as
    f32 numpy arrays, and its step (via the checkpoint module's own
    flattening, so both packages are read the same way)."""
    if isinstance(tr, Trainer):
        arrays, dtypes = ckpt._host({"params": tr.params, "opt": tr.opt_state})
    else:
        arrays = {k: np.asarray(v) for k, v in
                  jckpt._flatten({"params": tr.params, "opt": tr.opt_state}).items()}
        dtypes = {k: v.dtype.name for k, v in arrays.items()}
    return {k: (dtypes[k], np.asarray(v).view(np.uint16) if dtypes[k] == "bfloat16"
                else np.asarray(v)) for k, v in arrays.items()}


def _assert_states_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k][0] == b[k][0], k
        np.testing.assert_array_equal(a[k][1], b[k][1], err_msg=k)


def _jax_accumulated_grads(jm, params, batch, a):
    """The f32 gradients the JAX step accumulates over ``a`` microbatches
    (``repro.launch.steps``' ``acc_body``, jitted): microbatch i is rows
    i::a, each one's gradients cast to f32, divided by a and summed."""
    grad_fn = jax.value_and_grad(jm.loss, has_aux=True)

    @jax.jit
    def acc(p, b):
        g_acc = jax.tree.map(lambda x: jnp.zeros(x.shape, jnp.float32), p)
        for i in range(a):
            _, g = grad_fn(p, {k: v[i::a] for k, v in b.items()})
            g_acc = jax.tree.map(lambda ga, gi: ga + gi.astype(jnp.float32) / a, g_acc, g)
        return g_acc

    return acc(params, batch)


def test_microbatched_step_matches_jax(monkeypatch):
    """One ``build_train_step`` step with 2 microbatches (rows 0::2 and
    1::2, gradients accumulated in f32) on JAX's parameters and batch,
    against the jitted JAX step, in three parts:

    - the step's metrics against JAX's; m = 0.1 x the clipped f32
      gradients, within GRAD_ULPS of each leaf's largest magnitude;
    - the accumulated f32 gradients that reach the port's update (read by a
      wrapper of ``adamw_update``) within GRAD_ULPS of JAX's, and the step's
      new parameters and state those of an update on them, bit for bit;
    - the port's ``adamw_update`` on JAX's gradients, with JAX's global
      norm (the two norms sum in other orders; ``global_norm`` itself within
      NORM_SUM_RTOL here): m and v equal the JAX step's bit for bit (so
      these are the gradients the step used), the bf16 parameters too,
      master within MASTER_ULPS; and master, m and v equal JAX's eager
      ``adamw_update`` on the same gradients bit for bit."""
    jcfg, cfg = jax_get_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
    jm, tm = jax_make_model(jcfg), make_model(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jp)
    params = params_from_numpy(np_params, cfg, device="cpu")
    data = SyntheticLM(cfg.vocab_size, 64, 4).batch(0)
    jbatch = {k: jnp.asarray(v) for k, v in data.items()}
    master0 = {"opt/.master/" + k.removeprefix("params/"): np.asarray(v, np.float32)
               for k, v in jckpt._flatten({"params": jp}).items()}
    mesh = make_debug_mesh((1, 1))
    jstep = jax_build_train_step(jm, mesh, JaxShapeSpec("t", 64, 4, "train"), lr=1e-3,
                                 total_steps=20, microbatches=2)
    j_lr = jopt.cosine_schedule(1e-3, 100, 20)
    with mesh:
        jg = _jax_accumulated_grads(jm, jp, jbatch, 2)
        _, je, _ = jopt.adamw_update(jg, jopt.adamw_init(jp), jp, lr_fn=j_lr)
        jnew, js, jmet = jstep.fn(jp, jax.jit(jopt.adamw_init)(jp), jbatch)
    want = {k: np.asarray(v) for k, v in
            jckpt._flatten({"params": jnew, "opt": js}).items()}
    eager = {k: np.asarray(v) for k, v in jckpt._flatten({"opt": je}).items()}
    grads = dict(params_from_numpy(jax.tree.map(np.asarray, jg), cfg,
                                   device="cpu").named_parameters())

    seen = {}
    update = opt.adamw_update

    def recording_update(g, *args, **kw):
        seen.update({n: x.detach().clone() for n, x in opt.leaves(g).items()})
        return update(g, *args, **kw)

    monkeypatch.setattr(opt, "adamw_update", recording_update)
    step = build_train_step(tm, ShapeSpec("t", 64, 4, "train"), lr=1e-3, total_steps=20,
                            microbatches=2)
    _, ts, tmet = step.fn(params, opt.adamw_init(params),
                          {k: torch.from_numpy(v) for k, v in data.items()})
    monkeypatch.undo()
    assert set(tmet) == set(jmet) and int(ts.step) == int(js.step) == 1
    for k in ("loss", "ce_loss", "lb_loss", "z_loss", "drop_frac"):
        np.testing.assert_allclose(tmet[k].item(), float(jmet[k]), rtol=LOSS_RTOL, err_msg=k)
    np.testing.assert_allclose(tmet["grad_norm"].item(), float(jmet["grad_norm"]),
                               rtol=NORM_RTOL)
    lr = float(jmet["lr"])
    np.testing.assert_allclose(tmet["lr"].item(), lr, rtol=LR_RTOL)
    got = ckpt._host({"opt": ts})[0]
    for k, w in want.items():
        if k.startswith("opt/.m/"):
            assert np.abs(w - got[k]).max() <= GRAD_ULPS * _ulp(np.abs(w).max()), k
    assert seen.keys() == grads.keys()
    for n, g in grads.items():
        assert seen[n].dtype == torch.float32
        w = g.detach().numpy()
        assert np.abs(w - seen[n].numpy()).max() <= GRAD_ULPS * _ulp(np.abs(w).max()), n

    again = params_from_numpy(np_params, cfg, device="cpu")
    _, rs, _ = opt.adamw_update(seen, opt.adamw_init(again), again,
                                lr_fn=opt.cosine_schedule(1e-3, 100, 20))
    mine_again = ckpt._host({"params": again, "opt": rs})[0]
    for k, v in ckpt._host({"params": params, "opt": ts})[0].items():
        np.testing.assert_array_equal(v, mine_again[k], err_msg=k)

    jnorm = float(jmet["grad_norm"])
    np.testing.assert_allclose(opt.global_norm(grads).item(), jnorm, rtol=NORM_SUM_RTOL)
    mine = params_from_numpy(np_params, cfg, device="cpu")
    monkeypatch.setattr(opt, "global_norm",
                        lambda tree: torch.tensor(jnorm, dtype=torch.float32))
    _, us, ust = opt.adamw_update(grads, opt.adamw_init(mine), mine,
                                  lr_fn=opt.cosine_schedule(1e-3, 100, 20))
    assert ust["lr"].item() == lr and int(us.step) == 1
    upd, dtypes = ckpt._host({"params": mine, "opt": us})
    for k, w in want.items():
        if k.startswith("params/"):
            assert dtypes[k] == w.dtype.name, k
            if dtypes[k] == "bfloat16":
                w = w.view(np.uint16)
            np.testing.assert_array_equal(w, upd[k], err_msg=k)
            continue
        np.testing.assert_array_equal(eager[k], upd[k], err_msg=k)
        if k.startswith("opt/.master/"):
            room = np.maximum(np.spacing(np.abs(master0[k])), np.spacing(np.abs(w)))
            assert (np.abs(w - upd[k]) <= MASTER_ULPS * room).all(), k
        else:
            np.testing.assert_array_equal(w, upd[k], err_msg=k)


def test_trainer_matches_jax_and_checkpoints_cross_load(tmp_path):
    """phi3-mini-smoke, SyntheticLM(vocab, 64, 4), lr 1e-3 to step 20, 2
    microbatches, log_every 4 (the setup of tests/test_train_infra.py).
    JAX: a fresh trainer, its initial state saved as step 0, then 6 steps
    (saved as step 6) and 6 more.  Port: a trainer resumed from JAX's step
    0 runs 12 steps: its loss history within HISTORY_RTOL of JAX's.  A
    second port trainer resumes from JAX's step 6: its state and step equal
    JAX's bit for bit; it runs to step 12 and saves; JAX restores that
    checkpoint to the port's state bit for bit."""
    jcfg, cfg = jax_get_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
    jm, tm = jax_make_model(jcfg), make_model(cfg)
    mesh = make_debug_mesh((1, 1))
    jbundle = jax_build_train_step(jm, mesh, JaxShapeSpec("t", 64, 4, "train"), lr=1e-3,
                                   total_steps=20, microbatches=2)
    bundle = build_train_step(tm, ShapeSpec("t", 64, 4, "train"), lr=1e-3, total_steps=20,
                              microbatches=2)
    d0, d6, d12 = tmp_path / "jax0", tmp_path / "jax6", tmp_path / "port12"

    jtr = JaxTrainer(jm, jbundle, ckpt_dir=str(d6))
    assert jtr.init_state() == "fresh"
    jckpt.save(d0, 0, {"params": jtr.params, "opt": jtr.opt_state})
    jdata = JaxSyntheticLM(cfg.vocab_size, 64, 4)
    with mesh:
        jtr.run(jdata, 6, log_every=4)
        state6 = _state(jtr)
        shutil.copytree(d6, tmp_path / "jax6_only")
        jtr.run(jdata, 6, log_every=4)
    want = {h["step"]: h for h in jtr.history}

    data = SyntheticLM(cfg.vocab_size, 64, 4)
    tr = Trainer(tm, bundle, ckpt_dir=str(d0), ckpt_every=100, device="cpu")
    assert tr.init_state() == "resumed" and tr.step == 0
    hist = tr.run(data, 12, log_every=4)
    assert [h["step"] for h in hist] == sorted(want) == [1, 4, 8, 12]
    for h in hist:
        assert set(h) == set(want[h["step"]])
        assert h["sec_per_step"] > 0
        np.testing.assert_allclose(h["loss"], want[h["step"]]["loss"], rtol=HISTORY_RTOL)
        np.testing.assert_allclose(h["lr"], want[h["step"]]["lr"], rtol=LR_RTOL)

    shutil.copytree(tmp_path / "jax6_only", d12)
    tr2 = Trainer(tm, bundle, ckpt_dir=str(d12), device="cpu")
    assert tr2.init_state() == "resumed" and tr2.step == 6
    _assert_states_equal(_state(tr2), state6)
    tr2.run(data, 6, log_every=4)
    assert ckpt.latest_step(d12) == 12 and tr2.history[-1]["step"] == 12
    np.testing.assert_allclose(tr2.history[-1]["loss"], want[12]["loss"], rtol=HISTORY_RTOL)
    template = jax.eval_shape(lambda: {"params": jtr.params, "opt": jtr.opt_state})
    restored, step = jckpt.restore(d12, template)
    assert step == 12
    jtr.params, jtr.opt_state = restored["params"], restored["opt"]
    _assert_states_equal(_state(jtr), _state(tr2))


@pytest.mark.parametrize("arch", list_archs())
def test_launcher_trains_on_the_cpu(arch, capsys):
    """``python -m repro_torch.launch.train --arch <arch> --smoke --device
    cpu --steps 2``: every architecture trains (Whisper on frames drawn
    per step, qwen2-vl on its default position streams) to a finite loss."""
    train.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2"])
    out = capsys.readouterr().out
    assert "state=fresh start_step=0 device=cpu" in out and "step     1 loss=" in out
    assert math.isfinite(float(out.rsplit("final loss:", 1)[1]))


def test_launcher_resumes_and_refuses(tmp_path, capsys):
    """Rerunning with the same ``--ckpt-dir`` resumes; ``--multi-pod`` (a
    TPU mesh) raises; ``--device cuda`` raises without a card."""
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "2",
            "--ckpt-dir", str(tmp_path), "--microbatches", "2"]
    train.main(argv)
    train.main(argv)
    assert "state=resumed start_step=2" in capsys.readouterr().out
    assert ckpt.latest_step(tmp_path) == 4
    with pytest.raises(NotImplementedError, match="multi-pod"):
        train.main(argv + ["--multi-pod"])
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="cuda"):
        train.main(["--arch", ARCH, "--smoke", "--steps", "1"])


def test_train_smoke_replays_from_a_checkpoint(tmp_path):
    """``examples/train_smoke.py``'s run (its config, 128 x 8, lr 3e-3,
    warm-up 20, 2 microbatches), 6 steps on the CPU, checkpointed at 3 and
    6: a fresh trainer restored from step 3 replays steps 4-6 with the
    first run's losses and ends in its state, bit for bit."""
    base = jax_get_config("gemma3-1b", smoke=True)
    example = dataclasses.replace(
        base, n_layers=4, d_model=256, n_heads=4, d_head=64, d_ff=1024, vocab_size=2048,
        window_pattern=(32, 32, 0), loss_chunk=64, attn_chunk=64)
    assert dataclasses.asdict(train.train_smoke_config()) == dataclasses.asdict(example)

    tr, data = train.build_train_smoke(300, ckpt_dir=tmp_path / "a", device="cpu")
    assert tr.init_state() == "fresh"
    tr.run(data, 3, log_every=1)
    hist = tr.run(data, 3, log_every=1)
    replay, data = train.build_train_smoke(300, device="cpu")
    replay.init_state()
    _, replay.step = ckpt.restore(tmp_path / "a", {"params": replay.params,
                                                   "opt": replay.opt_state}, step=3)
    got = replay.run(data, 3, log_every=1)
    assert [h["loss"] for h in got] == [h["loss"] for h in hist[3:]]
    _assert_states_equal(_state(replay), _state(tr))
