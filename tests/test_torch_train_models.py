"""The port's training loss against the JAX package's, on the CPU: loss,
every metric and every gradient leaf of the attention decoders' smoke
configs (phi3-mini, gemma3, starcoder2, command-r, qwen2-vl) at B = 2,
S = 64, against ``jax.value_and_grad(model.loss, has_aux=True)`` on the
same parameters (``params_from_numpy``) and the same numpy-seeded batch.
The other families are in ``test_torch_train_families.py``, which uses
``check_loss_and_grads`` from here.

Tolerances: the loss and the metrics within LOSS_RTOL, relative; each
gradient leaf within GRAD_ULPS bf16 ulps of that leaf's largest magnitude
(``_ulp``).  Two bf16 layers and the loss, each rounded at other places by
XLA and by PyTorch, leave gaps of 3 to 10 such ulps on these configs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import moe as jmoe
from repro.models.model import make_model as jax_make_model
from repro_torch.configs import get_config
from repro_torch.core import params_from_numpy
from repro_torch.models import moe
from repro_torch.models.model import make_model
from test_torch_moe import ROUTER_TIE
from test_torch_train_layers import _ulp

B, S = 2, 64
GRAD_ULPS = 16
LOSS_RTOL = 2 ** -12
METRICS = ("lb_loss", "z_loss", "drop_frac", "ce_loss")
DECODERS = ["phi3-mini-3.8b", "gemma3-1b", "starcoder2-7b", "command-r-35b",
            "qwen2-vl-72b"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's tests: they take the same time
    with 1 as with 8 alone, and under several pytest workers sharing the
    cores, 8 spinning threads per worker slowed them tenfold and more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def batch(cfg, seed=0):
    """(JAX batch, port batch): tokens and labels from ``seed``; Whisper's
    frames standard normal in bf16; M-RoPE's three distinct position
    streams (B, 3, S)."""
    rng = np.random.default_rng(seed)
    np_b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.rope_kind == "mrope":
        np_b["positions"] = np.stack([np.broadcast_to(np.arange(S), (B, S)),
                                      rng.integers(0, 8, (B, S)),
                                      rng.integers(0, 8, (B, S))], 1).astype(np.int32)
    jb = {k: jnp.asarray(v) for k, v in np_b.items()}
    tb = {k: torch.from_numpy(v) for k, v in np_b.items()}
    if cfg.enc_dec:
        fr = rng.standard_normal((B, cfg.enc_len, cfg.d_model)).astype(np.float32)
        jb["frames"] = jnp.asarray(fr, jnp.bfloat16)
        tb["frames"] = torch.from_numpy(fr).to(torch.bfloat16)
    return jb, tb


def _force_jax_routing(monkeypatch):
    """Record each JAX ``moe_apply`` call's router probabilities and
    choices (a ``jax.debug.callback``, in call order, under the gradient
    too) and make the port's router take JAX's choices, in the same call
    order, with its own probabilities for the gates.  Returns the JAX log
    and the port's own choices."""
    jax_log, port_log = [], []

    def record(fn):
        def wrapped(params, x, *, n_experts, top_k, **kw):
            probs = jax.nn.softmax(
                jnp.einsum("bsd,de->bse", x.astype(jnp.float32), params["router"]), -1)
            jax.debug.callback(lambda p, g: jax_log.append((np.asarray(p), np.asarray(g))),
                               probs, jax.lax.top_k(probs, top_k)[1], ordered=True)
            return fn(params, x, n_experts=n_experts, top_k=top_k, **kw)
        return wrapped

    route = moe.route

    def forced(params, x, top_k):
        logits, probs, _, own = route(params, x, top_k)
        port_log.append(own.numpy())
        gi = torch.from_numpy(np.array(jax_log[len(port_log) - 1][1])).long()
        gv = probs.gather(-1, gi)
        return logits, probs, gv / torch.clamp(gv.sum(-1, keepdim=True), min=1e-9), gi

    monkeypatch.setattr(jmoe, "moe_apply", record(jmoe.moe_apply))
    monkeypatch.setattr(moe, "route", forced)
    return jax_log, port_log


def check_loss_and_grads(arch, monkeypatch):
    """Loss, metrics and every gradient leaf of ``arch``'s smoke config
    against JAX's.  An MoE config's expert choices may flip between the
    frameworks where the JAX router's k-th and (k+1)-th probabilities
    nearly tie (``test_torch_moe.py``): every choice the port's own router
    makes differently must be such a near-tie (a gap under ROUTER_TIE), and
    the comparison then runs with JAX's choices imposed on the port's
    router.  Returns the largest gradient gap in bf16 ulps."""
    jcfg, cfg = jax_get_config(arch, smoke=True), get_config(arch, smoke=True)
    if cfg.ffn == "moe":
        jax_log, port_log = _force_jax_routing(monkeypatch)
    jm, tm = jax_make_model(jcfg), make_model(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    jb, tb = batch(cfg)
    (want, want_m), want_g = jax.value_and_grad(jm.loss, has_aux=True)(jp, jb)

    params = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    params.requires_grad_(True)
    got, got_m = tm.loss(params, tb)
    got.backward()

    if cfg.ffn == "moe":
        assert len(port_log) == len(jax_log) == cfg.n_layers
        for (probs, choice), own in zip(jax_log, port_log):
            flips = (np.sort(own, -1) != np.sort(choice, -1)).any(-1)
            top = -np.sort(-probs[flips], -1)
            assert np.all(top[:, cfg.moe_top_k - 1] - top[:, cfg.moe_top_k] <= ROUTER_TIE)
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)
    assert set(got_m) == set(want_m) == set(METRICS)
    for k in METRICS:
        assert got_m[k].dtype == torch.float32 and got_m[k].dim() == 0
        np.testing.assert_allclose(got_m[k].item(), float(want_m[k]), rtol=LOSS_RTOL,
                                   err_msg=k)
    want_g = dict(params_from_numpy(jax.tree.map(np.asarray, want_g), cfg,
                                    device="cpu").named_parameters())
    worst = 0.0
    for name, p in params.named_parameters():
        assert p.grad is not None and p.grad.dtype == p.dtype, name
        w, g = want_g[name].detach().float(), p.grad.float()
        gap = (w - g).abs().max().item() / _ulp(w.abs().max().item())
        assert gap <= GRAD_ULPS, f"{name}: {gap:.2f} bf16 ulps"
        worst = max(worst, gap)
    return worst


@pytest.mark.parametrize("arch", DECODERS)
def test_decoder_loss_and_grads_match_jax(arch, monkeypatch):
    """The attention decoders: RoPE and SwiGLU (phi3-mini), QK-norm,
    windows and a tied, scaled embedding that collects the gradient of both
    its uses (gemma3), LayerNorm, GeLU and a window (starcoder2), the
    parallel block (command-r), M-RoPE on given position streams
    (qwen2-vl)."""
    check_loss_and_grads(arch, monkeypatch)
