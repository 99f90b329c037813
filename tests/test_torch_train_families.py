"""The port's training loss against the JAX package's for the MoE
decoders, the hymba hybrid, xLSTM and the Whisper encoder-decoder
(``check_loss_and_grads`` of ``test_torch_train_models.py``: loss and
metrics within LOSS_RTOL, each gradient leaf within GRAD_ULPS bf16 ulps of
its largest magnitude), and, inside the port, activation checkpointing:
``remat="full"`` and ``"dots"`` give the loss and gradients of ``"none"``
bit for bit.
"""

import collections
import dataclasses

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import get_config
from repro_torch.models.model import make_model
from test_torch_train_models import batch, check_loss_and_grads

FAMILIES = ["olmoe-1b-7b", "phi3.5-moe-42b-a6.6b", "hymba-1.5b", "xlstm-1.3b",
            "whisper-medium"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's tests: they take the same time
    with 1 as with 8 alone, and under several pytest workers sharing the
    cores, 8 spinning threads per worker slowed them tenfold and more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_loss_and_grads_match_jax(arch, monkeypatch):
    """MoE: capacity drops (``drop_frac``) and the aux losses, whose
    gradients reach the routers (olmoe: 8 experts top-2 with QK-norm;
    phi3.5-moe: 4 experts top-2, whose router flips a choice at a near-tie
    in layer 1); hymba: attention and Mamba in parallel, the meta tokens'
    gradient; xLSTM: a group of mLSTM blocks (the stabiliser's maxima at
    m = 0 on the first chunk) and an sLSTM block; Whisper: the encoder
    (frames take no gradient) and the decoder's cross-attention."""
    check_loss_and_grads(arch, monkeypatch)


class _CountOps(TorchDispatchMode):
    """Counts the ATen ops that run, by name (forward, recompute, backward)."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func.overloadpacket.__name__] += 1
        return func(*args, **(kwargs or {}))


def _loss_and_grads(cfg):
    m = make_model(cfg)
    params = m.init(torch.Generator().manual_seed(0))
    params.requires_grad_(True)
    _, tb = batch(cfg)
    with _CountOps() as count:
        loss, metrics = m.loss(params, tb)
        loss.backward()
    return (loss, metrics, {n: p.grad for n, p in params.named_parameters()}), count.ops


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "olmoe-1b-7b", "hymba-1.5b",
                                  "xlstm-1.3b", "whisper-medium"])
def test_remat_matches_none_exactly(arch):
    """Per-layer checkpointing (an xLSTM group, a Whisper decoder block)
    changes what backward keeps, not what it computes: loss, metrics and
    every gradient equal ``remat="none"``'s bit for bit.  And they do
    recompute: ``"full"`` runs every layer's forward again in backward, its
    plain matmuls (``aten.mm``) too; ``"dots"`` runs the rest again but
    keeps the matmuls' outputs, so it runs as many matmuls as ``"none"``."""
    cfg = get_config(arch, smoke=True)
    results, ops = {}, {}
    for remat in ("none", "full", "dots"):
        results[remat], ops[remat] = _loss_and_grads(dataclasses.replace(cfg, remat=remat))
    want_l, want_m, want_g = results["none"]
    for remat in ("full", "dots"):
        loss, metrics, grads = results[remat]
        assert torch.equal(loss, want_l)
        assert all(torch.equal(metrics[k], want_m[k]) for k in want_m)
        assert all(torch.equal(grads[n], want_g[n]) for n in want_g), remat
    assert ops["full"]["mm"] > ops["dots"]["mm"] == ops["none"]["mm"]
    assert ops["full"]["mul"] == ops["dots"]["mul"] > ops["none"]["mul"]


def test_unknown_remat_raises():
    cfg = dataclasses.replace(get_config("phi3-mini-3.8b", smoke=True), remat="some")
    with pytest.raises(ValueError, match="phi3-mini-smoke: remat='some'"):
        make_model(cfg)
