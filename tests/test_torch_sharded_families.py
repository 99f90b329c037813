"""The sharded step for every family's smoke config: ``test_torch_sharded_step.py``'s
check (b) on 4 gloo CPU ranks, meshes (2, 2) and (4, 1), against the port's
one-device step (``torch_rank_fns.run_steps`` on both sides, each family's
parameters from the port's seeded init).

olmoe-smoke (the MoE hints, the dispatch and combine on DTensors) runs in the
fast lane; the other eight families under ``slow``.  An MoE mesh step takes
the one-device step's expert choices, and every choice its own router makes
differently must be a near-tie of the one-device router (ROUTER_TIE): the
mesh's sums over 'model' round bf16 at other places.
"""

import pytest
import torch

import torch_rank_fns as rf
from repro_torch.configs import get_config, list_archs
from repro_torch.launch.mesh import run_on_ranks
from repro_torch.models.model import make_model
from test_torch_sharded_step import (MESH_SHAPES, RANKS, assert_ranks_agree,
                                     assert_routing_flips_are_ties, assert_serve_close,
                                     assert_step_close, assert_update_redone, impose_of)

FAST = ["olmoe-1b-7b"]
SLOW = sorted(set(list_archs()) - set(FAST) - {"phi3-mini-3.8b"})


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _runs(archs):
    """The one-device records of ``archs``, then one group of ranks that
    runs every (arch, mesh) case."""
    refs, values, cases = {}, {}, []
    for arch in archs:
        values[arch] = rf.params_numpy(make_model(get_config(arch, smoke=True)).init(
            torch.Generator().manual_seed(0)))
        refs[arch] = rf.run_steps(arch, values[arch])
        cases += [(arch, values[arch], m, impose_of(refs[arch]), refs[arch]["fed"])
                  for m in MESH_SHAPES]
    ranks = run_on_ranks(rf.sharded_step_rank, RANKS, "gloo", "cpu", args=(cases,),
                         timeout=1200)
    return {"refs": refs, "values": values, "ranks": ranks, "index": {(c[0], c[2]): i
                                                    for i, c in enumerate(cases)}}


@pytest.fixture(scope="module")
def fast_runs():
    return _runs(FAST)


@pytest.fixture(scope="module")
def slow_runs():
    return _runs(SLOW)


def _check(runs, arch, mesh):
    what = f"{arch} smoke on {mesh}"
    case = runs["index"][arch, mesh]
    ref, ranks = runs["refs"][arch], runs["ranks"]
    assert_ranks_agree(ranks, case, what)
    got = ranks[0]["cases"][case]
    cfg = get_config(arch, smoke=True)
    if cfg.ffn == "moe":
        for phase in ("train", "serve"):
            assert_routing_flips_are_ties(cfg, ref["routing"][phase], got["routing"][phase],
                                          f"{what} {phase}")
    for a in rf.TRAIN_ROWS:
        assert_step_close(ref["train"][a], got["train"][a], f"{what}, {a} microbatches")
        assert_update_redone(arch, runs["values"][arch], got["train"][a],
                             f"{what}, {a} microbatches")
    assert_serve_close(ref, got, what)


@pytest.mark.parametrize("mesh", MESH_SHAPES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", FAST)
def test_moe_sharded_steps_match_one_device(fast_runs, arch, mesh):
    _check(fast_runs, arch, mesh)


@pytest.mark.slow
@pytest.mark.parametrize("mesh", MESH_SHAPES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", SLOW)
def test_family_sharded_steps_match_one_device(slow_runs, arch, mesh):
    _check(slow_runs, arch, mesh)
