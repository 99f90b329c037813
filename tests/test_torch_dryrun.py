"""The port's dry run and roofline (``repro_torch.launch.dryrun``,
``repro_torch.roofline``) against the JAX package's.

* ``model_flops_for`` equals JAX's for every arch × shape.
* The FLOPs the port counts while a cell's step runs on meta tensors sit
  within FLOPS_RTOL of JAX's ``hlo_stats.analyze_hlo`` over the compiled
  single-device step of the same cell (smoke configs: a dense decoder, an
  MoE decoder, xLSTM; train cells with ``remat="full"``, as the dry run
  sets them) and equal ``FlopCounterMode``'s; the counts with the
  meta-kernel memo equal those without it.
* The CLI writes a record with every key; ``reanalyze`` recomputes the
  terms from a saved record.  ``--mesh pod1|pod2`` (``--multi-pod`` is
  pod2) writes records whose per-device bytes of phi3-mini-3.8b's
  parameters, AdamW state, batch and cache equal a sum over JAX's
  ``PartitionSpec``s of the same leaves, with the sharded step's
  activations, collectives and terms counted.  ``launch/train.py
  --multi-pod`` outside a process group of 512 ranks raises a
  ``ValueError`` naming them.
* The mesh dry run on a fake (2, 2) group, phi3-smoke: per-device FLOPs
  times 4 within FLOPS_SPLIT_RTOL of the one-device count for the train,
  prefill and decode cells; the collectives by kind; the state fields as
  ``mesh_state_cell`` counts them.
* phi3-mini-3.8b at full width traces its train step (1024 x 2, remat
  full) on meta without allocating its 61 GB of state, and counts
  ``chip_smoke.train_flops`` less the recompute that checkpointing stops
  early.
* The production-mesh grid at full width: every arch's state per device
  against JAX's specs on both meshes; xlstm-1.3b's decode_32k on pod1 (4
  heads over 16); 16 microbatches of 16 rows on pod2, whose per-device
  FLOPs equal pod1's (command-r-35b cut to 1 layer); under ``slow``,
  command-r-35b's pod2 train_4k at full depth and all 80 cells.
"""

import dataclasses
import json
import resource
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.configs.base import ShapeSpec as JaxShapeSpec
from repro.launch.mesh import make_debug_mesh
from repro.launch.steps import bundle_for as jax_bundle_for
from repro.roofline.analysis import model_flops_for as jax_model_flops_for
from repro.roofline.hlo_stats import analyze_hlo
from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import dryrun
from repro_torch.launch.steps import bundle_for
from repro_torch.roofline import analysis, counts, reanalyze

ROOT = Path(__file__).resolve().parent.parent

# Counted FLOPs against XLA's dots: the port's count is 0.04-0.6 % below
# (measured, train / prefill / decode: phi3-mini-smoke 0.10 / 0.16 / 0.14 %,
# olmoe-smoke 0.33 / 0.55 / 0.32 %, xlstm-smoke 0.61 / 0.38 / 0.27 %): XLA's
# program keeps a few dots PyTorch does not run, such as the MoE router's
# one-hot dispatch products and the norms' row sums of squares (an einsum in
# JAX, a multiply and a mean here).  hymba-smoke at 128 positions counts
# 3.4 % below XLA's in its train and prefill cells: its attention runs over
# 8 meta tokens and the 128 positions, 136 queries, and JAX's
# ``chunked_attention`` pads the queries to whole chunks of ``attn_chunk``
# (32), 160 rows, whose dots XLA computes and discards; the port's chunk loop
# takes a last chunk of 8 rows.  Every attention dot is linear in the query
# rows, so XLA's attention FLOPs are the port's times 160 / 136, which is
# the whole gap (train 1103360000 against 1066024960; prefill 127767040
# against 123371520).  So hymba's train and prefill cells here run 120
# positions (128 queries, no padding): 0.18 % below and 0.02 % above.
# Not held here: whisper-smoke's decode cell, 45 % below for the same
# padding (its cross-attention pads the one decode query to a chunk of 16
# rows), and command-r-smoke's train cell, 2.0 % above (one more (256 x
# 128) . (128 x 128) dot per layer and microbatch than XLA's program keeps;
# not located).
FLOPS_RTOL = 0.01
CELLS = [("train", 128, 4), ("prefill", 128, 2), ("decode", 128, 2)]


@pytest.mark.parametrize("smoke", [False, True])
def test_model_flops_for_matches_jax(smoke):
    for arch in list_archs():
        cfg, jcfg = get_config(arch, smoke), jax_get_config(arch, smoke)
        for name, sh in SHAPES.items():
            assert analysis.model_flops_for(cfg, sh) == \
                jax_model_flops_for(jcfg, JAX_SHAPES[name]), (arch, name)


def _port_counts(cfg, shape, microbatches):
    b = bundle_for(cfg, shape, microbatches=microbatches)
    train = shape.kind == "train"
    return counts.count_step(b.fn, b.abstract_args, params=b.abstract_args[0],
                             opt_state=b.abstract_args[1] if train else None,
                             microbatches=microbatches or 1)


@pytest.mark.parametrize("arch", [
    "phi3-mini-3.8b", "olmoe-1b-7b", "xlstm-1.3b", "hymba-1.5b",
    *(pytest.param(a, marks=pytest.mark.slow) for a in (
        "gemma3-1b", "starcoder2-7b", "qwen2-vl-72b", "phi3.5-moe-42b-a6.6b"))])
def test_counted_flops_match_jax_hlo(arch):
    mesh = make_debug_mesh((1, 1))
    for kind, s, b in CELLS:
        remat = "full" if kind == "train" else "none"
        cfg = dataclasses.replace(get_config(arch, smoke=True), remat=remat)
        if kind != "decode":   # whole attention chunks (FLOPS_RTOL's note)
            s -= cfg.meta_tokens
        jcfg = dataclasses.replace(jax_get_config(arch, smoke=True), remat=remat)
        jb = jax_bundle_for(jcfg, mesh, JaxShapeSpec("c", s, b, kind), microbatches=2)
        with mesh:
            want = analyze_hlo(jb.fn.lower(*jb.abstract_args).compile().as_text())["flops"]
        got = _port_counts(cfg, ShapeSpec("c", s, b, kind), 2 if kind == "train" else None)
        assert got["flops"] == pytest.approx(want, rel=FLOPS_RTOL), (arch, kind)
        assert got["bytes"] > 0 and got["ops"] > 0
        rec = analysis.analyze(got, model_flops_total=analysis.model_flops_for(
            cfg, ShapeSpec("c", s, b, kind)))
        assert rec["terms_seconds"]["collective"] == 0.0
        assert rec["dominant"] in ("compute", "memory")


@pytest.mark.parametrize("arch,kind", [("xlstm-1.3b", "prefill"), ("hymba-1.5b", "train"),
                                       ("whisper-medium", "train")])
def test_counts_equal_flop_counter_and_the_unmemoized_run(arch, kind):
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              remat="full" if kind == "train" else "none")
    shape = ShapeSpec("c", 64, 2, kind)
    b = bundle_for(cfg, shape, microbatches=2)
    with FlopCounterMode(display=False) as fm:
        b.fn(*b.abstract_args)
    seen = []
    for memo in (True, False):
        b = bundle_for(cfg, shape, microbatches=2)
        c = counts._Counter(memo=memo)
        with c:
            b.fn(*b.abstract_args)
        seen.append((c.flops, c.bytes, c.ops, c.live.peak))
    assert seen[0] == seen[1]
    assert seen[0][0] == fm.get_total_flops()


def test_cli_writes_records_and_reanalyze_recomputes(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "get_config", lambda a: get_config(a, smoke=True))
    monkeypatch.setattr(dryrun, "SHAPES", {
        "train_4k": ShapeSpec("train_4k", 64, 8, "train"),
        "decode_32k": ShapeSpec("decode_32k", 64, 4, "decode"),
        "long_500k": ShapeSpec("long_500k", 128, 1, "decode")})
    dryrun.main(["--arch", "gemma3-1b", "--out", str(tmp_path)])
    dryrun.main(["--arch", "hymba-1.5b", "--shape", "long_500k", "--out", str(tmp_path)])
    files = sorted(p.name for p in tmp_path.glob("*.json"))
    assert files == ["gemma3-1b__decode_32k__1dev.json", "gemma3-1b__long_500k__1dev.json",
                     "gemma3-1b__train_4k__1dev.json", "hymba-1.5b__long_500k__1dev.json"]
    train = json.loads((tmp_path / files[2]).read_text())
    keys = {"chips", "per_device", "totals", "terms_seconds", "dominant", "model_flops",
            "useful_flop_ratio", "roofline_fraction", "memory", "cell", "arch", "shape",
            "multi_pod", "trace_s", "params", "active_params", "skipped", "microbatches",
            "remat"}
    assert keys <= set(train)
    assert train["remat"] == "full" and train["microbatches"] == 4 and train["chips"] == 1
    assert {"param_bytes", "optimizer_bytes", "grad_bytes", "saved_activation_bytes",
            "peak_live_bytes", "total_bytes", "device_bytes", "fits"} <= set(train["memory"])
    assert json.loads((tmp_path / files[1]).read_text())["skipped"]      # gemma3: no long
    assert not json.loads((tmp_path / files[3]).read_text())["skipped"]  # hymba: long

    # reanalyze: the terms again from the counts, with no re-trace
    want = dict(train)
    train["terms_seconds"] = train["dominant"] = None
    (tmp_path / files[2]).write_text(json.dumps(train))
    got = reanalyze.reanalyze_cell(tmp_path / files[2])
    assert got == want
    reanalyze.main(["--dir", str(tmp_path)])
    # a cell with a record is skipped unless --force
    assert dryrun.run_cell("gemma3-1b", "train_4k", tmp_path) == want


def test_multi_pod_raises(tmp_path):
    """``--multi-pod`` outside a process group of 512 ranks raises in the
    trainer, naming them (it never trains on one device instead); in the
    dry run it is ``--mesh pod2``: records of 512 chips whose activations,
    collectives and terms are counted from the sharded step."""
    from repro_torch.launch import train

    with pytest.raises(ValueError, match="512 ranks"):
        train.build(train.parser().parse_args(["--arch", "phi3-mini-3.8b", "--multi-pod",
                                               "--device", "cpu"]))
    dryrun.main(["--arch", "phi3-mini-3.8b", "--shape", "decode_32k", "--multi-pod",
                 "--out", str(tmp_path)])
    dryrun.main(["--arch", "phi3-mini-3.8b", "--shape", "long_500k", "--mesh", "pod1",
                 "--out", str(tmp_path)])
    rec = json.loads((tmp_path / "phi3-mini-3.8b__decode_32k__pod2.json").read_text())
    assert rec["chips"] == 512 and rec["multi_pod"] and rec["mesh"] == "pod2"
    assert rec["mesh_shape"] == {"pod": 2, "data": 16, "model": 16}
    dev = rec["per_device"]
    assert dev["activation_bytes"] > 0 and dev["collective_bytes"] > 0
    assert dev["flops"] > 0 and dev["bytes"] > 0
    assert set(rec["terms_seconds"]) == {"compute", "memory", "collective"}
    assert rec["dominant"] is not None and rec["roofline_fraction"] is not None
    assert "not_counted" not in rec
    assert dev["collective_bytes"] == sum(v for k, v in rec["collectives"].items()
                                          if not k.startswith("_"))
    assert dev["state_bytes"] == sum(dev[k] for k in ("param_bytes", "optimizer_bytes",
                                                      "batch_bytes", "cache_bytes"))
    assert json.loads((tmp_path / "phi3-mini-3.8b__long_500k__pod1.json").read_text())[
        "skipped"]
    assert reanalyze.reanalyze_cell(tmp_path / "phi3-mini-3.8b__decode_32k__pod2.json") == rec


# per-device FLOPs on a (2, 2) mesh, times 4, against the one-device count:
# every matmul of the step splits four ways (rows over 'data', heads and
# hidden widths over 'model'), none runs on every rank of an axis
FLOPS_SPLIT_RTOL = 0.01


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_mesh_dry_run_splits_the_step_on_a_fake_2x2_group(kind):
    from repro_torch.launch.mesh import MeshShape

    cfg = get_config("phi3-mini-3.8b", smoke=True)
    shape = ShapeSpec("c", 64, 8, kind)
    mb = 2 if kind == "train" else None
    one = dryrun.analyze_cell(cfg, shape, microbatches=mb)
    mesh = MeshShape((2, 2), ("data", "model"))
    rec = dryrun.mesh_cell(cfg, shape, mesh, microbatches=mb)
    dev = rec["per_device"]
    assert dev["flops"] * 4 == pytest.approx(one["per_device"]["flops"], rel=FLOPS_SPLIT_RTOL)
    assert rec["chips"] == 4 and rec["useful_flop_ratio"] == pytest.approx(
        one["useful_flop_ratio"], rel=FLOPS_SPLIT_RTOL)
    coll = rec["collectives"]
    for k, n in coll["_counts"].items():
        assert (n > 0) == (coll[k] > 0), k
    # rows over 'data' and tensor parallelism over 'model': parameters are
    # gathered over 'data' (FSDP) and the row-parallel sums reduced over
    # 'model'; training reduce-scatters its gradients
    assert coll["all_gather_into_tensor"] > 0 and coll["all_reduce"] > 0
    assert coll["reduce_scatter_tensor"] > 0 or kind != "train"
    assert rec["terms_seconds"]["collective"] == dev["collective_bytes"] / analysis.LINK_BW
    state = dryrun.mesh_state_cell(cfg, shape, mesh)
    for k, v in state["per_device"].items():
        assert dev[k] == v, k
    assert {k: rec[k] for k in state if k != "per_device"} == \
        {k: v for k, v in state.items() if k != "per_device"}
    assert threading.active_count() >= 1 and not torch.distributed.is_initialized()


@pytest.mark.parametrize("mesh_name", ["pod1", "pod2"])
@pytest.mark.parametrize("arch", list_archs())
def test_mesh_state_equals_sum_over_jax_specs(arch, mesh_name, monkeypatch):
    """Every arch at full width on the production meshes: each cell's
    per-device parameter, optimizer, batch and cache bytes equal the sum,
    over JAX's leaves of the same state, of each leaf's bytes divided by
    the mesh axes its ``PartitionSpec`` names (``long_500k`` where JAX's
    ``applicable`` runs it)."""
    from repro.launch.dryrun import applicable as jax_applicable

    import numpy as np

    from repro.configs import specs as jax_specs
    from repro.launch import sharding as jshd
    from repro.models.model import make_model as jax_make_model

    monkeypatch.setattr(jshd, "NamedSharding", lambda mesh, spec: spec)

    class FakeMesh:
        shape = ({"pod": 2, "data": 16, "model": 16} if mesh_name == "pod2"
                 else {"data": 16, "model": 16})

    def per_device(leaf, spec):
        n = 1
        for e in spec:
            for a in (e if isinstance(e, tuple) else (e,) if e else ()):
                n *= FakeMesh.shape[a]
        return int(np.prod(leaf.shape)) * np.dtype(leaf.dtype).itemsize // n

    def tree_bytes(tree, specs):
        flat = jax.tree_util.tree_leaves(tree)
        sp = jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(x, tuple))
        return sum(per_device(x, s) for x, s in zip(flat, sp, strict=True))

    jcfg = jax_get_config(arch)
    jmodel = jax_make_model(jcfg)
    params = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    pspecs = [jshd.param_spec(jcfg, FakeMesh, tuple(str(k.key) for k in kp), x) for kp, x in flat]
    param_bytes = sum(per_device(x, s) for (_, x), s in zip(flat, pspecs))
    param_elems = sum(per_device(x, s) // np.dtype(x.dtype).itemsize
                      for (_, x), s in zip(flat, pspecs))
    for name in JAX_SHAPES:
        assert jax_applicable(jcfg, name) == dryrun.applicable(get_config(arch), name)
        if not jax_applicable(jcfg, name):
            continue
        sh = JAX_SHAPES[name]
        b = sh.global_batch
        want = {"param_bytes": param_bytes, "optimizer_bytes": 0, "batch_bytes": 0,
                "cache_bytes": 0}
        if sh.kind == "train":
            want["optimizer_bytes"] = 12 * param_elems + 4
        if sh.kind == "decode":
            ba = jshd.batch_axes(FakeMesh)
            tok = jax.ShapeDtypeStruct((b, 1), jnp.int32)
            want["batch_bytes"] = per_device(
                tok, (ba if b % max(1, jshd._axis_size(FakeMesh, ba)) == 0 else None,
                      None)) + 4
        else:
            batch = (jax_specs.train_batch_specs if sh.kind == "train"
                     else jax_specs.prefill_batch_specs)(jcfg, sh)
            bs = jshd.batch_shardings(jcfg, FakeMesh, batch, b)
            want["batch_bytes"] = sum(per_device(batch[k], tuple(bs[k])) for k in batch)
        if sh.kind != "train":
            cache = jax.eval_shape(lambda: jmodel.init_cache(b, sh.seq_len))
            cs = jax.tree.map(tuple, jshd.cache_shardings(jcfg, FakeMesh, cache, b),
                              is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
            want["cache_bytes"] = tree_bytes(cache, cs)
        got = dryrun.mesh_state_cell(get_config(arch), SHAPES[name], mesh_name)
        for k, v in want.items():
            assert got["per_device"][k] == v, (name, k)
        assert got["state_fits"] == (sum(want.values()) <= analysis.HBM_BYTES)
        assert got["chips"] == (512 if mesh_name == "pod2" else 256)


def test_full_width_train_cell_traces_on_meta_without_allocating():
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    cfg = get_config("phi3-mini-3.8b")
    b, s = chip_smoke.DRYRUN_TRAIN_CUT
    rec = dryrun.analyze_cell(cfg, ShapeSpec("cut", s, b, "train"), microbatches=1)
    grown_gb = (resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - before) * 1024 / 1e9
    assert grown_gb < 2
    mem = rec["memory"]
    # gradients as the parameters (bf16, the norm scales f32); f32 master, m
    # and v, and the step counter
    assert mem["grad_bytes"] == mem["param_bytes"]
    assert mem["optimizer_bytes"] == 12 * cfg.param_count() + 4
    assert 60e9 < mem["total_bytes"] < 80e9 and mem["fits"]
    flops = chip_smoke.train_flops(dataclasses.replace(cfg, remat="full"), b, s, "full")
    early = (2 * cfg.d_model * cfg.d_ff * b * s * cfg.n_layers
             + 2 * b * s * s * cfg.n_heads * cfg.head_dim * cfg.n_layers)
    counted = rec["per_device"]["flops"]
    assert counted == pytest.approx(flops["total"] - early,
                                    rel=chip_smoke.DRYRUN_FLOPS_RTOL)
    assert abs(counted / flops["total"] - 1) < chip_smoke.DRYRUN_FLOPS_GAP
    assert rec["useful_flop_ratio"] == pytest.approx(
        analysis.model_flops_for(cfg, ShapeSpec("cut", s, b, "train")) / counted)


# ---------------------------------------------------------------------------
# The production-mesh grid at full width: the cells the port could not trace
# before (xLSTM's 4 heads over a 'model' axis of 16; pod2's train_4k of the
# archs with 16 microbatches, 8 rows a rank), and the whole grid under slow
# ---------------------------------------------------------------------------

def _assert_mesh_record(rec: dict):
    """A traced mesh record: every count and term present and consistent."""
    dev = rec["per_device"]
    assert dev["flops"] > 0 and dev["bytes"] > 0 and dev["activation_bytes"] > 0
    assert dev["collective_bytes"] == sum(v for k, v in rec["collectives"].items()
                                          if not k.startswith("_")) > 0
    t = rec["terms_seconds"]
    assert t["compute"] == dev["flops"] / analysis.BF16_PEAK
    assert t["collective"] == dev["collective_bytes"] / analysis.LINK_BW
    assert rec["dominant"] == max(t, key=t.get)
    assert 0 < rec["roofline_fraction"] <= 1


def test_xlstm_decode_traces_on_pod1():
    """xlstm-1.3b's decode_32k on pod1: the mLSTM and sLSTM run each rank's
    rows with the 4 heads whole, and the record says its collective term
    is an upper bound (the regions gather over 'model')."""
    cfg = get_config("xlstm-1.3b")
    rec = dryrun.mesh_cell(cfg, SHAPES["decode_32k"], "pod1")
    _assert_mesh_record(rec)
    assert rec["chips"] == 256 and rec["microbatches"] is None
    assert rec["collective_upper_bound"] and "rows_local" in rec["collective_upper_bound"][0]
    assert rec["per_device"]["cache_bytes"] == dryrun.mesh_state_cell(
        cfg, SHAPES["decode_32k"], "pod1")["per_device"]["cache_bytes"]


def test_sixteen_microbatches_of_16_rows_on_pod2():
    """command-r-35b at full width cut to 1 layer, train_4k's 256 rows at
    512 tokens with its 16 microbatches: on pod2 a rank holds 8 rows, so
    each 16-row microbatch goes over 'data' and is replicated over 'pod';
    per device it then runs the FLOPs pod1's step runs (16 rows a rank
    there: local microbatches), within FLOPS_SPLIT_RTOL."""
    cfg = dataclasses.replace(get_config("command-r-35b"), n_layers=1)
    shape = ShapeSpec("train_4k_cut", 512, SHAPES["train_4k"].global_batch, "train")
    assert dryrun.default_microbatches(get_config("command-r-35b")) == 16
    recs = {m: dryrun.mesh_cell(cfg, shape, m, microbatches=16) for m in ("pod1", "pod2")}
    for rec in recs.values():
        _assert_mesh_record(rec)
        assert rec["microbatches"] == 16
    assert recs["pod2"]["per_device"]["flops"] == pytest.approx(
        recs["pod1"]["per_device"]["flops"], rel=FLOPS_SPLIT_RTOL)


@pytest.mark.slow
def test_command_r_train_traces_on_pod2():
    """command-r-35b's train_4k on pod2 at full width and depth (16
    microbatches, 8 rows a rank): about 140 s."""
    rec = dryrun.mesh_cell(get_config("command-r-35b"), SHAPES["train_4k"], "pod2")
    _assert_mesh_record(rec)
    assert rec["microbatches"] == 16 and rec["chips"] == 512


@pytest.mark.slow
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", list_archs())
@pytest.mark.parametrize("mesh_name", ["pod1", "pod2"])
def test_production_mesh_grid(mesh_name, arch, shape, tmp_path):
    """The port's form of JAX's default dry run: every (arch x shape) cell
    on both production meshes (80 records).  A cell JAX's ``applicable``
    skips is skipped with JAX's reason; every other one traces.  Minutes
    to tens of minutes a cell on a CPU (xlstm-1.3b's train_4k about 20)."""
    from repro.launch.dryrun import applicable as jax_applicable

    rec = dryrun.run_cell(arch, shape, tmp_path, mesh=mesh_name)
    jcfg = jax_get_config(arch)
    assert rec["skipped"] == (not jax_applicable(jcfg, shape))
    if rec["skipped"]:
        assert rec["reason"] == jcfg.long_skip_reason
        return
    _assert_mesh_record(rec)
    path = tmp_path / f"{rec['cell']}.json"
    assert reanalyze.reanalyze_cell(path) == json.loads(path.read_text())
