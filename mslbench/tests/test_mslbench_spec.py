"""The benchmark's harness on the CPU: the loaders, the result line, the
seeded generators, the counting functions and the import rules."""

import ast
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from mslbench import run as bench_run  # noqa: E402
from mslbench.clients import serve_openloop  # noqa: E402
from mslbench.lib import spec, ycsb  # noqa: E402
from mslbench.lib.outcome import Check, Outcome  # noqa: E402
from mslbench.lib.trace import DeviceOp, Trace  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_loaders_find_each_file_by_name(name):
    cell = spec.cell(name, BENCH)
    entry = next(w for w in BENCH["workloads"] if w["name"] == name)
    conf = next(c for c in BENCH["configs"] if c["name"] == entry["config"])
    assert (ROOT / conf["file"]).is_file()
    assert cell.config["name"] == conf["name"]
    assert sorted(cell.config["reduced"]) == sorted(conf["reduced"])
    assert hasattr(spec.client(cell.traffic["client"]), "run")
    assert [m["name"] for m in cell.end_to_end][0] == "setup_s"
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert callable(spec.metric_reader(m["name"]).read)
        assert m["moves"] in [e["name"] for e in cell.end_to_end]


def test_a_missing_workload_is_refused():
    with pytest.raises(KeyError):
        spec.cell("no-such-cell", BENCH)


def _outcome(trace=None):
    return Outcome(attempted=10, failed=0, metrics={
        "setup_s": 1.5, "cache_qps": 2e8, "cache_batch_p95_ms": 9.0,
        "serve_tokens_per_s": 150.0, "serve_tpot_p95_ms": 60.0},
        checks=[Check("answers_mismatched", 0, limit=0), Check("answers_checked", 5, least=1)],
        info={}, memory_peak_bytes=123, trace=trace)


@pytest.mark.parametrize("name", CELLS)
def test_the_last_line_has_the_contract_shape(name):
    cell = spec.cell(name, BENCH)
    dev = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}
    line = json.loads(json.dumps(bench_run.result_line(cell, _outcome(), False, dev)))
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(set(v) == {"value", "unit"} for v in line["metrics"].values())
    assert line["device"]["memory_peak_bytes"] == 123
    trace = Trace(ops=[DeviceOp("void msl_onepass_kernel<3>", 0.0, 10.0),
                       DeviceOp("void paged_attn_kernel<128>", 10.0, 20.0)],
                  window_s=4e-5, busy_s=2e-5, idle_gaps=[("wait", 2e-5)],
                  counters={"batches": 1, "batch": 8, "distinct_sets": [4], "assoc": 8,
                            "planes": 3, "key_planes": 1, "value_planes": 2,
                            "enqueue_s": [1e-3], "decode_positions": [100],
                            "prefill_skipped": 3, "prefill_computed": 1, "windows": 2,
                            "window_ticks": 6,
                            "arch": spec.load_json("configs", "command-r-35b")})
    line = json.loads(json.dumps(bench_run.result_line(cell, _outcome(trace), True, dev)))
    assert list(line)[-1] == "checks" and "breakdown" in line
    assert set(line["device"]) >= {"busy_s", "window_s"}
    assert set(line["metrics"]) == {m["name"] for m in cell.per_layer}
    assert len(line["breakdown"]["device_ops"]) <= 10


def test_a_failed_check_makes_the_run_incorrect():
    out = _outcome()
    out.checks.append(Check("logit_gap", 2.0, limit=1.0))
    assert not out.correct
    assert not Outcome(1, 0, {}, [], {}, 0).correct


def test_the_seeded_generators_repeat():
    a = ycsb.zipfian(10_000, 5000, 0.99, torch.Generator().manual_seed(2**31 + 7))
    b = ycsb.zipfian(10_000, 5000, 0.99, torch.Generator().manual_seed(2**31 + 7))
    c = ycsb.zipfian(10_000, 5000, 0.99, torch.Generator().manual_seed(2**31 + 8))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert int(a.min()) >= 1 and int(a.max()) <= 10_000
    mix = spec.load_json("traffic", "chat-sysprompt-overload")
    s1, r1 = serve_openloop.schedule(mix, 10.0, 5, 1000)
    s2, r2 = serve_openloop.schedule(mix, 10.0, 5, 1000)
    _, r3 = serve_openloop.schedule(mix, 10.0, 6, 1000)
    assert np.array_equal(s1, s2)
    assert all(x[0] == y[0] and np.array_equal(x[1], y[1]) for x, y in zip(r1, r2))
    # another seed serves the same arrivals, and the same sizes in another order
    assert [x[0] for x in r1] == [x[0] for x in r3]
    for f in (lambda r: len(r[1]), lambda r: r[2]):
        assert sorted(map(f, r1)) == sorted(map(f, r3))
    assert [f(x) for x in r1] != [f(x) for x in r3]


def test_the_counting_functions_at_the_cells_shapes():
    onepass = spec.metric_reader("cache.onepass_roofline")
    # one 2^21-query batch of the cache cell touching 1M distinct sets
    assert onepass.batch_bytes(2**21, 2**20, 8, 3, 1, 2) == 2 * 2**20 * 8 * 3 * 4 + 2**21 * 12 + 2**21 * 28
    arch = spec.load_json("configs", "command-r-35b")
    mfu = spec.metric_reader("serve.decode_mfu")
    matmul = 40 * (8192 * 8192 * 2 + 2 * 8192 * 1024 + 3 * 8192 * 22528) + 8192 * 256000
    assert mfu.token_flops(arch, 0) == 2 * matmul
    assert mfu.token_flops(arch, 600) - mfu.token_flops(arch, 0) == 40 * 4 * 600 * 64 * 128
    assert 2 * matmul == 60_565_749_760
    attn = spec.metric_reader("serve.paged_attn_roofline")
    assert attn.token_bytes(arch, 1) == 40 * 8 * 128 * 2 * 2 == 163_840


def _imports(path: Path) -> set[tuple[str, int]]:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {(a.name.split(".")[0], 0) for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            out.add(((node.module or "").split(".")[0], node.level))
    return out


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "mslbench").rglob("*.py"))
    assert files
    for path in files:
        tops = {name for name, level in _imports(path) if level == 0}
        assert not tops & {"jax", "jaxlib", "flax", "repro"}, path
    for path in sorted((ROOT / "mslbench" / "reference").rglob("*.py")):
        tops = {name for name, level in _imports(path) if level == 0}
        assert "repro_torch" not in tops, path
        assert not {n for n, level in _imports(path) if level > 0}, path


def test_forbidden_modules_compares_whole_names():
    assert bench_run.forbidden_modules(["repro_torch", "repro_torch.core", "reprox",
                                        "jax_like", "torch"]) == []
    assert bench_run.forbidden_modules(["repro.core", "jaxlib.xla", "flax",
                                        "repro_torch"]) == ["flax", "jaxlib", "repro"]
