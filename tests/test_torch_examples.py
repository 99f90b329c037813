"""The port's examples (``examples/torch_*.py``) on the CPU against their JAX
twins (``examples/*.py``), run in process at the same seeds (the
distributed one in a child process: JAX's example needs 8 host devices
before JAX starts).

- Integer results are equal: hits, evictions, occupancy, served counts,
  table equality with the oracle, prefill tokens computed and skipped, the
  prefix cache's stats.
- ``chip_smoke.py`` phase 32 holds the card's runs to ``EXAMPLE_RESULTS``,
  the CPU's numbers; here they are held to the JAX examples at full size.
- The plain (CPU) one-pass resolver takes minutes on the cold 200k-query
  batch of the quickstart, so the port's quickstart and distributed cache
  run here at a cut trace (the examples' ``zipfian`` capped at
  ``CUT_QUERIES`` queries, on both sides); the full-size JAX quickstart
  (5-9 min) and the port's full-size distributed cache (1-4 min) are
  ``slow``.
- train_smoke: both examples resume from JAX's initial state (saved as
  step 0) and run ``SMOKE_STEPS`` steps; the logged losses are within
  ``test_torch_train_loop.py``'s HISTORY_RTOL.
"""

import ast
import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
CUT_QUERIES = 2048
SMOKE_STEPS = 20


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _example(name: str):
    """``examples/<name>.py`` as a module (its ``main`` not run)."""
    spec = importlib.util.spec_from_file_location(f"example_{name}", ROOT / "examples" /
                                                  f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _expected():
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    return chip_smoke.EXAMPLE_RESULTS


def _cut(mod, monkeypatch, n: int = CUT_QUERIES):
    """The example's trace cut to its first ``n`` queries' draw: ``zipfian``
    asked for at most ``n`` queries."""
    zipfian = mod.zipfian
    monkeypatch.setattr(mod, "zipfian", lambda n_keys, n_queries, alpha=0.99, seed=0:
                        zipfian(n_keys, min(n_queries, n), alpha=alpha, seed=seed))


def _jax_quickstart(monkeypatch, n=None) -> dict:
    """JAX's quickstart in process, its two ``access`` calls recorded."""
    import numpy as np

    from repro.core import MultiStepLRUCache

    calls, caches = [], []
    access = MultiStepLRUCache.access

    def recording(self, *a, **kw):
        res = access(self, *a, **kw)
        calls.append(res)
        caches.append(self)
        return res

    monkeypatch.setattr(MultiStepLRUCache, "access", recording)
    mod = _example("quickstart")
    if n is not None:
        _cut(mod, monkeypatch, n)
    mod.main()
    first, again = calls
    hit2 = np.asarray(again.hit)
    return {"capacity": caches[0].cfg.capacity, "queries": int(np.asarray(first.hit).size),
            "hits": int(np.asarray(first.hit).sum()), "occupancy": caches[0].occupancy,
            "reaccess_hits": int(hit2.sum()),
            "evictions": int(np.asarray(first.evicted_valid).sum())}


def _integer_results(rec: dict, keys) -> dict:
    return {k: rec[k] for k in keys}


QUICKSTART_KEYS = ("capacity", "queries", "hits", "occupancy", "reaccess_hits", "evictions")


def test_quickstart_matches_jax_at_a_cut_trace(monkeypatch, capsys):
    mod = _example("torch_quickstart")
    _cut(mod, monkeypatch)
    got = mod.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "value integrity on re-access: OK" in out and got["value_integrity"]
    want = _jax_quickstart(monkeypatch, CUT_QUERIES)
    jout = capsys.readouterr().out
    assert "value integrity on re-access: OK" in jout
    assert _integer_results(got, QUICKSTART_KEYS) == want
    # the printed lines are the JAX example's
    assert out.splitlines() == jout.splitlines()


@pytest.mark.slow
def test_quickstart_results_are_the_jax_examples(monkeypatch, capsys):
    """JAX's quickstart at full size against ``EXAMPLE_RESULTS`` (what the
    card's run must give), printed lines too."""
    want = _expected()["quickstart"]
    got = _jax_quickstart(monkeypatch)
    assert got == _integer_results(want, QUICKSTART_KEYS)
    assert "value integrity on re-access: OK" in capsys.readouterr().out


_JAX_DISTRIBUTED = """
import importlib.util, json, sys
spec = importlib.util.spec_from_file_location("dc", sys.argv[1])
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)          # sets XLA_FLAGS before JAX starts
mod.main()
zipfian = mod.zipfian
mod.zipfian = lambda n_keys, n_queries, alpha=0.99, seed=0: zipfian(
    n_keys, min(n_queries, int(sys.argv[2])), alpha=alpha, seed=seed)
print("--- cut")
mod.main()
"""


def _distributed_lines(text: str) -> dict:
    m = re.search(r"sharded: hits=(\d+) served=(\d+)/(\d+)", text)
    return {"hits": int(m[1]), "served": int(m[2]), "queries": int(m[3]),
            "oracle_hits": int(re.search(r"oracle hits: (\d+)", text)[1]),
            "table_identical": "final table state identical: YES" in text}


@pytest.fixture(scope="module")
def jax_distributed():
    """JAX's distributed cache example at full size, then at the cut trace,
    in one child process (8 host devices)."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _JAX_DISTRIBUTED,
                          str(ROOT / "examples" / "distributed_cache.py"), str(CUT_QUERIES)],
                         env=env, capture_output=True, text=True, timeout=600, check=True).stdout
    full, cut = out.split("--- cut")
    return {"full": _distributed_lines(full), "cut": _distributed_lines(cut),
            "full_text": full, "cut_text": cut}


DISTRIBUTED_KEYS = ("queries", "hits", "served", "oracle_hits", "table_identical")


def test_distributed_cache_matches_jax_at_a_cut_trace(jax_distributed, monkeypatch, capsys):
    """The port's 8 logical shards on one device against JAX's 8 devices at
    the cut trace; JAX's full-size run gives ``EXAMPLE_RESULTS``."""
    assert _integer_results(_expected()["distributed_cache"], DISTRIBUTED_KEYS) == \
        jax_distributed["full"]
    mod = _example("torch_distributed_cache")
    _cut(mod, monkeypatch)
    got = mod.main(["--device", "cpu"])
    assert _integer_results(got, DISTRIBUTED_KEYS) == jax_distributed["cut"]
    assert got["table_identical"] and got["hits"] == got["oracle_hits"]
    out = capsys.readouterr().out
    assert out.splitlines()[1:] == jax_distributed["cut_text"].strip().splitlines()[1:]


@pytest.mark.slow
def test_distributed_cache_at_full_size(jax_distributed):
    got = _example("torch_distributed_cache").main(["--device", "cpu"])
    assert _integer_results(got, DISTRIBUTED_KEYS) == jax_distributed["full"]


def _serve_lines(text: str) -> dict:
    m = re.search(r"\[with prefix cache\] .*; prefill computed=(\d+) skipped=(\d+)", text)
    stats = ast.literal_eval(re.search(r"cache stats: (\{.*\})", text)[1])
    return {"prefill_computed": int(m[1]), "prefill_skipped": int(m[2]),
            "prefill_computed_without": int(re.search(
                r"\[without\] .*; prefill computed=(\d+)", text)[1]),
            "cache_stats": stats}


def test_serve_prefix_cache_matches_jax(monkeypatch, capsys):
    """phi3-mini-smoke, 24 requests over 8 templates, with the prefix cache
    and pool (the port's engine paged) and without: the served requests and
    tokens, prefill computed and skipped and the cache's stats (JAX's keys;
    the port adds ``device_calls``) equal JAX's contiguous engine's, and
    ``EXAMPLE_RESULTS``."""
    from repro.serving.engine import ServeEngine as JaxServeEngine

    served = []
    run = JaxServeEngine.run_until_done

    def recording(self, *a, **kw):
        out = run(self, *a, **kw)
        served.append((len(self.finished), sum(len(r.out_tokens) for r in self.finished)))
        return out

    monkeypatch.setattr(JaxServeEngine, "run_until_done", recording)
    _example("serve_prefix_cache").main()
    want = _serve_lines(capsys.readouterr().out)
    want.update(served=served[0][0], tokens=served[0][1], served_without=served[1][0],
                tokens_without=served[1][1])
    got = _example("torch_serve_prefix_cache").main(["--device", "cpu"])
    printed = _serve_lines(capsys.readouterr().out)
    assert printed == {k: got[k] for k in printed}
    stats = got["cache_stats"]
    assert set(stats) == set(want["cache_stats"]) | {"device_calls"}
    assert {k: stats[k] for k in want["cache_stats"]} == want["cache_stats"]
    for k in ("served", "tokens", "served_without", "tokens_without", "prefill_computed",
              "prefill_skipped", "prefill_computed_without"):
        assert got[k] == want[k], k
    expected = _expected()["serve_prefix_cache"]
    assert {k: got[k] for k in expected} == expected


def test_train_smoke_matches_jax(tmp_path, monkeypatch, capsys):
    """Both examples resume from JAX's fresh state (saved as step 0 when the
    JAX example makes it) and run SMOKE_STEPS steps: the port's logged losses
    within HISTORY_RTOL of JAX's, the learning rate within LR_RTOL."""
    import numpy as np

    from repro.train import checkpoint as jckpt
    from repro.train.trainer import Trainer as JaxTrainer
    from test_torch_train_loop import HISTORY_RTOL, LR_RTOL

    start = tmp_path / "start"
    init_state, run = JaxTrainer.init_state, JaxTrainer.run
    hist = []

    def saving(self, resume=True):
        mode = init_state(self, resume)
        if mode == "fresh":
            jckpt.save(start, 0, {"params": self.params, "opt": self.opt_state})
        return mode

    def recording(self, *a, **kw):
        hist.extend(run(self, *a, **kw))
        return hist

    monkeypatch.setattr(JaxTrainer, "init_state", saving)
    monkeypatch.setattr(JaxTrainer, "run", recording)
    monkeypatch.setattr(sys, "argv", ["train_smoke.py", "--steps", str(SMOKE_STEPS),
                                      "--ckpt-dir", str(tmp_path / "jax")])
    _example("train_smoke").main()
    capsys.readouterr()
    got = _example("torch_train_smoke").main(["--steps", str(SMOKE_STEPS), "--ckpt-dir",
                                             str(start), "--device", "cpu"])
    out = capsys.readouterr().out
    assert got["state"] == "resumed" and got["start_step"] == 0 and "state: resumed" in out
    assert [h["step"] for h in got["history"]] == [h["step"] for h in hist] == [1, SMOKE_STEPS]
    for h, w in zip(got["history"], hist):
        np.testing.assert_allclose(h["loss"], w["loss"], rtol=HISTORY_RTOL)
        np.testing.assert_allclose(h["lr"], w["lr"], rtol=LR_RTOL)
    assert (got["loss_first"], got["loss_last"]) == (got["history"][0]["loss"],
                                                     got["history"][-1]["loss"])
