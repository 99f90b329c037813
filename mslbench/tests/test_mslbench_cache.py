"""The cache cell's harness on the CPU at a tiny size: its reference
against the port, a whole run correct, and the control and each fault the
cell can have coming out not correct."""

import copy
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from mslbench import run as bench_run  # noqa: E402
from mslbench.clients import cache_batches  # noqa: E402
from mslbench.clients.cache_batches import build_program  # noqa: E402
from mslbench.lib import spec  # noqa: E402
from mslbench.reference.msl_lru import EMPTY, Replay, SetStream, transition, value_of  # noqa: E402
from repro_torch.core import MSLRUConfig, MultiStepLRUCache  # noqa: E402
from repro_torch.core.multistep import row_access  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_thread():
    """A run here is a timed window: with one intra-op thread its tiny
    model does not wait on threads that other test workers hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_cell():
    cell = copy.deepcopy(spec.cell("ptr16m.ycsbc-zipf"))
    cell.config["cache"]["num_sets"] = 256
    cell.config["keyspace"] = 20_000
    cell.traffic.update(batch=256, pool=256 * 16, warm_queries=256 * 8)
    cell.traffic["check"].update(every=2, sample_sets=16, hot_per_batch=16, min_answers=10)
    return cell


def test_the_reference_transition_is_the_ports_row_access():
    rng = np.random.default_rng(0)
    n = 4000
    keys = np.stack([rng.permutation(np.arange(1, 40))[:8] for _ in range(n)])
    holes = rng.integers(0, 9, n)
    keys[np.arange(8)[None, :] >= 8 - holes[:, None]] = EMPTY
    vals = rng.integers(-99, 99, (n, 8, 2))
    vals[keys == EMPTY] = 0
    qk, qv = rng.integers(1, 40, n), rng.integers(-99, 99, (n, 2))
    nk, nv, out = transition(keys, vals, qk, qv, 2, 4)
    rows = torch.tensor(np.concatenate([keys[..., None], vals], -1), dtype=torch.int32)
    new, res = row_access(MSLRUConfig(num_sets=1, m=2, p=4), rows,
                          torch.tensor(qk[:, None], dtype=torch.int32),
                          torch.tensor(qv, dtype=torch.int32))
    assert np.array_equal(new[..., 0].numpy(), nk) and np.array_equal(new[..., 1:].numpy(), nv)
    for name in ("hit", "pos", "evicted_valid"):
        assert np.array_equal(getattr(res, name).numpy(), out[name]), name
    assert np.array_equal(res.evicted_key[:, 0].numpy(), out["evicted_key"])
    assert np.array_equal(res.evicted_val.numpy(), out["evicted_val"])
    hit = out["hit"]
    assert np.array_equal(res.value.numpy()[hit], out["value"][hit])


def test_the_replay_is_the_ports_sequential_engine():
    """Long runs of one key (cut to the replay's cap) and the pool's wrap,
    against the port's sequential engine on the whole stream."""
    rng = np.random.default_rng(3)
    num_sets, pool = 4, 600
    base = rng.integers(1, 60, pool // 6)
    keys = np.repeat(base, rng.integers(1, 12, len(base)))[:pool].astype(np.int32)
    keys = np.resize(keys, pool)
    passes, rest = 2, 250
    stream = np.concatenate([keys] * passes + [keys[:rest]])
    cache = MultiStepLRUCache(MSLRUConfig(num_sets=num_sets, m=2, p=4), device="cpu")
    seq = cache.access_seq(torch.from_numpy(stream), torch.from_numpy(value_of(stream)))
    from mslbench.reference.msl_lru import set_of
    sid = set_of(keys, num_sets)
    streams = [SetStream(np.flatnonzero(sid == s), keys[sid == s], value_of(keys[sid == s]))
               for s in range(num_sets)]
    rep = Replay(streams, passes, rest, m=2, p=4, value_planes=2)
    sid_all = set_of(stream, num_sets)
    for s in range(num_sets):
        mine = np.flatnonzero(sid_all == s)
        got = rep.answers(s, np.arange(len(mine)))
        assert np.array_equal(got["hit"] != 0, seq.hit.numpy()[mine])
        assert np.array_equal(got["pos"], seq.pos.numpy()[mine])
        assert np.array_equal(got["evicted_key"], seq.evicted_key[:, 0].numpy()[mine])
        row = cache.table[s].numpy()
        assert np.array_equal(row[:, 0], rep.keys[s]) and np.array_equal(row[:, 1:], rep.vals[s])


def test_the_cell_runs_correct_on_the_cpu():
    out = bench_run.run_cell(tiny_cell(), 2**31 + 12345, 2.0, False, CPU)
    assert out.correct, [c.line() for c in out.checks]
    assert set(out.metrics) == {"setup_s", "cache_qps", "cache_batch_p95_ms"}
    assert out.info["passes_over_pool"] >= 1


class _Frozen:
    """The program whose ``access`` answers but leaves its table as it was."""

    def __init__(self, geom, dev):
        self.cache = build_program(geom, dev)

    @property
    def table(self):
        return self.cache.table

    def access(self, keys, vals):
        saved = self.cache._padded.clone()
        res = self.cache.access(keys, vals)
        self.cache._padded.copy_(saved)
        return res


class _HalfBatch(_Frozen):
    """Half of each batch left out; its answers copied from the other half."""

    def access(self, keys, vals):
        h = keys.shape[0] // 2
        res = self.cache.access(keys[:h], vals[:h])
        return type(res)(*[torch.cat([x, x]) for x in res])


class _AlteredAnswer(_Frozen):
    """An answer altered where it is produced: every seventh value."""

    def access(self, keys, vals):
        res = self.cache.access(keys, vals)
        res.value[::7, 0] += 1
        return res


@pytest.mark.parametrize("fault", [_Frozen, _HalfBatch, _AlteredAnswer],
                         ids=["state-unchanged", "half-batch", "answer-altered"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    monkeypatch.setattr(cache_batches, "build_program", fault)
    out = bench_run.run_cell(tiny_cell(), 7, 1.0, False, CPU)
    # an exact comparison fails, not merely too few answers compared
    assert any(not c.ok for c in out.checks if c.name != "answers_checked"), \
        [c.line() for c in out.checks]


def test_the_control_is_not_correct():
    out = bench_run.run_cell(tiny_cell(), 9, 1.0, False, CPU, control=True)
    assert not out.correct
    assert {c.name: c.value for c in out.checks}["answers_mismatched"] > 0
