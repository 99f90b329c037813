"""The serve cell's harness on the CPU at a tiny size: its reference
against the port's model, a whole run correct, and the control and each
fault the cell can have coming out not correct."""

import copy
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from mslbench import run as bench_run  # noqa: E402
from mslbench.clients import serve_openloop  # noqa: E402
from mslbench.lib import spec  # noqa: E402
from mslbench.reference import decoder  # noqa: E402
from repro_torch.models.model import ParamTree, make_model  # noqa: E402
from repro_torch.serving import engine as engine_mod  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_thread():
    """A run here is a timed window: with one intra-op thread its tiny
    model does not wait on threads that other test workers hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
# over eight seeds at this size the program's widest gap read 0.0-0.0093
# and the float8 control's 0.0633-0.1208
TINY_LIMIT = 0.025


def serve_cell():
    """The serve cell as its files define it.  It is not in BENCHMARK.json
    while the program's page refcount fault crashes it on the card; its
    configuration, mix, client and readers stay, found by name."""
    return spec.Cell(name="cmdr35b.chat-sysprompt", chips=1,
                     config=spec.load_json("configs", "command-r-35b"),
                     traffic=spec.load_json("traffic", "chat-sysprompt-overload"),
                     end_to_end=[], per_layer=[])


def test_the_serve_cells_files_are_found_by_name():
    cell = serve_cell()
    assert cell.config["name"] == "command-r-35b"
    assert spec.client(cell.traffic["client"]) is serve_openloop
    for name in ("serve.prefill_skip_share", "serve.mean_window", "serve.decode_mfu",
                 "serve.paged_attn_roofline", "serve.device_idle"):
        assert callable(spec.metric_reader(name).read), name


def tiny_cell():
    cell = copy.deepcopy(serve_cell())
    cell.config.update(hidden_size=256, intermediate_size=512, num_hidden_layers=2,
                       num_attention_heads=4, num_key_value_heads=1, vocab_size=2048)
    cell.traffic.update(rate_per_s=20.0, system_prompts=4, system_tokens=48,
                        suffix_tokens=[4, 40], new_tokens=[3, 8])
    cell.traffic["engine"].update(slots=4, max_len=96, pool_pages=64)
    # 32 sampled requests (the cell samples 8 of far longer ones): the widest
    # gap over fewer tiny requests lets the control read as low as 0.022
    cell.traffic["check"].update(requests=32, min_tokens=5, logit_gap_limit=TINY_LIMIT)
    return cell


def test_the_reference_forward_is_the_ports_model():
    arch = tiny_cell().config
    weights = serve_openloop.make_weights(arch, torch.Generator().manual_seed(4))
    model = make_model(serve_openloop.arch_config(arch))
    tokens = torch.randint(1, arch["vocab_size"], (1, 40), generator=torch.Generator().manual_seed(5))
    last, _ = model.prefill(ParamTree(weights), {"tokens": tokens})
    ref = decoder.logits_at(weights, arch, [tokens[0]], [torch.tensor([39])])[0]
    scale = float(ref.abs().max())
    assert float((last.float() - ref).abs().max()) < 0.03 * scale
    assert int(last.argmax()) == int(ref.argmax()) or float(ref.max() - ref[0, last.argmax()]) < 0.01


# the window is wall-clock time: long enough that a few requests finish
# on a CPU shared with other test workers
WINDOW_S = 3.0


def test_the_cell_runs_correct_on_the_cpu():
    out = bench_run.run_cell(tiny_cell(), 2**31 + 5, WINDOW_S, False, CPU)
    assert out.correct, [c.line() for c in out.checks]
    assert set(out.metrics) == {"setup_s", "serve_tokens_per_s", "serve_tpot_p95_ms"}
    assert out.metrics["serve_tokens_per_s"] > 0
    # each finished request was served at least the mix's fewest new tokens
    assert out.info["tokens_served"] >= 3 * out.info["requests_finished"]
    assert out.info["requests_finished"] > 0


def _kv_left_unwritten(monkeypatch):
    """Decode returns the KV tails as they were: no step's KV is kept."""
    step = engine_mod.paged_decode_step

    def frozen(cfg, params, tokens, tail, *args, **kw):
        saved = {k: v.clone() for k, v in tail.items()}
        out = step(cfg, params, tokens, tail, *args, **kw)
        for k, v in saved.items():
            tail[k].copy_(v)
        return out

    monkeypatch.setattr(engine_mod, "paged_decode_step", frozen)


def _half_the_rows(monkeypatch):
    """Half of each decode batch's rows answered from the other half: each
    row gets the logits of the row half a batch away, so a request's tokens
    come from another slot whichever slot it holds."""
    step = engine_mod.paged_decode_step

    def half(*args, **kw):
        logits, cache = step(*args, **kw)
        return torch.roll(logits, logits.shape[0] // 2, 0), cache

    monkeypatch.setattr(engine_mod, "paged_decode_step", half)


def _token_altered(monkeypatch):
    """A token altered where it is produced: every third emitted token."""
    emit = engine_mod.ServeEngine._emit
    seen = [0]

    def altered(self, req, tok):
        seen[0] += 1
        emit(self, req, (tok + 1) % self.cfg.vocab_size if seen[0] % 3 == 0 else tok)

    monkeypatch.setattr(engine_mod.ServeEngine, "_emit", altered)


@pytest.mark.parametrize("fault", [_kv_left_unwritten, _half_the_rows, _token_altered],
                         ids=["state-unchanged", "half-batch", "token-altered"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    out = bench_run.run_cell(tiny_cell(), 11, WINDOW_S, False, CPU)
    gap = next(c for c in out.checks if c.name == "logit_gap")
    assert not gap.ok, [c.line() for c in out.checks]


def test_the_control_is_not_correct():
    out = bench_run.run_cell(tiny_cell(), 3, WINDOW_S, False, CPU, control=True)
    assert not out.correct
    gap = next(c for c in out.checks if c.name == "logit_gap")
    assert not gap.ok and gap.value > TINY_LIMIT, [c.line() for c in out.checks]
    # the program, on the same requests, is within the limit
    assert out.info["program_logit_gap"] <= TINY_LIMIT


def test_the_fp8_rounding_keeps_the_largest_magnitude():
    x = torch.tensor([[1.0, -3.0, 0.1], [200.0, 5.0, -0.5]])
    y = decoder._fp8(x, dim=-1)
    assert torch.allclose(y.abs().amax(-1), x.abs().amax(-1))
    assert not torch.equal(y, x)
    assert np.allclose(y.numpy(), x.numpy(), rtol=0.07, atol=0.02)
