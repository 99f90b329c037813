"""The open-loop client of a served decoder: independent users behind
shared system prompts (chat and RAG behind a few templates).

Requests arrive by a Poisson process at ``rate_per_s``.  Each prompt is
one of ``system_prompts`` prompts of ``system_tokens`` tokens, picked by
Zipf(``zipf``) popularity, then a user suffix of ``suffix_tokens`` (uniform
between the bounds); each asks for ``new_tokens`` (uniform between the
bounds) greedy tokens; with random weights there is no end token.  Every
seed serves the same arrival times and the same sizes (drawn once from a
fixed generator), and the same ``system_prompts``, as a deployment keeps
its templates; a seed shuffles the sizes and prompt picks within each
block of ``order_block`` consecutive requests and draws the suffixes'
token ids (and the weights), so that seeds differ in what they compute
and not in how much, over any whole number of blocks.

Set-up makes the weights on the card from the seed (one draw per layer),
builds the program's ``ServeEngine`` with its paged KV pool and prefix
cache (``engine`` in the mix), captures every megastep bucket the engine
can plan, and serves each system prompt once, so that the prefix cache is
warm as in a running deployment.  The window then offers the requests on
their schedule.  It ends with the first engine step that returns after
``--seconds``: ``serve_tokens_per_s`` is every token the window's requests
were served over that whole length; ``serve_tpot_p95_ms`` the tail, over
the requests finished in it, of (last token - first token) / (tokens - 1).
Time to first token is timed from the scheduled arrival and printed with
the counts; it is not a metric of a mix offered above the knee, whose
queue grows all through the window.

The check (``mslbench/reference/decoder.py``): once the window has closed
and the engine is freed, a sample of the finished requests drawn from
the seed (the one with the most served tokens among them) is run through
the plain float32 forward over its prompt and served tokens; the number
compared is the widest gap by which a served token's reference logit lies
below the reference's best logit at that position.  With ``control`` the
float8 control's first choice at each of those positions takes the served
token's place under the same check and limit.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from mslbench.lib.outcome import Check, Outcome, RunContext
from mslbench.lib.stats import median, percentile
from mslbench.lib.trace import Segment, span, warm_profiler
from mslbench.reference import decoder as ref_decoder

BASE_SEED = 20241018      # the one draw of sizes and gaps every seed shares


def arch_config(arch: dict):
    """The program's ``ArchConfig`` of a configuration file's keys."""
    from repro_torch.configs.base import ArchConfig

    port = arch["port"]
    return ArchConfig(name=arch["name"], family=port["family"],
                      n_layers=arch["num_hidden_layers"], d_model=arch["hidden_size"],
                      n_heads=arch["num_attention_heads"],
                      n_kv_heads=arch["num_key_value_heads"], d_ff=arch["intermediate_size"],
                      vocab_size=arch["vocab_size"], rope_theta=float(arch["rope_theta"]),
                      norm_eps=arch["layer_norm_eps"], ffn=port["ffn"],
                      parallel_block=port["parallel_block"], norm=port["norm"],
                      tie_embeddings=arch["tie_word_embeddings"])


def make_weights(arch: dict, gen: torch.Generator) -> dict:
    """Random weights on ``gen``'s device in the served type (bf16
    matrices, f32 norms): one normal draw per layer, cut into its
    matrices, each scaled by 1/sqrt(d_in); the embedding (and an untied
    head) at 0.02.  LayerNorms start at scale 1, bias 0."""
    d, ff = arch["hidden_size"], arch["intermediate_size"]
    dh = d // arch["num_attention_heads"]
    hq, hk = arch["num_attention_heads"] * dh, arch["num_key_value_heads"] * dh
    shapes = {"attn": {"wq": (d, hq), "wk": (d, hk), "wv": (d, hk), "wo": (hq, d)},
              "mlp": {"w_gate": (d, ff), "w_up": (d, ff), "w_down": (ff, d)}}
    per_layer = sum(a * b for part in shapes.values() for a, b in part.values())
    dev = gen.device

    def norm():
        return {"scale": torch.ones(d, device=dev), "bias": torch.zeros(d, device=dev)}

    def draw(n):
        return torch.randn(n, dtype=torch.bfloat16, device=dev, generator=gen)

    blocks = []
    for _ in range(arch["num_hidden_layers"]):
        flat, at, blk = draw(per_layer), 0, {"ln1": norm()}
        for part, mats in shapes.items():
            blk[part] = {}
            for name, (a, b) in mats.items():
                w = flat[at:at + a * b].view(a, b)
                blk[part][name] = w.mul_(a ** -0.5)
                at += a * b
        blocks.append(blk)
    head = {"embed": draw(arch["vocab_size"] * d).view(-1, d).mul_(0.02), "out_norm": norm()}
    if not arch["tie_word_embeddings"]:
        head["lm_head"] = draw(arch["vocab_size"] * d).view(-1, d).mul_(0.02)
    return {"head": head, "blocks": blocks}


def build_program(arch: dict, weights: dict, engine: dict, device):
    """The system under test: the port's ``ServeEngine`` over the weights."""
    from repro_torch.models.model import ParamTree, make_model
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.kv_cache import PagedKVPool
    from repro_torch.serving.prefix_cache import PrefixCache

    cfg = arch_config(arch)
    pc = engine["prefix_cache"]
    pool = PagedKVPool(cfg, n_pages=engine["pool_pages"], page_tokens=pc["chunk_tokens"],
                       device=device)
    cache = PrefixCache(num_sets=pc["num_sets"], m=pc["m"], p=pc["p"],
                        chunk_tokens=pc["chunk_tokens"], device=device)
    return ServeEngine(make_model(cfg), ParamTree(weights), slots=engine["slots"],
                       max_len=engine["max_len"], prefix_cache=cache, pool=pool,
                       decode_mode=engine["decode_mode"], kv_mode=engine["kv_mode"],
                       max_window=engine["max_window"])


def schedule(mix: dict, seconds: float, seed: int, vocab: int):
    """(system prompts, requests as (arrival s, prompt, new tokens))."""
    n = math.ceil(mix["rate_per_s"] * seconds * 1.5) + 16
    base = np.random.default_rng(BASE_SEED)
    gaps = base.exponential(1.0 / mix["rate_per_s"], n)
    ranks = np.arange(1, mix["system_prompts"] + 1, dtype=np.float64) ** -mix["zipf"]
    picks = base.choice(mix["system_prompts"], n, p=ranks / ranks.sum())
    suffix = base.integers(mix["suffix_tokens"][0], mix["suffix_tokens"][1] + 1, n)
    new = base.integers(mix["new_tokens"][0], mix["new_tokens"][1] + 1, n)
    # the deployment's templates: the same system prompts under every seed,
    # so that where their chunks fall in the prefix cache's sets, and so how
    # many of them it keeps, is the cell's and not the seed's
    systems = base.integers(1, vocab, (mix["system_prompts"], mix["system_tokens"]))
    rng = np.random.default_rng(seed)
    picks, suffix, new = (_within_blocks(x, mix["order_block"], rng)
                          for x in (picks, suffix, new))
    arrivals = np.cumsum(gaps) - gaps[0]
    reqs = [(float(arrivals[i]),
             np.concatenate([systems[picks[i]], rng.integers(1, vocab, suffix[i])]).astype(np.int32),
             int(new[i])) for i in range(n)]
    return systems.astype(np.int32), reqs


def _within_blocks(x: np.ndarray, block: int, rng) -> np.ndarray:
    """``x`` with each run of ``block`` consecutive entries shuffled."""
    out = x.copy()
    for s in range(0, len(x), block):
        out[s:s + block] = rng.permutation(x[s:s + block])
    return out


def capture_buckets(eng) -> None:
    """Capture every megastep bucket the engine can plan (powers of two up
    to ``max_window``), so that nothing is captured inside the window."""
    if eng.device.type != "cuda" or eng.decode_mode != "megastep":
        return
    k = 1
    while k <= eng.max_window:
        eng.capture_window(k)
        k *= 2


def run(ctx: RunContext) -> Outcome:
    from repro_torch.serving.engine import Request

    arch, mix, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    gen = torch.Generator(device=dev).manual_seed(ctx.seed)
    systems, reqs = schedule(mix, ctx.seconds, ctx.seed, arch["vocab_size"])

    # -- set-up: weights, engine, captured windows, warm prefix cache -------
    t0 = time.perf_counter()
    weights = make_weights(arch, gen)
    eng = build_program(arch, weights, mix["engine"], dev)
    capture_buckets(eng)
    for i, prompt in enumerate(systems):
        eng.submit(Request(rid=-1 - i, prompt=prompt, max_new_tokens=2))
    eng.run_until_done()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    # -- the window --------------------------------------------------------
    st0 = eng.stats()
    n_warm = len(eng.finished)
    objs = [Request(rid=i, prompt=p, max_new_tokens=n) for i, (_, p, n) in enumerate(reqs)]
    first, last, submitted = {}, {}, {}
    seg, traced, seg_tokens, seg_prefill = None, None, [], 0
    trace_s = mix["trace_seconds"] if ctx.trace else 0.0
    nxt, half_queue = 0, None
    if dev.type == "cuda":      # the peak is the window's: set-up's transients are gone
        torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    end = start + ctx.seconds
    due = [start + a for a, _, _ in reqs]
    while True:
        now = time.perf_counter()
        if seg is not None and traced is None and now >= seg_start + trace_s:
            seg.__exit__(None, None, None)
            traced = seg
        if now >= end:
            stop = now      # the first step that returned after the end
            break
        if seg is None and trace_s and now >= start + ctx.seconds / 2:
            warm_profiler()
            seg, seg_start = Segment().__enter__(), time.perf_counter()
        if half_queue is None and now >= start + ctx.seconds / 2:
            half_queue = len(eng.queue) + len(eng.retry_queue)
        while nxt < len(objs) and due[nxt] <= now:
            with span("submit"):
                eng.submit(objs[nxt])
            submitted[nxt] = now
            nxt += 1
        if not (eng.queue or eng.retry_queue or eng.active):
            with span("idle"):
                time.sleep(max(0.0, min(due[nxt] if nxt < len(objs) else end, end) - now))
            continue
        before = {r.rid: len(r.out_tokens) for r in eng.active.values()}
        n_fin = len(eng.finished)
        with span("step"):
            eng.step()
        t = time.perf_counter()
        tracing = seg is not None and traced is None
        for r in list(eng.active.values()) + eng.finished[n_fin:]:
            if r.out_tokens and r.rid not in first:
                first[r.rid] = t
                if tracing:
                    seg_prefill += r.prefill_computed
            if tracing:         # the positions each decoded token attended over
                for j in range(max(1, before.get(r.rid, 0)), len(r.out_tokens)):
                    seg_tokens.append(len(r.prompt) + j)
        for r in eng.finished[n_fin:]:
            last[r.rid] = t
    if seg is not None and traced is None:
        seg.__exit__(None, None, None)
        traced = seg
    memory_peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0

    ttft = [1e3 * (first.get(i, end) - due[i]) for i in range(nxt)]
    served = sum(len(objs[i].out_tokens) for i in range(nxt))
    done = [r for r in eng.finished[n_warm:]]
    tpot = [1e3 * (last[r.rid] - first[r.rid]) / (len(r.out_tokens) - 1)
            for r in done if len(r.out_tokens) > 1]
    st1 = eng.stats()
    windows = st1["megastep_windows"] - st0["megastep_windows"]
    window_ticks = (st1["mean_window"] * st1["megastep_windows"]
                    - st0["mean_window"] * st0["megastep_windows"])
    admitted = [objs[i] for i in range(nxt) if objs[i].admit_tick >= 0]
    skipped = sum(r.prefill_skipped for r in admitted)
    computed = sum(r.prefill_computed for r in admitted)
    metrics = {"setup_s": setup_s, "serve_tokens_per_s": served / (stop - start),
               "serve_tpot_p95_ms": percentile(tpot, 95) if tpot else float("nan")}
    lag = [submitted[i] - due[i] for i in range(nxt)]
    info = {"requests_due": nxt, "requests_finished": len(done),
            "requests_first_token": len(first), "backlog_at_end": nxt - len(done),
            "queued_at_half": half_queue,
            "queued_at_end": len(eng.queue) + len(eng.retry_queue),
            "ttft_ms_median": median(ttft) if ttft else None,
            "ttft_ms_p95": percentile(ttft, 95) if ttft else None,
            "tpot_ms_median": median(tpot) if tpot else None,
            "tokens_served": served, "window_s": stop - start,
            "generator_late_ms_median": 1e3 * median(lag) if lag else None,
            "generator_late_ms_max": 1e3 * max(lag) if lag else None,
            "prefill_skipped": skipped, "prefill_computed": computed,
            "megastep_windows": windows, "rate_per_s": mix["rate_per_s"]}
    trace = None
    if traced is not None:
        trace = traced.trace(counters={
            "decode_positions": seg_tokens, "prefill_tokens": seg_prefill,
            "prefill_skipped": skipped, "prefill_computed": computed,
            "windows": windows, "window_ticks": window_ticks, "arch": arch})

    # -- the check: the engine freed first, then the reference -------------
    sample = _sample(done, mix["check"]["requests"], ctx.seed)
    del eng
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    gap, program_gap, n_tokens = _logit_gaps(weights, arch, sample, dev, ctx.control)
    info.update(check_s=time.perf_counter() - t_check, tokens_checked=n_tokens)
    if program_gap is not None:
        info["program_logit_gap"] = program_gap
    checks = [Check("logit_gap", gap, limit=mix["check"]["logit_gap_limit"]),
              Check("tokens_checked", n_tokens, least=mix["check"]["min_tokens"])]
    return Outcome(attempted=nxt, failed=0, metrics=metrics, checks=checks, info=info,
                   memory_peak_bytes=memory_peak, trace=trace)


def _sample(done, n: int, seed: int):
    """The finished request with the most served tokens, and n - 1 others
    drawn from the seed."""
    if not done:
        return []
    longest = max(range(len(done)), key=lambda i: len(done[i].out_tokens))
    rest = [i for i in range(len(done)) if i != longest]
    pick = np.random.default_rng(seed).permutation(rest)[: n - 1].tolist()
    return [done[i] for i in [longest] + pick]


def _logit_gaps(weights, arch, sample, dev, control: bool):
    """(widest gap below the reference's best over the tokens judged, the
    program's own widest gap where the control's were judged or None,
    tokens compared).  Without ``control`` the tokens judged are the served
    ones; with it, at the same positions, the float8 control's first
    choices, which the check then fails or passes as it would the program's."""
    if not sample:
        return float("inf"), None, 0
    seqs, at, served = [], [], []
    for r in sample:
        toks = np.concatenate([r.prompt, np.asarray(r.out_tokens[:-1], np.int32)])
        seqs.append(torch.from_numpy(toks.astype(np.int64)).to(dev))
        at.append(torch.arange(len(r.prompt) - 1, len(toks), device=dev))
        served.append(torch.tensor(r.out_tokens, dtype=torch.int64, device=dev))
    ref = ref_decoder.logits_at(weights, arch, seqs, at)

    def widest(tokens):
        return max(float((lg.max(-1).values - lg.gather(1, t[:, None])[:, 0]).max())
                   for lg, t in zip(ref, tokens))

    n = sum(len(s) for s in served)
    if not control:
        return widest(served), None, n
    low = ref_decoder.logits_at(weights, arch, seqs, at, fp8=True)
    return widest([lg.argmax(-1) for lg in low]), widest(served), n
