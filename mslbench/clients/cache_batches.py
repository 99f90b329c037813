"""The closed-loop batch client of a look-aside cache (YCSB core workloads).

One client keeps ``in_flight`` batches of ``batch`` queries on the device:
it issues batch i + in_flight only once batch i's results are complete.
Each query is an ``access`` (a get, and a put of the key's value on a
miss).  Queries come from a pool of ``pool`` keys drawn on the device from
the seed, walked in order and wrapped at the end; every key carries the
value ``value_of(key)``, so a hit's value can be checked.  Set-up warms the
table through the same path with the first ``warm_queries`` of the stream.

The check (``mslbench/reference/msl_lru.py``): a sample of sets drawn from
the seed, with the sets of the hottest ranks, is replayed by the plain
reference over the whole stream the run sent; every ``check.every``-th
window batch keeps the program's answers to those sets' queries, which
must equal the reference's, and the sets' rows at the end must equal its
rows.  The whole table is checked for keys in the wrong set, values not
their key's, and keys held twice.  With ``control`` the reference's
``UnorderedCache`` (``reference/control.py``) serves in the program's place.
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

from mslbench.lib import ycsb
from mslbench.lib.outcome import Check, Outcome, RunContext
from mslbench.lib.stats import median, percentile
from mslbench.lib.trace import Segment, span, warm_profiler
from mslbench.reference.control import UnorderedCache
from mslbench.reference.msl_lru import EMPTY, Replay, SetStream, set_of, value_of

FIELDS = ("hit", "pos", "value", "evicted_key", "evicted_val", "evicted_valid")
HASH_CHUNK = 1 << 26


def build_program(cfg_dict: dict, device):
    """The system under test: the port's cache on its main (one-pass) path."""
    from repro_torch.core import MSLRUConfig, MultiStepLRUCache

    return MultiStepLRUCache(MSLRUConfig(**cfg_dict), engine="onepass", device=device)


class _Done:
    """Completion of an issued batch: a CUDA event, or nothing to wait for."""

    def __init__(self, device):
        self.event = None
        if device.type == "cuda":
            self.event = torch.cuda.Event()
            self.event.record()

    def wait(self):
        if self.event is not None:
            self.event.synchronize()


def _packed(res, idx) -> torch.Tensor:
    """The answers at ``idx`` as one (n, 8) int32 block, in FIELDS order."""
    return torch.cat([res.hit[idx, None].to(torch.int32), res.pos[idx, None],
                      res.value[idx], res.evicted_key[idx, :1], res.evicted_val[idx],
                      res.evicted_valid[idx, None].to(torch.int32)], 1)


def _sets_of_pool(keys: torch.Tensor, num_sets: int) -> torch.Tensor:
    out = torch.empty(keys.shape[0], dtype=torch.int32, device=keys.device)
    for s in range(0, keys.shape[0], HASH_CHUNK):
        out[s:s + HASH_CHUNK] = set_of(keys[s:s + HASH_CHUNK], num_sets).to(torch.int32)
    return out


def run(ctx: RunContext) -> Outcome:
    conf, mix, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    if mix["distribution"] != "zipfian" or mix["op"] != "access":
        raise ValueError(f"cache_batches draws scrambled zipfian access streams, "
                         f"not {mix['distribution']}/{mix['op']}")
    geom = conf["cache"]
    if geom["key_planes"] != 1:
        raise ValueError("cache_batches draws 32-bit keys (key_planes 1)")
    n_sets, batch, pool_n = geom["num_sets"], mix["batch"], mix["pool"]
    if pool_n % batch or mix["warm_queries"] % batch:
        raise ValueError("the pool and the warm-up must be whole batches")
    n_blocks = pool_n // batch
    gen = torch.Generator(device=dev).manual_seed(ctx.seed)

    # -- set-up: the pool, the cache, the warm table ------------------------
    t0 = time.perf_counter()
    keys = ycsb.zipfian(conf["keyspace"], pool_n, mix["alpha"], gen)
    vals = torch.empty((pool_n, geom["value_planes"]), dtype=torch.int32, device=dev)
    for s in range(0, pool_n, HASH_CHUNK):
        vals[s:s + HASH_CHUNK] = value_of(keys[s:s + HASH_CHUNK])
    cache = (UnorderedCache if ctx.control else build_program)(geom, dev)
    warm = mix["warm_queries"] // batch
    for g in range(warm):
        q = slice((g % n_blocks) * batch, (g % n_blocks + 1) * batch)
        cache.access(keys[q], vals[q])
    if dev.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    # -- the check's sample: its sets and, per pool block, the positions kept
    chk = mix["check"]
    rng = np.random.default_rng(ctx.seed)
    hot = set_of(ycsb.rank_key(torch.arange(chk["hot_ranks"]), conf["keyspace"]),
                 n_sets).unique().numpy()
    normal = np.setdiff1d(rng.choice(n_sets, chk["sample_sets"], replace=False), hot)
    sample = np.concatenate([normal, hot])
    sids = _sets_of_pool(keys, n_sets)
    keep = torch.isin(sids, torch.from_numpy(sample).to(dev, torch.int32))
    at_d = keep.nonzero()[:, 0]
    at_sid_d = sids[at_d]
    del sids, keep
    by_set = torch.sort(at_sid_d, stable=True)          # positions stay ascending
    grouped = at_d[by_set.indices].cpu().numpy()
    sorted_sids = by_set.values.cpu().numpy()
    bounds = dict(zip(sample.tolist(), zip(np.searchsorted(sorted_sids, sample, "left"),
                                           np.searchsorted(sorted_sids, sample, "right"))))
    at, at_sid = at_d.cpu().numpy(), at_sid_d.cpu().numpy()
    del at_d, at_sid_d, by_set
    is_hot = np.isin(at_sid, hot)
    per_block, per_block_host = [], []
    for b in range(n_blocks):
        lo, hi = np.searchsorted(at, [b * batch, (b + 1) * batch])
        mine, hotness = at[lo:hi], is_hot[lo:hi]
        hot_at = mine[hotness]
        if len(hot_at) > chk["hot_per_batch"]:
            hot_at = rng.choice(hot_at, chk["hot_per_batch"], replace=False)
        per_block_host.append(np.sort(np.concatenate([mine[~hotness], hot_at])) - b * batch)
        per_block.append(torch.from_numpy(per_block_host[-1]).to(dev))
    phase = int(rng.integers(chk["every"]))

    # -- the window --------------------------------------------------------
    in_flight = collections.deque()
    lat, enqueue_s, kept, traced = [], [], [], None
    n_issued, hits_kept, queries_kept = 0, 0, 0
    trace_left = mix["trace_batches"] if ctx.trace else 0
    seg, seg_first = None, None

    def settle(left: int):
        """Wait until at most ``left`` batches are in flight."""
        while len(in_flight) > left:
            done, t_issue = in_flight.popleft()
            with span("wait"):
                done.wait()
            lat.append((t_issue, time.perf_counter()))

    if dev.type == "cuda":      # the peak is the window's: set-up's transients are gone
        torch.cuda.reset_peak_memory_stats()
        held_at_start = torch.cuda.memory_allocated()
    start = time.perf_counter()
    end = start + ctx.seconds
    while True:
        settle(mix["in_flight"] - 1)
        now = time.perf_counter()
        if now >= end:
            break
        if seg is None and trace_left and now >= start + ctx.seconds / 2:
            # the segment starts on an idle device: its kernels are exactly
            # those of the batches it issues
            settle(0)
            warm_profiler()
            seg, seg_first = Segment().__enter__(), n_issued
        tracing = seg is not None and traced is None
        g = warm + n_issued
        blk = g % n_blocks
        q = slice(blk * batch, (blk + 1) * batch)
        with span("issue"):
            t_issue = time.perf_counter()
            res = cache.access(keys[q], vals[q])
            if seg is None:     # once started, the profiler slows the host
                enqueue_s.append(time.perf_counter() - t_issue)
            if not tracing and n_issued % chk["every"] == phase:
                kept.append((g, blk, _packed(res, per_block[blk]), res.hit.sum()))
            in_flight.append((_Done(dev), t_issue))
        n_issued += 1
        if tracing and n_issued - seg_first >= trace_left:
            settle(0)
            seg.__exit__(None, None, None)
            traced = seg
    settle(0)
    if seg is not None and traced is None:      # the window closed first
        seg.__exit__(None, None, None)
        traced = seg
    memory_peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0

    completed = sum(t_done <= end for _, t_done in lat)
    batch_ms = [1e3 * (d - i) for i, d in lat]
    metrics = {"setup_s": setup_s, "cache_qps": completed * batch / ctx.seconds,
               "cache_batch_p95_ms": percentile(batch_ms, 95)}

    # -- the check ----------------------------------------------------------
    t_check = time.perf_counter()
    total = (warm + n_issued) * batch
    passes, rest = divmod(total, pool_n)

    def stream_of(s):
        a, b = bounds[int(s)]
        pos = grouped[a:b]
        idx = torch.from_numpy(pos).to(dev)
        return SetStream(pos, keys[idx].cpu().numpy(), vals[idx].cpu().numpy())

    replays = {}
    for group in (normal, hot):
        rep = Replay([stream_of(s) for s in group], passes, rest, m=geom["m"],
                     p=geom["p"], value_planes=geom["value_planes"])
        replays.update({int(s): (rep, i) for i, s in enumerate(group)})
    mism, n_checked = 0, 0
    if kept:
        got = torch.cat([k[2] for k in kept]).cpu().numpy()
        hits_kept = int(sum(int(k[3]) for k in kept))
        queries_kept = len(kept) * batch
        pos = np.concatenate([blk * batch + per_block_host[blk] for _, blk, _, _ in kept])
        n_pass = np.concatenate([np.full(len(per_block_host[blk]), (g * batch) // pool_n)
                                 for g, blk, _, _ in kept])
        sid = at_sid[np.searchsorted(at, pos)]
        for s in np.unique(sid):
            a, b = bounds[int(s)]
            mine = sid == s
            occ = n_pass[mine] * (b - a) + np.searchsorted(grouped[a:b], pos[mine])
            rep, i = replays[int(s)]
            mism += _mismatches(got[mine], rep.answers(i, occ))
        n_checked = len(sid)
    table = cache.table
    rows = table[torch.tensor(list(replays), device=dev)].cpu().numpy().astype(np.int64)
    rows_bad = 0
    for row, (rep, i) in zip(rows, replays.values()):
        rows_bad += int(not (np.array_equal(row[:, 0], rep.keys[i])
                             and np.array_equal(row[:, 1:], rep.vals[i])))
    violations = _table_violations(table, n_sets)
    check_s = time.perf_counter() - t_check

    checks = [Check("answers_mismatched", mism, limit=0),
              Check("rows_mismatched", rows_bad, limit=0),
              Check("table_violations", violations, limit=0),
              Check("answers_checked", n_checked, least=chk["min_answers"])]
    occupancy = float((table[:, :, 0] != EMPTY).float().mean())
    info = {"batches": len(lat), "batches_completed_in_window": completed,
            "batch_ms_median": median(batch_ms),
            "enqueue_us_median": 1e6 * median(enqueue_s),
            "hit_ratio_checked_batches": hits_kept / max(1, queries_kept),
            "occupancy": occupancy, "passes_over_pool": passes,
            "rows_checked": len(replays),
            "table_bytes": table.numel() * table.element_size(),
            "pool_bytes": keys.numel() * keys.element_size() + vals.numel() * vals.element_size(),
            "memory_at_window_start_bytes": held_at_start if dev.type == "cuda" else 0,
            "check_s": check_s}
    trace = None
    if traced is not None:
        lo, hi = seg_first, min(n_issued, seg_first + trace_left)
        distinct = [int(set_of(keys[((warm + i) % n_blocks) * batch:
                                    ((warm + i) % n_blocks + 1) * batch], n_sets)
                           .unique().numel()) for i in range(lo, hi)]
        trace = traced.trace(counters={
            "batches": hi - lo, "batch": batch, "distinct_sets": distinct,
            "assoc": geom["m"] * geom["p"],
            "planes": geom["key_planes"] + geom["value_planes"],
            "key_planes": geom["key_planes"], "value_planes": geom["value_planes"],
            "enqueue_s": enqueue_s})
    return Outcome(attempted=n_issued * batch, failed=(n_issued - len(lat)) * batch,
                   metrics=metrics, checks=checks, info=info,
                   memory_peak_bytes=memory_peak, trace=trace)


def _mismatches(got: np.ndarray, ref: dict) -> int:
    """Answers that differ: hit, pos, evicted key and flag always; the value
    where the reference hit; the evicted value where an item left."""
    v = ref["value"].shape[1]
    hit, pos = got[:, 0] != 0, got[:, 1]
    value, ev_key = got[:, 2:2 + v], got[:, 2 + v]
    ev_val, ev_ok = got[:, 3 + v:3 + 2 * v], got[:, 3 + 2 * v] != 0
    rh, rv = ref["hit"] != 0, ref["evicted_valid"] != 0
    bad = ((hit != rh) | (pos != ref["pos"]) | (ev_key != ref["evicted_key"])
           | (ev_ok != rv)
           | (rh & (value != ref["value"]).any(1))
           | (rv & (ev_val != ref["evicted_val"]).any(1)))
    return int(bad.sum())


def _table_violations(table: torch.Tensor, num_sets: int) -> int:
    """Lanes holding a key of another set or a value not its key's, and
    keys held twice in a row, over the whole table."""
    bad = 0
    for s in range(0, table.shape[0], 1 << 18):
        t = table[s:s + (1 << 18)]
        k = t[..., 0]
        full = k != EMPTY
        row = torch.arange(s, s + t.shape[0], device=t.device)[:, None]
        wrong_set = full & (set_of(k, num_sets) != row)
        wrong_val = full & (t[..., 1:] != value_of(k)).any(-1)
        ks = torch.sort(torch.where(full, k.to(torch.int64), -(2**40) - torch.arange(
            k.shape[1], device=t.device)), dim=1).values
        twice = (ks[:, 1:] == ks[:, :-1]).sum()
        bad += int(wrong_set.sum() + wrong_val.sum() + twice)
    return bad
