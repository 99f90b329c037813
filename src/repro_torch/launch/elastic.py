"""Fault tolerance and elasticity at the launcher level.

Port of ``repro.launch.elastic`` (host code, copied so that the port
imports nothing of the JAX package).  Training: ``Heartbeater`` (each host
touches a heartbeat file per step), ``Watchdog`` (which hosts are alive),
``StragglerTracker`` (hosts persistently slower than the median) and
``plan_remesh`` (the largest (data, model) grid for the surviving devices).
Serving: ``plan_cache_remesh``, ``FaultEvent`` and ``FaultPlan``;
``ServeEngine.run_until_done(fault_plan=)`` applies a plan's events at tick
boundaries.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from pathlib import Path

import numpy as np

__all__ = ["Heartbeater", "Watchdog", "StragglerTracker", "plan_remesh",
           "plan_cache_remesh", "FaultEvent", "FaultPlan"]


class Heartbeater:
    def __init__(self, dir_: str | Path, host_id: int):
        self.path = Path(dir_) / f"host_{host_id}.hb"
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def beat(self, step: int):
        tmp = self.path.with_suffix(".tmp")
        tmp.write_text(json.dumps({"step": step, "t": time.time()}))
        os.replace(tmp, self.path)


class Watchdog:
    """Coordinator-side: which hosts are alive; who to evict."""

    def __init__(self, dir_: str | Path, n_hosts: int, dead_after: float = 120.0):
        self.dir = Path(dir_)
        self.n_hosts = n_hosts
        self.dead_after = dead_after

    def alive(self) -> list[int]:
        now = time.time()
        out = []
        for h in range(self.n_hosts):
            p = self.dir / f"host_{h}.hb"
            if p.exists():
                # a corrupt / partially-written / wrong-shape heartbeat is
                # indistinguishable from a crashed writer: treat the host
                # as dead, never raise out of the watchdog loop
                try:
                    rec = json.loads(p.read_text())
                    if now - float(rec["t"]) <= self.dead_after:
                        out.append(h)
                except (json.JSONDecodeError, KeyError, TypeError,
                        ValueError, OSError):
                    pass
        return out

    def dead(self) -> list[int]:
        """Complement of ``alive()`` over the configured host count."""
        live = set(self.alive())
        return [h for h in range(self.n_hosts) if h not in live]


class StragglerTracker:
    """Rolling per-host step times; flags persistent stragglers."""

    def __init__(self, n_hosts: int, straggler_factor: float = 1.5,
                 patience: int = 5, window: int = 50):
        self.times = [[] for _ in range(n_hosts)]
        self.factor = straggler_factor
        self.patience = patience
        self.window = window
        self.strikes = np.zeros(n_hosts, np.int32)

    def record(self, host: int, seconds: float):
        t = self.times[host]
        t.append(seconds)
        if len(t) > self.window:
            t.pop(0)

    def check(self) -> list[int]:
        last = [t[-1] for t in self.times if t]
        if not last:
            return []            # nothing recorded yet: nobody to flag
        med = float(np.median(last))
        flagged = []
        for h, t in enumerate(self.times):
            # med == 0 (zero-duration steps: mocked clocks, sub-resolution
            # timers) would make any positive time a "straggler" — treat a
            # degenerate median as healthy instead of flagging the fleet
            if t and med > 0.0 and t[-1] > self.factor * med:
                self.strikes[h] += 1
            else:
                self.strikes[h] = 0
            if self.strikes[h] >= self.patience:
                flagged.append(h)
        return flagged


def plan_remesh(n_devices: int, model_parallel: int,
                global_batch: int) -> dict:
    """Largest (data, model) grid for the surviving device count.

    Keeps the TP degree fixed (memory constraint), shrinks data parallelism
    to the largest divisor that fits, and returns the gradient-accumulation
    factor that preserves the global batch.
    """
    assert n_devices >= model_parallel, "cannot keep TP degree"
    data = n_devices // model_parallel
    # largest power-of-two data degree that divides the global batch
    while data > 1 and (global_batch % data != 0):
        data -= 1
    used = data * model_parallel
    micro_scale = max(1, (global_batch // data) // max(1, global_batch // (n_devices // model_parallel or 1)))
    return {
        "mesh_shape": (data, model_parallel),
        "devices_used": used,
        "devices_idle": n_devices - used,
        "grad_accum_scale": micro_scale,
    }


def plan_cache_remesh(n_devices: int, num_sets: int,
                      degraded: set | frozenset | None = None) -> dict:
    """The sharded cache's geometry on ``n_devices`` shards.

    The cache mesh is flat and the table shards by sets, so every surviving
    shard count is usable: each shard owns ``ceil(num_sets / D')`` sets and
    the table pads with EMPTY sets to ``D' * s_local`` rows.  The plan
    reports the shard geometry, the padded (dead-weight) sets, and, for
    ``degraded`` shard ids of the current mesh, how many slabs split
    placement can use and whether it degenerates to the atomic whole-chain
    protocol (fewer than 2 healthy slabs)."""
    if n_devices < 1 or num_sets < 1:
        raise ValueError(f"n_devices={n_devices}, num_sets={num_sets}: both must be >= 1")
    degraded = set() if degraded is None else set(degraded)
    if not all(0 <= d < n_devices for d in degraded):
        raise ValueError(f"degraded shards {sorted(degraded)} outside [0, {n_devices})")
    s_local = -(-num_sets // n_devices)
    padded = n_devices * s_local - num_sets
    healthy = n_devices - len(degraded)
    if healthy < 1:
        raise ValueError("every shard degraded; nothing to plan")
    return {
        "mesh_shape": (n_devices,),
        "sets_per_shard": s_local,
        "padded_sets": padded,
        "even": padded == 0,
        "healthy_slabs": healthy,
        "split_capable": healthy >= 2,
    }


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault.  ``kind``:

      * ``"degrade"`` / ``"lose"`` — mark shard ``arg`` lost (one client
        path: a degraded shard is treated exactly as a dead one),
      * ``"resize"``     — live-reshard the cache mesh to ``arg`` shards,
      * ``"route_fail"`` — transient: for the next ``arg`` backend calls
        each group sheds with probability ``frac`` (rng seeded ``seed``).
    """
    tick: int
    kind: str
    arg: int
    frac: float = 0.5
    seed: int = 0

    def __post_init__(self):
        if self.kind not in ("degrade", "lose", "resize", "route_fail"):
            raise ValueError(f"unknown fault kind {self.kind!r}")


class FaultPlan:
    """A deterministic fault schedule.

    ``ServeEngine.run_until_done(fault_plan=...)`` pops due events at each
    tick boundary (before the tick's admissions) and applies them with
    ``ServeEngine.apply_fault``.  The same plan over the same workload gives
    the same shed, fallback and rebuild sequence."""

    def __init__(self, events):
        self.events = sorted(events, key=lambda e: e.tick)
        self.applied: list[FaultEvent] = []

    def pop_due(self, tick: int) -> list[FaultEvent]:
        """Events scheduled at or before ``tick``, removed from the plan."""
        due = [e for e in self.events if e.tick <= tick]
        if due:
            self.events = [e for e in self.events if e.tick > tick]
            self.applied.extend(due)
        return due

    def next_tick(self) -> int | None:
        """Tick of the earliest event still scheduled (``None`` when the
        plan is drained).  ``run_until_done`` caps the megastep window with
        it, so no window straddles a fault."""
        return self.events[0].tick if self.events else None

    def __len__(self):
        return len(self.events)

    @classmethod
    def seeded(cls, seed: int, *, ticks: int, ndev: int,
               n_events: int = 3, allow_resize: bool = True) -> "FaultPlan":
        """A reproducible plan of ``n_events`` faults over ``[1, ticks)``
        against ``ndev`` shards, the same events as the JAX package's for
        the same arguments.  It never degrades the last healthy shard; a
        resize targets a shard count in ``[1, ndev]``."""
        rng = np.random.default_rng(seed)
        kinds = ["degrade", "route_fail"] + (["resize"] if allow_resize else [])
        # ticks first, walked sorted, so the degraded set follows the order
        # the events apply in
        times = sorted(int(rng.integers(1, max(2, ticks))) for _ in range(n_events))
        events, degraded = [], set()
        for t in times:
            kind = kinds[int(rng.integers(len(kinds)))]
            if kind == "degrade":
                healthy = [d for d in range(ndev) if d not in degraded]
                if len(healthy) <= 1:
                    kind = "route_fail"
                else:
                    shard = int(healthy[int(rng.integers(len(healthy)))])
                    degraded.add(shard)
                    events.append(FaultEvent(t, "degrade", shard))
                    continue
            if kind == "resize":
                # a resize rebuilds a healthy mesh: later degrades may pick
                # any shard again
                events.append(FaultEvent(t, "resize", int(rng.integers(1, ndev + 1))))
                degraded.clear()
            else:
                events.append(FaultEvent(
                    t, "route_fail", int(rng.integers(1, 3)),
                    frac=float(rng.uniform(0.2, 0.6)),
                    seed=int(rng.integers(2**31))))
        return cls(events)
