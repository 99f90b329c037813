"""Elastic serving: the cache remesh plan and deterministic fault plans.

Port of the serving half of ``repro.launch.elastic`` (numpy only, copied so
that the port imports nothing of the JAX package): ``plan_cache_remesh``,
``FaultEvent`` and ``FaultPlan``.  ``ServeEngine.run_until_done(fault_plan=)``
applies a plan's events at tick boundaries.  The training-side heartbeat,
watchdog, straggler tracker and ``plan_remesh`` come with the training
slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["plan_cache_remesh", "FaultEvent", "FaultPlan"]


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
