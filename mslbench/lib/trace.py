"""The device trace of a stretch of a run: ``torch.profiler`` over one
traced segment, reduced to what the per-layer readers and the result line
take (device busy time, kernels, idle gaps by host span).

The harness marks its own layers with ``span(name)`` (a
``record_function`` named ``mslbench.<name>``); an idle gap of the device
is put down to the innermost harness span open on the host when it
began.  Busy time is the union of every device activity (kernels, copies,
sets) inside the segment, so two overlapping kernels count once.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile, record_function

PREFIX = "mslbench."
SEGMENT = PREFIX + "traced"


@contextlib.contextmanager
def span(name: str):
    """A host span of the harness, visible in the trace."""
    with record_function(PREFIX + name):
        yield


@dataclasses.dataclass
class DeviceOp:
    name: str
    start_us: float
    end_us: float

    @property
    def us(self) -> float:
        return self.end_us - self.start_us


@dataclasses.dataclass
class Trace:
    """One traced segment: ``ops`` are the device activities inside it,
    ``window_s`` its length on the host, ``busy_s`` the device's busy time;
    ``counters`` are the client's counts over the same segment."""

    ops: list[DeviceOp]
    window_s: float
    busy_s: float
    idle_gaps: list[tuple[str, float]]
    counters: dict = dataclasses.field(default_factory=dict)

    def kernel_us(self, fragment: str) -> float:
        """Device µs of the ops whose name holds ``fragment``."""
        return sum(op.us for op in self.ops if fragment in op.name)

    def count(self, fragment: str = "") -> int:
        return sum(fragment in op.name for op in self.ops)

    def breakdown(self, n: int = 10) -> dict:
        by_name = defaultdict(float)
        for op in self.ops:
            by_name[op.name] += op.us / 1e6
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        return {"device_ops": [[name[:160], s] for name, s in top],
                "idle_gaps": [[name, s] for name, s in self.idle_gaps[:n]]}


def warm_profiler() -> None:
    """Start and stop the profiler once: its first start (CUPTI's set-up)
    takes seconds, which a traced segment must not pay."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.zeros(1).add_(1)


class Segment:
    """``with Segment() as seg: ...`` profiles the block; the device work
    the block issued is waited for inside it.  ``seg.trace()`` reduces it."""

    def __enter__(self):
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._mark = record_function(SEGMENT)
        self._mark.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        try:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.wall_s = time.perf_counter() - self._t0
        finally:
            self._mark.__exit__(*exc)
            self._prof.__exit__(*exc)
        return False

    def trace(self, counters: dict | None = None) -> Trace:
        events = self._prof.events()
        seg = [e for e in events if e.name == SEGMENT
               and e.device_type == torch.autograd.DeviceType.CPU]
        if not seg:
            raise RuntimeError("the profiler kept no record of the traced segment")
        lo, hi = seg[0].time_range.start, seg[0].time_range.end
        ops = []
        spans = []
        for e in events:
            a, b = e.time_range.start, e.time_range.end
            if e.name.startswith(PREFIX):
                # a span shows on the device's timeline too (a user
                # annotation): it is the host's, not a device operation
                if e.device_type == torch.autograd.DeviceType.CPU and e.name != SEGMENT:
                    spans.append((a, b, e.name[len(PREFIX):]))
            elif e.device_type == torch.autograd.DeviceType.CUDA:
                a, b = max(a, lo), min(b, hi)
                if b > a:
                    ops.append(DeviceOp(e.name, a, b))
        busy_us, gaps = _busy_and_gaps(ops, lo, hi)
        return Trace(ops=ops, window_s=(hi - lo) / 1e6, busy_s=busy_us / 1e6,
                     idle_gaps=_attribute(gaps, spans), counters=dict(counters or {}))


def _busy_and_gaps(ops, lo, hi):
    """Union length of the ops' intervals and the idle gaps between them."""
    busy, gaps, cur = 0.0, [], lo
    for op in sorted(ops, key=lambda o: o.start_us):
        if op.start_us > cur:
            gaps.append((cur, op.start_us))
        if op.end_us > cur:
            busy += op.end_us - max(op.start_us, cur)
            cur = op.end_us
    if hi > cur:
        gaps.append((cur, hi))
    return busy, gaps


def _attribute(gaps, spans) -> list[tuple[str, float]]:
    """Idle seconds summed by the innermost harness span open at each
    gap's start ("other" where none is), longest first."""
    spans = sorted(spans)
    starts = [s[0] for s in spans]
    total = defaultdict(float)
    for a, b in gaps:
        name = "other"
        # spans nest, so the innermost open one is the latest to start; the
        # harness nests them a few deep, so a few candidates decide
        i = bisect.bisect_right(starts, a) - 1
        for s in spans[max(0, i - 7): i + 1][::-1]:
            if s[1] > a:
                name = s[2]
                break
        total[name] += (b - a) / 1e6
    return sorted(total.items(), key=lambda kv: -kv[1])
