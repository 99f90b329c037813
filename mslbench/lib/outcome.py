"""What a client is given for one run and what it hands back."""

from __future__ import annotations

import dataclasses
import torch

from mslbench.lib.spec import Cell
from mslbench.lib.trace import Trace


@dataclasses.dataclass
class RunContext:
    """One run of one cell.  ``control`` asks for the cell's control
    (``mslbench/control.py``): the reference at a lower precision, or with
    a guarantee broken, judged by the same check as the program."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    control: bool = False


@dataclasses.dataclass
class Check:
    """One number the correctness check compared, beside its limit: the
    number passes at or below ``limit``, or, for a count that must be
    reached, at or above ``least``."""

    name: str
    value: float
    limit: float | None = None
    least: float | None = None

    @property
    def ok(self) -> bool:
        if self.limit is not None and not self.value <= self.limit:
            return False
        return self.least is None or self.value >= self.least

    def record(self) -> dict:
        bound = {"limit": self.limit} if self.limit is not None else {"least": self.least}
        return {"value": self.value, **bound}

    def line(self) -> str:
        if self.limit is not None:
            return f"check {self.name} {self.value!r} limit {self.limit!r}"
        return f"check {self.name} {self.value!r} least {self.least!r}"


@dataclasses.dataclass
class Outcome:
    attempted: int
    failed: int
    metrics: dict[str, float]        # end-to-end metrics, by name
    checks: list[Check]
    info: dict                       # printed on an earlier line, not metrics
    memory_peak_bytes: int
    trace: Trace | None = None

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c.ok for c in self.checks)
