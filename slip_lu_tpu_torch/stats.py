"""Solve statistics / observability.

The reference's only instrumentation is wall-clock timing in the demo
(reference: SuiteSparse_time() calls in Demo/SLIPLU.c) plus print_level
matrix dumps. Here every driver records a `SolveStats` for its last run
— per-phase wall times, problem sizes, limb widths, retries, and derived
nnz/s — retrievable via `last_stats()` and printed by the CLI at
`--print-level >= 1` with `--time`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional


@dataclasses.dataclass
class SolveStats:
    backend: str = ""
    n: int = 0
    nnz: int = 0
    nrhs: int = 0
    W: int = 0                    # factor limb width
    Ws: int = 0                   # substitution limb width
    lnz: int = 0                  # L pattern entries (sparse path)
    unz: int = 0
    retries: int = 0              # widen-and-retry count
    fallback: bool = False        # sparse -> dense fallback taken
    phases: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def total_s(self) -> float:
        return sum(self.phases.values())

    @property
    def nnz_per_s(self) -> float:
        t = self.total_s
        return self.nnz / t if t > 0 else 0.0

    def summary(self) -> str:
        lines = [
            f"backend={self.backend} n={self.n} nnz={self.nnz} "
            f"nrhs={self.nrhs} W={self.W} Ws={self.Ws}"
            + (f" lnz={self.lnz} unz={self.unz}" if self.lnz else "")
            + (f" retries={self.retries}" if self.retries else "")
            + (" fallback=dense" if self.fallback else "")
        ]
        for name, secs in self.phases.items():
            lines.append(f"  {name:<12s} {secs * 1e3:10.2f} ms")
        lines.append(f"  {'total':<12s} {self.total_s * 1e3:10.2f} ms  "
                     f"({self.nnz_per_s:,.0f} nnz/s)")
        return "\n".join(lines)


_last: Optional[SolveStats] = None


def record(stats: SolveStats) -> None:
    global _last
    _last = stats


def last_stats() -> Optional[SolveStats]:
    """Stats of the most recent driver run (host, tpu, or tpu-sparse)."""
    return _last


class phase_timer:
    """with phase_timer(stats, "factor"): ... accumulates wall time."""

    def __init__(self, stats: SolveStats, name: str):
        self.stats = stats
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        self.stats.phases[self.name] = \
            self.stats.phases.get(self.name, 0.0) + dt
        return False
