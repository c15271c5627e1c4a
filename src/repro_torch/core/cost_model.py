"""Phase times of one outer iteration — the port's own copy of the JAX
package's ``PhaseBreakdown`` (``src/repro/core/cost_model.py``).

Only the breakdown is ported so far: the hardware specs and the analytic
model wait for figures measured on the card (the JAX package ships TPU
and A100 specs, which say nothing about an H100).
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar

__all__ = ["PhaseBreakdown"]


@dataclasses.dataclass(frozen=True)
class PhaseBreakdown:
    """Per-phase time of one outer iteration (seconds).

    The four instrumented buckets of a segregated step: host-side matrix
    **assembly**, the repartitioning coefficient **update** (paper fig.
    3b), the **halo** exchange of the solve, and the Krylov **solve**.
    ``overlapped`` is provenance, not a time: True marks a breakdown taken
    from overlapping phases, which must not calibrate a serial model; the
    instrumented walk is serial and emits False.
    """

    TIME_FIELDS: ClassVar[tuple] = ("assembly", "update", "halo", "solve")

    assembly: float
    update: float
    halo: float
    solve: float
    overlapped: bool = False

    @property
    def total(self) -> float:
        return self.assembly + self.update + self.halo + self.solve

    @property
    def imbalance(self) -> float:
        """CPU-side over GPU-side share, the controller's balance signal:
        1.0 when assembly exactly hides behind the accelerator phases, >1
        undersubscribed assembly (raise alpha), <1 oversubscribed."""
        gpu_side = self.solve + self.halo + self.update
        return self.assembly / max(gpu_side, 1e-30)
