"""CFD launcher: lidDrivenCavity3D with the repartitioned PISO solver.

  python -m repro_torch.launch.cavity --n 210 --parts 30 --alpha 30 --steps 3
  python -m repro_torch.launch.cavity --n 8 --parts 4 --adaptive --steps 6 \
      --device cpu

A shim over :mod:`repro_torch.launch.case` (every flag is forwarded).  The
control flags, with the JAX launcher's defaults: ``--alpha 0`` lets the
cost model (the ``H100`` spec) pick the ratio; ``--adaptive`` samples a
per-phase ``timed_step`` every ``--sample-every`` (4) steps into the
repartitioning controller, which switches alpha when the predicted gain
clears ``--hysteresis`` (0.10), plans served from one plan cache;
``--scan-steps`` (8) caps the windows of steps between samples, and of a
non-adaptive run.
"""
from __future__ import annotations

from repro_torch.launch.case import main

if __name__ == "__main__":
    main()
