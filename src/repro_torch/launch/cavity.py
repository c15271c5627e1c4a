"""CFD launcher: lidDrivenCavity3D with the repartitioned PISO solver.

  python -m repro_torch.launch.cavity --n 210 --parts 30 --alpha 30 --steps 3

A shim over :mod:`repro_torch.launch.case` (every flag is forwarded).
"""
from __future__ import annotations

from repro_torch.launch.case import main

if __name__ == "__main__":
    main()
