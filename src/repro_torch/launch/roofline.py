"""Roofline hardware constants, from ``repro/launch/roofline.py``.

Only the ``HW`` dataclass is ported: ``core.planner`` scores its
candidate layer plans with these three rates.  The field names are the
reference's; the defaults are the NVIDIA H100 SXM 80GB's data-sheet
figures, where the reference's describe a TPU v5e:

- ``peak_flops``: 67e12 FLOP/s, the f32 FMA rate (the CNN trains in f32);
- ``hbm_bw``: 3.35e12 B/s of HBM3;
- ``ici_bw``: 450e9 B/s, NVLink 4's rate in one direction (the link the
  model-axis collectives of a multi-card node cross).

The HLO collective parser and the dry-run reports wait for the dry-run
(``ROADMAP.md`` §1 item 5).
"""
from __future__ import annotations

import dataclasses

__all__ = ["HW"]


@dataclasses.dataclass(frozen=True)
class HW:
    peak_flops: float = 67e12         # f32 FMA FLOP/s (H100 SXM data sheet)
    hbm_bw: float = 3.35e12           # HBM3 bytes/s (H100 SXM data sheet)
    ici_bw: float = 450e9             # NVLink 4 bytes/s, one direction
