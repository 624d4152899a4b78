"""Static stencil constants of the grid (``greb_tpu.ops.stencils``).

Only the fields the coefficient-folded circulation reads are kept here.
The strict term-by-term stencils are not part of this port yet.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..grid import Grid

F32 = np.float32


@dataclass(frozen=True)
class StencilStatic:
    xdim: int
    dyy: float              # f32 meridional grid length [m]
    dt_crcl: float
    quirk_jp2: bool = True  # src/greb.f90:881 index quirk


def make_stencil_static(grid: Grid, quirk_jp2: bool = True) -> StencilStatic:
    return StencilStatic(xdim=grid.xdim, dyy=float(F32(grid.dyy)),
                         dt_crcl=float(grid.dt_crcl), quirk_jp2=quirk_jp2)
