"""Structured 2-D mantle-convection grid (cell centres, spacing, aspect).

The same grid as the JAX package's ``sim/grid.py``: ``H`` rows span
y ∈ [0, 1] (row 0 = hot bottom), ``W`` columns span x ∈ [0, aspect];
rows/cols 1..-2 are interior cell centres of an (H-2) × (W-2)
discretization and rows/cols 0 and -1 sit exactly on the boundary
(reference: prepare_gaia_ini.py:23-26, datasetio.py:149-152).

Coordinates are host numpy float64; :meth:`Grid.coords` moves them to a
device in the working dtype.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Grid:
    H: int = 128
    W: int = 506
    aspect: float = 4.0

    @property
    def dy(self) -> float:
        """Interior grid spacing 1/(H-2); dx == dy by construction."""
        return 1.0 / (self.H - 2)

    @staticmethod
    def _centers(n: int, length: float) -> np.ndarray:
        h = length / (n - 2)
        c = (np.arange(n, dtype=np.float64) - 0.5) * h
        c[0] = 0.0
        c[-1] = length
        return c

    @cached_property
    def xc(self) -> np.ndarray:
        """(H, W) x-coordinates of the cell centres, float64."""
        x = self._centers(self.W, self.aspect)
        return np.ascontiguousarray(np.broadcast_to(x[None, :],
                                                    (self.H, self.W)))

    @cached_property
    def yc(self) -> np.ndarray:
        """(H, W) y-coordinates of the cell centres (0 = bottom), float64."""
        y = self._centers(self.H, 1.0)
        return np.ascontiguousarray(np.broadcast_to(y[:, None],
                                                    (self.H, self.W)))

    @cached_property
    def pos(self) -> np.ndarray:
        """(H*W, 2) flattened (x, y) positions, the layout of GAIA's
        ``state["pos"]`` (advect_wi_gaia.py:560-564)."""
        return np.stack([self.xc.reshape(-1), self.yc.reshape(-1)], axis=1)

    def coords(self, device, dtype) -> tuple[torch.Tensor, torch.Tensor]:
        """(xc, yc) as (H, W) tensors on ``device``."""
        return (torch.as_tensor(self.xc, dtype=dtype, device=device),
                torch.as_tensor(self.yc, dtype=dtype, device=device))
