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
    def n_layers(self) -> int:
        """Interior layers, H - 2 (126 on the 128-row grid)."""
        return self.H - 2

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

    @property
    def xc_np(self) -> np.ndarray:
        """:attr:`xc` (host numpy float64) under the JAX grid's name for
        its host copy."""
        return self.xc

    @property
    def yc_np(self) -> np.ndarray:
        """:attr:`yc` (host numpy float64) under the JAX grid's name for
        its host copy."""
        return self.yc

    @cached_property
    def sdf(self) -> np.ndarray:
        """(H, W) boundary indicator, float64: 1 on the outermost ring, 0
        inside (advect_wi_gaia.py:566-570)."""
        m = np.zeros((self.H, self.W))
        m[0, :] = m[-1, :] = m[:, 0] = m[:, -1] = 1.0
        return m

    @cached_property
    def sdf2(self) -> np.ndarray:
        """(H, W) interior indicator, float64: 0 on the ring, 1 inside
        (advect_wi_gaia.py:571-575)."""
        return 1.0 - self.sdf

    @cached_property
    def pos(self) -> np.ndarray:
        """(H*W, 2) flattened (x, y) positions, the layout of GAIA's
        ``state["pos"]`` (advect_wi_gaia.py:560-564)."""
        return np.stack([self.xc.reshape(-1), self.yc.reshape(-1)], axis=1)

    def coords(self, device, dtype) -> tuple[torch.Tensor, torch.Tensor]:
        """(xc, yc) as (H, W) tensors on ``device``."""
        return (torch.as_tensor(self.xc, dtype=dtype, device=device),
                torch.as_tensor(self.yc, dtype=dtype, device=device))


DEFAULT_GRID = Grid()
