"""Curl heads: divergence-free velocities from a stream function.

Counterparts of ``curl_head_padded``, ``curl_head_cropped``,
``curl_head_valid``, ``gaussian_blur_5x9`` and ``blur3x3`` in the JAX
package's ``ops/curl.py``: u = ∂a/∂y, v = -∂a/∂x as VALID central
differences. The padded head (NewFluidNet, reference:
pytorch_networks_convae.py:1369-1386) replicate-pads them back to (H, W)
with antisymmetric free-slip sidewalls and zeroed corners; the cropped
head (FluidNet, :1694-1697) takes an (H+2, W+2) stream function to (H, W);
the valid head (Transolver) returns them as they are. The ``blurr``
option smooths the stream function first: the U-Net with
:func:`gaussian_blur_5x9`, the FluidNet family with :func:`blur3x3`.
"""

from __future__ import annotations

import numpy as np
import torch

from .stencils import dx_center, dy_center, replicate_pad


def _zero_corners(x):
    """Zero the four corner cells of ``[..., H, W]`` in place."""
    x[..., 0, 0] = 0.0
    x[..., 0, -1] = 0.0
    x[..., -1, 0] = 0.0
    x[..., -1, -1] = 0.0
    return x


def curl_head_padded(a):
    """(…, H, W) stream function → (…, H, W) u, v."""
    u = replicate_pad(dy_center(a)[..., :, 1:-1])
    u[..., :, 0] = -u[..., :, 1]
    u[..., :, -1] = -u[..., :, -2]
    _zero_corners(u)

    v = replicate_pad(-dx_center(a)[..., 1:-1, :])
    v[..., 0, :] = -v[..., 1, :]
    v[..., -1, :] = -v[..., -2, :]
    _zero_corners(v)
    return u, v


def curl_head_cropped(a):
    """FluidNet curl head: (…, H+2, W+2) stream function → (…, H, W) u, v
    (reference: pytorch_networks_convae.py:1694-1697)."""
    return dy_center(a)[..., :, 1:-1], -dx_center(a)[..., 1:-1, :]


def curl_head_valid(a):
    """Transolver curl head: (…, H, W) stream function → (…, H-2, W-2)
    u, v (reference: Transolver_Structured_Mesh_2D-checkpoint.py:201-204)."""
    return dy_center(a)[..., :, 1:-1], -dx_center(a)[..., 1:-1, :]


def gaussian_blur_5x9(a, sigma: float = 2.55):
    """Separable 5×9 Gaussian blur of a ``[..., H, W]`` field with
    replicate-padded edges: the JAX package's stand-in for the reference
    U-Net's ``v2.GaussianBlur(kernel_size=(5, 9), sigma=(0.1, 5.0))``
    (pytorch_networks_convae.py:1800-1801), whose sigma torch draws at
    random per call; the fixed midpoint of that range here. Rows first,
    then columns, each a sum over the taps in order."""
    def kern(n):
        x = np.arange(n) - (n - 1) / 2.0
        k = np.exp(-0.5 * (x / sigma) ** 2)
        return (k / k.sum()).tolist()

    H, W = a.shape[-2:]
    p = replicate_pad(a, (4, 4, 2, 2))
    out = torch.zeros_like(a)
    for i, k in enumerate(kern(5)):
        out = out + k * p[..., i:i + H, 4:4 + W]
    p2 = replicate_pad(out, (4, 4, 0, 0))
    out = torch.zeros_like(a)
    for j, k in enumerate(kern(9)):
        out = out + k * p2[..., :, j:j + W]
    return out


def blur3x3(a):
    """Replicate pad, then the 3×3 box mean of a ``[..., H, W]`` stream
    function (reference: NewFluidNet's ``blurr``,
    pytorch_networks_convae.py:1163-1172, 1359-1361); the nine taps summed
    row by row, then divided by 9."""
    H, W = a.shape[-2:]
    p = replicate_pad(a, (1, 1, 1, 1))
    out = torch.zeros_like(a)
    for dy in range(3):
        for dx in range(3):
            out = out + p[..., dy:dy + H, dx:dx + W]
    return out / 9.0
