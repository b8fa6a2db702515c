"""Bicubic resampling as dense interpolation matrices, and VALID pooling.

Counterpart of the JAX package's ``ops/resize.py``. The matrices are the
separable cubic-convolution definition (Keys kernel, a = -0.75,
half-pixel coordinates, clamped source indices) that torch's bicubic
``align_corners=False`` also uses.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _cubic_kernel(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Keys cubic convolution kernel with parameter ``a``."""
    x = np.abs(x)
    x2 = x * x
    x3 = x2 * x
    return np.where(
        x <= 1.0,
        (a + 2.0) * x3 - (a + 3.0) * x2 + 1.0,
        np.where(x < 2.0, a * x3 - 5.0 * a * x2 + 8.0 * a * x - 4.0 * a, 0.0),
    )


@functools.lru_cache(maxsize=None)
def _resize_matrix_np(in_size: int, out_size: int,
                      a: float = -0.75) -> np.ndarray:
    """(out_size, in_size) cubic interpolation matrix, float64, half-pixel
    (``align_corners=False``) source coordinates."""
    if in_size == out_size:
        return np.eye(in_size)
    M = np.zeros((out_size, in_size), dtype=np.float64)
    src = (np.arange(out_size) + 0.5) * (in_size / out_size) - 0.5
    base = np.floor(src).astype(np.int64)
    frac = src - base
    for tap in range(-1, 3):
        w = _cubic_kernel(np.asarray(tap) - frac, a=a)
        idx = np.clip(base + tap, 0, in_size - 1)
        np.add.at(M, (np.arange(out_size), idx), w)
    return M


def resize_matrix(in_size: int, out_size: int, dtype, device):
    """:func:`_resize_matrix_np` as a tensor."""
    return torch.as_tensor(_resize_matrix_np(in_size, out_size),
                           dtype=dtype, device=device)


def resize_bicubic_nchw(x, out_hw):
    """Bicubic resize of the last two axes of ``[..., H, W]``: first along
    H, then along W (the order of the JAX einsums)."""
    My = resize_matrix(x.shape[-2], out_hw[0], x.dtype, x.device)
    Mx = resize_matrix(x.shape[-1], out_hw[1], x.dtype, x.device)
    y = torch.einsum("oh,...hw->...ow", My, x)
    return torch.einsum("pw,...ow->...op", Mx, y)


def resize_bicubic_nhwc(x, out_hw):
    """Bicubic resize of an NHWC tensor on its H and W axes."""
    y = resize_bicubic_nchw(x.permute(0, 3, 1, 2), out_hw)
    return y.permute(0, 2, 3, 1)


def avg_pool_nchw(x, factor: int):
    """AvgPool2d(factor, stride=factor) with VALID padding: trailing
    rows/cols that do not fill a window are dropped (253 → 126)."""
    H, W = x.shape[-2], x.shape[-1]
    h, w = H // factor, W // factor
    x = x[..., : h * factor, : w * factor]
    x = x.reshape(x.shape[:-2] + (h, factor, w, factor))
    return x.mean(dim=(-3, -1))


def avg_pool_nhwc(x, factor: int):
    """:func:`avg_pool_nchw` on an NHWC tensor."""
    return avg_pool_nchw(x.permute(0, 3, 1, 2), factor).permute(0, 2, 3, 1)
