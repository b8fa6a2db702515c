"""``curl_advect_epilogue``: curl head + advection–diffusion in one call.

Replaces the TPU kernel ``pbml_mantle_convection_tpu/ops/epilogue_kernel.py::
_epilogue_kernel`` (``CurlAdvectEpilogue``). From the raw merge-3 stream
function ψ it computes the curl velocities (antisymmetric pads, zero
corners, velocity scaler), the adaptive dt from the global max of |u|, |v|,
the metric-aware upwind advection, Laplacian and source, the Euler update,
the temperature BCs and the clip to [0, 2]. On a CUDA tensor it launches
``csrc/epilogue.cu`` (dt stays in device memory: no host sync inside a
step); on a CPU tensor it runs :func:`curl_advect_epilogue_plain`, the
composition ``curl_head_padded`` (after the mean subtraction) → scaler →
``advect_diffuse_step`` → ``stamp_temperature_bc`` → clip.

The kernel skips the spatial-mean subtraction, which cancels analytically
in the central differences (d/dx[(ψ − m)·c] = c·dψ/dx), so kernel and
plain version agree to float32 reassociation, not bitwise. What bounds it
on the card (bytes) and the design are written at the top of
``csrc/epilogue.cu``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..physics.advection import GridMetrics, advect_diffuse_step
from . import _cuda
from .curl import curl_head_padded
from .stencils import stamp_temperature_bc


class EpilogueConsts(NamedTuple):
    """Per-grid constants of the epilogue, fixed when the engine is built."""

    metrics: GridMetrics
    a_bound: float
    cn_max: float
    adv_num: float       # 0.5 · cn_max · dx_min, float32-rounded
    dt_diffuse: float    # 0.5·(dx²)²/(dx²+dx²), evaluated in float32


def epilogue_consts(metrics: GridMetrics, a_bound: float,
                    cn_max: float) -> EpilogueConsts:
    """Reads dx_min back once, when the engine is built (never per step)."""
    dx_min = np.float32(metrics.dx_l.min().item())
    dx2 = np.float32(dx_min * dx_min)
    dt_diffuse = np.float32(0.5) * (dx2 * dx2) / (dx2 + dx2)
    return EpilogueConsts(metrics, float(a_bound), float(cn_max),
                          float(np.float32(0.5 * cn_max * float(dx_min))),
                          float(dt_diffuse))


def curl_advect_epilogue_plain(psi, T, consts: EpilogueConsts, scaler, src):
    """Plain PyTorch version of :func:`curl_advect_epilogue`."""
    a = (psi - psi.mean()) * consts.a_bound
    u, v = curl_head_padded(a)
    u = u * scaler
    v = v * scaler
    T_new, dt = advect_diffuse_step(u, v, T, src, consts.metrics,
                                    cn_max=consts.cn_max)
    T_new = torch.clamp(stamp_temperature_bc(T_new), 0.0, 2.0)
    return u, v, T_new, dt


def curl_advect_epilogue(psi: torch.Tensor, T: torch.Tensor,
                         consts: EpilogueConsts, scaler: float,
                         src: torch.Tensor):
    """ψ, T (H, W); scaler a float; src a 0-d tensor → (u, v, T_new (H, W),
    dt 0-d tensor)."""
    if psi.device.type == "cpu":
        return curl_advect_epilogue_plain(psi, T, consts, scaler, src)
    H, W = psi.shape
    _cuda.check_cuda_f32("epilogue psi", psi, (H, W))
    _cuda.check_cuda_f32("epilogue T", T, (H, W))
    _cuda.check_cuda_f32("epilogue src", src, ())
    met = consts.metrics
    for t in met:
        _cuda.check_cuda_f32("epilogue metrics", t, (H - 2, W - 2))
    for t in (T, src, *met):
        if t.device != psi.device:
            raise ValueError("epilogue: inputs on different devices")
    lib = _cuda.library()
    u = torch.empty_like(psi)
    v = torch.empty_like(psi)
    T_new = torch.empty_like(psi)
    dt = torch.empty((), device=psi.device)
    block_max = torch.empty(((H * W + 255) // 256,), device=psi.device)
    err = lib.pmc_curl_advect_epilogue(
        psi.data_ptr(), T.data_ptr(), met.dx_l.data_ptr(),
        met.dx_r.data_ptr(), met.dy_t.data_ptr(), met.dy_b.data_ptr(),
        src.data_ptr(), u.data_ptr(), v.data_ptr(), T_new.data_ptr(),
        dt.data_ptr(), block_max.data_ptr(), H, W, consts.a_bound,
        float(scaler), consts.adv_num, consts.dt_diffuse, _cuda.stream(psi))
    curl_advect_epilogue.launches += 1
    _cuda.raise_on_error(err, "curl_advect_epilogue")
    return u, v, T_new, dt


curl_advect_epilogue.launches = 0
