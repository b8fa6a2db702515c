"""``advect_diffuse_step_fused``: the explicit energy step in one CUDA call.

Replaces the TPU kernel ``pbml_mantle_convection_tpu/ops/pallas_kernels.py::
_advect_kernel``; this module is the port of ``advect_diffuse_step_pallas``.
From u, v, T of B simulations it computes the adaptive dt (one global max
over the whole batch, as in JAX), the metric-aware upwind advection,
Laplacian, source and Euler update, the optional interior clip to [0, 2],
the replicated sidewalls and the plates (the bottom row replicates row 1
under core cooling). On a CUDA tensor it launches ``csrc/advect.cu`` once
(float32 or float64; with the adaptive dt a cooperative launch that forms
the grid-wide dt inside it, which stays in device memory: no host sync
inside a step); on a CPU tensor it runs :func:`advect_diffuse_step_plain`.

Unlike the Pallas wrapper, which sends field sources (the EBA terms,
Di > 0) to XLA because SMEM holds only scalars, the kernel reads the
source either as a device scalar or as a (B, H-2, W-2) field: every energy
step on the card goes through it. What bounds it (a launch, at these
sizes) and the design are written at the top of ``csrc/advect.cu``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..physics.advection import GridMetrics, advect_diffuse_step
from ..utils.profiling import span
from . import _cuda

_ENTRY = {torch.float32: "pmc_advect_f32", torch.float64: "pmc_advect_f64"}


def advect_diffuse_step_plain(u, v, T, src, metrics: GridMetrics,
                              dt: Optional[torch.Tensor] = None,
                              cn_max: float = 0.1, bottom_T: float = 1.0,
                              top_T: float = 0.0, core_cool: bool = False,
                              clip_T: bool = False):
    """Plain PyTorch version of :func:`advect_diffuse_step_fused`."""
    T_new, dt = advect_diffuse_step(u, v, T, src, metrics, dt=dt,
                                    cn_max=cn_max, bottom_T=bottom_T,
                                    top_T=top_T, core_cool=core_cool)
    if clip_T:
        # the kernel clips the interior before the BCs: clip everything,
        # then stamp the plates again
        T_new = torch.clamp(T_new, 0.0, 2.0)
        if not core_cool:
            T_new[..., 0, :] = bottom_T
        T_new[..., -1, :] = top_T
    return T_new, dt


def advect_diffuse_step_fused(u, v, T, src, metrics: GridMetrics,
                              dt: Optional[torch.Tensor] = None,
                              cn_max: float = 0.1, bottom_T: float = 1.0,
                              top_T: float = 0.0, core_cool: bool = False,
                              clip_T: bool = False):
    """u, v, T (B, H, W) or (H, W); src a scalar, a 0-d tensor or a
    (B, H-2, W-2) field; dt a 0-d tensor, or None for the adaptive step.
    Returns (T_new like T, dt a 0-d tensor)."""
    with span("pmc.kernel.advect"):
        if T.device.type == "cpu":
            return advect_diffuse_step_plain(u, v, T, src, metrics, dt=dt,
                                             cn_max=cn_max, bottom_T=bottom_T,
                                             top_T=top_T, core_cool=core_cool,
                                             clip_T=clip_T)
        squeeze = T.ndim == 2
        if squeeze:
            u, v, T = u[None], v[None], T[None]
        B, H, W = T.shape
        if T.dtype not in _ENTRY:
            raise TypeError(f"advect: the kernel takes float32 or float64, "
                            f"got {T.dtype}")
        for name, t in (("u", u), ("v", v), ("T", T)):
            _cuda.check_cuda(f"advect {name}", t, T.dtype, (B, H, W))
        for t in metrics:
            _cuda.check_cuda("advect metrics", t, T.dtype, (H - 2, W - 2))
        src = torch.as_tensor(src, dtype=T.dtype, device=T.device)
        field = src.ndim > 0
        if field:
            src = src.expand(B, H - 2, W - 2).contiguous()
        if dt is not None:
            dt = torch.as_tensor(dt, dtype=T.dtype, device=T.device)
            _cuda.check_cuda("advect dt", dt, T.dtype, ())
        for t in (u, v, src, *metrics):
            if t.device != T.device:
                raise ValueError("advect: inputs on different devices")
        out = torch.empty_like(T)
        if dt is None:
            dt_out = torch.empty((), dtype=T.dtype, device=T.device)
            part = _cuda.join_scratch(T.device, T.dtype)
        else:
            dt_out, part = dt, None
        err = getattr(_cuda.library(), _ENTRY[T.dtype])(
            u.data_ptr(), v.data_ptr(), T.data_ptr(), metrics.dx_l.data_ptr(),
            metrics.dx_r.data_ptr(), metrics.dy_t.data_ptr(),
            metrics.dy_b.data_ptr(), src.data_ptr(), int(field),
            _cuda.ptr(dt), dt_out.data_ptr(), _cuda.ptr(part),
            _cuda.JOIN_BLOCKS, out.data_ptr(), B, H, W, float(cn_max),
            float(bottom_T), float(top_T), int(core_cool), int(clip_T),
            _cuda.stream(T))
        advect_diffuse_step_fused.launches += 1
        _cuda.raise_on_error(err, "advect_diffuse_step_fused")
        return (out[0] if squeeze else out), dt_out


advect_diffuse_step_fused.launches = 0
