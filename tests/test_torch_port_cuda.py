"""The port's CUDA kernels against their plain PyTorch versions, on an
NVIDIA GPU. Every test is marked ``cuda`` and skips without a card (the
kernels have no CPU mode); the file imports no JAX, so it runs on the
machine with the card:

    python -m pytest -o addopts="" --noconftest -m cuda tests/test_torch_port_cuda.py
"""

import pytest
import torch

from pbml_mantle_convection_tpu_torch.ops.advect_kernel import (
    advect_diffuse_step_fused, advect_diffuse_step_plain)
from pbml_mantle_convection_tpu_torch.ops.branch_kernel import (
    layer_stack, layer_stack_plain, pack_stack)
from pbml_mantle_convection_tpu_torch.ops.epilogue_kernel import (
    curl_advect_epilogue, curl_advect_epilogue_plain, epilogue_consts)
from pbml_mantle_convection_tpu_torch.ops.merge_kernel import (
    trunk, trunk_plain, trunk_weights)
from pbml_mantle_convection_tpu_torch.physics.advection import grid_metrics
from pbml_mantle_convection_tpu_torch.sim.grid import Grid

F32 = torch.float32


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _random_stack(c_i, c_o, R, groups, use_gn=True, use_act=True, seed=0,
                  device="cpu"):
    g = torch.Generator().manual_seed(seed)
    layers = []
    ci = c_i
    for _ in range(R):
        w9 = [torch.randn(c_o, ci, 5, 5, generator=g) / (5 * ci ** 0.5)
              for _ in range(9)]
        layers.append((w9, 0.1 * torch.randn(c_o, generator=g),
                       1 + 0.1 * torch.randn(c_o, generator=g),
                       0.1 * torch.randn(c_o, generator=g)))
        ci = c_o
    layers = [([w.to(device) for w in w9], b.to(device), s.to(device),
               t.to(device)) for w9, b, s, t in layers]
    return pack_stack(layers, groups, use_gn, use_act)


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", [
    (7, 16, 1, 4, True, True, (128, 506), False),
    (16, 16, 6, 4, True, True, (64, 253), True),
    (16, 16, 6, 4, True, True, (8, 31), False),
    (16, 16, 1, 1, False, True, (40, 70), False),
    (16, 1, 1, 1, False, False, (40, 70), False),
    (8, 8, 2, 2, True, True, (20, 28), True)])
def test_cuda_layer_stack_matches_plain(cuda, cfg):
    c_i, c_o, R, groups, use_gn, use_act, (H, W), pool = cfg
    sw = _random_stack(c_i, c_o, R, groups, use_gn, use_act, device=cuda)
    x = torch.randn(c_i, H, W, generator=torch.Generator().manual_seed(1))
    x = x.to(cuda)
    n0 = layer_stack.launches
    y, p = layer_stack(x, sw, pool)
    assert layer_stack.launches == n0 + 1
    yp, pp = layer_stack_plain(x, sw, pool)
    torch.cuda.synchronize()
    assert float((y - yp).abs().max()) <= 1e-4 * float(yp.abs().max())
    if pool:
        assert float((p - pp).abs().max()) <= 1e-6 * float(pp.abs().max())


@pytest.mark.cuda
def test_cuda_trunk_matches_plain(cuda):
    H, W, c_h = 128, 506, 16
    merge = _random_stack(87, c_h, 1, 4, device=cuda)
    hw = [(H // 2 ** l, W // 2 ** l) for l in range(1, 5)]
    tw = trunk_weights(merge, hw, H, W)
    g = torch.Generator().manual_seed(2)
    b0 = torch.randn(c_h, H, W, generator=g).to(cuda)
    coarse = [torch.randn(c_h, h, w, generator=g).to(cuda) for h, w in hw]
    x = torch.randn(7, H, W, generator=g).to(cuda)
    y = trunk(b0, coarse, x, tw)
    yp = trunk_plain(b0, coarse, x, tw)
    torch.cuda.synchronize()
    assert float((y - yp).abs().max()) <= 1e-4 * float(yp.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("H,W", [(128, 506), (256, 256), (16, 32)])
def test_cuda_epilogue_matches_plain(cuda, H, W):
    xc = torch.linspace(0, 4, W, dtype=F32).expand(H, W)
    yc = torch.linspace(0, 1, H, dtype=F32)[:, None].expand(H, W)
    met = grid_metrics(xc.to(cuda), yc.to(cuda), aspect=4.0)
    consts = epilogue_consts(met, 4.0, 0.99)
    g = torch.Generator().manual_seed(3)
    psi = torch.randn(H, W, generator=g).to(cuda)
    T = torch.rand(H, W, generator=g).to(cuda)
    src = torch.tensor(3.0, device=cuda)
    out = curl_advect_epilogue(psi, T, consts, 37.5, src)
    ref = curl_advect_epilogue_plain(psi, T, consts, 37.5, src)
    torch.cuda.synchronize()
    for a, b in zip(out, ref):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


@pytest.mark.cuda
def test_cuda_wrappers_raise_on_bad_input(cuda):
    sw = _random_stack(16, 16, 1, 4, device=cuda)
    x = torch.randn(16, 20, 28, device=cuda)
    with pytest.raises(TypeError):
        layer_stack(x.double(), sw)
    with pytest.raises(ValueError):
        layer_stack(x[:8], sw)
    with pytest.raises(ValueError):
        layer_stack(x.transpose(1, 2).contiguous().transpose(1, 2), sw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,B,field,core_cool,clip_T", [
    (torch.float32, 1, False, False, False),
    (torch.float32, 2, True, False, False),
    (torch.float32, 2, False, True, True),
    (torch.float64, 1, True, False, False),
    (torch.float64, 2, False, False, False),
    (torch.float64, 1, True, True, True)])
def test_cuda_advect_matches_plain(cuda, dtype, B, field, core_cool, clip_T):
    """The energy step at 128×506: scalar and field sources, core cooling
    and the clip. max |diff| / max |plain| ≤ 1e-5 in float32 (the kernel
    contracts multiply-adds into FMAs), ≤ 1e-12 in float64; dt is the
    same max/min reduction and formula, so it agrees to the last bits."""
    H, W = 128, 506
    met = grid_metrics(*Grid(H=H, W=W).coords(cuda, dtype), aspect=4.0)
    g = torch.Generator().manual_seed(4)
    u, v = (40 * torch.randn(B, H, W, generator=g, dtype=dtype)
            for _ in range(2))
    T = torch.rand(B, H, W, generator=g, dtype=dtype) * (3 if clip_T else 1)
    src = (torch.randn(B, H - 2, W - 2, generator=g, dtype=dtype) + 2.0
           if field else torch.tensor(2.5, dtype=dtype))
    u, v, T, src = (t.to(cuda) for t in (u, v, T, src))
    n0 = advect_diffuse_step_fused.launches
    out, dt = advect_diffuse_step_fused(u, v, T, src, met, cn_max=0.99,
                                        core_cool=core_cool, clip_T=clip_T)
    assert advect_diffuse_step_fused.launches == n0 + 1
    ref, dt_ref = advect_diffuse_step_plain(u, v, T, src, met, cn_max=0.99,
                                            core_cool=core_cool,
                                            clip_T=clip_T)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    assert out.dtype == dtype and out.shape == (B, H, W)
    assert abs(float(dt) - float(dt_ref)) <= 1e-6 * float(dt_ref)
    assert float((out - ref).abs().max()) <= tol * float(ref.abs().max())
    # a given dt is used as it is
    out2, dt2 = advect_diffuse_step_fused(u, v, T, src, met, dt=dt_ref,
                                          core_cool=core_cool, clip_T=clip_T)
    assert dt2 is dt_ref
    assert float((out2 - ref).abs().max()) <= tol * float(ref.abs().max())


@pytest.mark.cuda
def test_cuda_advect_raises_on_bad_input(cuda):
    H, W = 16, 24
    met = grid_metrics(*Grid(H=H, W=W).coords(cuda, F32), aspect=4.0)
    u = torch.randn(1, H, W, device=cuda)
    with pytest.raises(TypeError):
        advect_diffuse_step_fused(u.half(), u.half(), u.half(), 1.0, met)
    with pytest.raises(TypeError):      # metrics of another dtype
        advect_diffuse_step_fused(u.double(), u.double(), u.double(), 1.0,
                                  met)
    with pytest.raises(ValueError):
        advect_diffuse_step_fused(u, u[:, :, :-1].contiguous(), u, 1.0, met)
