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
    layer_stack, layer_stack_plain, layer_stacks, layer_stacks_plain,
    pack_stack)
from pbml_mantle_convection_tpu_torch.ops.epilogue_kernel import (
    curl_advect_epilogue, curl_advect_epilogue_plain, epilogue_consts)
from pbml_mantle_convection_tpu_torch.ops.merge_kernel import (
    trunk, trunk_plain, trunk_weights)
from pbml_mantle_convection_tpu_torch.ops.slice_attention import (
    plain_slice_attention, slice_attention_fused, slice_attention_plain,
    slice_deslice, slice_deslice_plain, slice_pool, slice_pool_plain)
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
                  device="cpu", zero_pad=False, act="gelu"):
    """R random layers: learned-boundary (9 kernels each) or, with
    ``zero_pad``, zero-padded SAME convs (1 kernel each); activation
    ``act``."""
    g = torch.Generator().manual_seed(seed)
    layers = []
    ci = c_i
    for _ in range(R):
        w9 = [torch.randn(c_o, ci, 5, 5, generator=g) / (5 * ci ** 0.5)
              for _ in range(1 if zero_pad else 9)]
        layers.append((w9, 0.1 * torch.randn(c_o, generator=g),
                       1 + 0.1 * torch.randn(c_o, generator=g),
                       0.1 * torch.randn(c_o, generator=g)))
        ci = c_o
    layers = [([w.to(device) for w in w9], b.to(device), s.to(device),
               t.to(device)) for w9, b, s, t in layers]
    return pack_stack(layers, groups, use_gn, use_act, act)


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


def _rel(a, b):
    return float((a - b).abs().max()) / float(b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("H,W", [(128, 506), (256, 256)])
def test_cuda_layer_stacks_grouped_matches_plain(cuda, H, W):
    """The five branch stacks in one call per layer (fields 128×506 down
    to 8×31: odd widths 253, 63, 31) against five plain stacks, within
    1e-4 of max |plain|; one launch counted; two calls give the same
    bits."""
    g = torch.Generator().manual_seed(11)
    sizes = [(H >> l, W >> l) for l in range(5)]
    xs = [torch.randn(16, h, w, generator=g).to(cuda) for h, w in sizes]
    sws = [_random_stack(16, 16, 6, 4, seed=20 + l, device=cuda)
           for l in range(5)]
    n0 = layer_stack.launches
    ys = layer_stacks(xs, sws)
    assert layer_stack.launches == n0 + 1
    refs = layer_stacks_plain(xs, sws)
    again = layer_stacks(xs, sws)
    torch.cuda.synchronize()
    for y, ref, y2, (h, w) in zip(ys, refs, again, sizes):
        assert y.shape == (16, h, w)
        assert _rel(y, ref) <= 1e-4
        assert torch.equal(y, y2)


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", [
    (16, 16, 2, 4, True, True, (6, 6)),        # the ring is everything
    (16, 16, 1, 4, True, True, (7, 9)),
    (16, 16, 2, 4, True, True, (64, 253)),
    (16, 16, 2, 4, True, True, (16, 63)),
    (7, 16, 1, 4, True, True, (33, 31)),
    (87, 16, 1, 4, True, True, (40, 70)),
    (16, 8, 3, 2, True, True, (30, 45)),
    (8, 8, 1, 2, True, False, (12, 100)),
    (16, 1, 1, 1, False, False, (128, 506)),
    (16, 16, 1, 1, False, True, (128, 506))])
def test_cuda_layer_stack_shapes(cuda, cfg):
    """One field at the edge cases of the work list: the minimum 6×6
    field, odd sizes, c_in 7 and 87, c_o 16, 8 and 1, with and without
    GroupNorm and GELU; the same bits on a second call."""
    c_i, c_o, R, groups, use_gn, use_act, (H, W) = cfg
    sw = _random_stack(c_i, c_o, R, groups, use_gn, use_act, seed=3,
                       device=cuda)
    x = torch.randn(c_i, H, W, generator=torch.Generator().manual_seed(4))
    x = x.to(cuda)
    y, _ = layer_stack(x, sw)
    y2, _ = layer_stack(x, sw)
    ref, _ = layer_stack_plain(x, sw)
    torch.cuda.synchronize()
    assert y.shape == (c_o, H, W)
    assert _rel(y, ref) <= 1e-4
    assert torch.equal(y, y2)


@pytest.mark.cuda
@pytest.mark.parametrize("H,W", [(128, 506), (256, 256), (96, 130)])
def test_cuda_layer_stack_pyramid_matches_plain(cuda, H, W):
    """The stem with the four successive 2×2 pools of its output (the
    pyramid levels' inputs, odd sizes floor) from its last pass."""
    sw = _random_stack(7, 16, 1, 4, seed=5, device=cuda)
    x = torch.randn(7, H, W, generator=torch.Generator().manual_seed(6))
    x = x.to(cuda)
    y, pools = layer_stack(x, sw, pyramid=4)
    ref, ref_pools = layer_stack_plain(x, sw, pyramid=4)
    torch.cuda.synchronize()
    assert len(pools) == 4
    for a, b in zip([y, *pools], [ref, *ref_pools]):
        assert a.shape == b.shape
        assert _rel(a, b) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("H,W,c_h", [(256, 256, 16), (96, 130, 8)])
def test_cuda_trunk_shapes(cuda, H, W, c_h):
    """The trunk at 256², and at c_h=8 on a grid whose coarse widths are
    odd; the same bits on a second call."""
    merge = _random_stack(5 * c_h + 7, c_h, 1, max(1, c_h // 4), seed=7,
                          device=cuda)
    hw = [(H // 2 ** l, W // 2 ** l) for l in range(1, 5)]
    tw = trunk_weights(merge, hw, H, W)
    g = torch.Generator().manual_seed(8)
    b0 = torch.randn(c_h, H, W, generator=g).to(cuda)
    coarse = [torch.randn(c_h, h, w, generator=g).to(cuda) for h, w in hw]
    x = torch.randn(7, H, W, generator=g).to(cuda)
    n0 = trunk.launches
    y = trunk(b0, coarse, x, tw)
    assert trunk.launches == n0 + 1
    y2 = trunk(b0, coarse, x, tw)
    yp = trunk_plain(b0, coarse, x, tw)
    torch.cuda.synchronize()
    assert _rel(y, yp) <= 1e-4
    assert torch.equal(y, y2)


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


def _epilogue_inputs(H, W, device, seed=3):
    xc = torch.linspace(0, 4, W, dtype=F32).expand(H, W)
    yc = torch.linspace(0, 1, H, dtype=F32)[:, None].expand(H, W)
    met = grid_metrics(xc.to(device), yc.to(device), aspect=4.0)
    consts = epilogue_consts(met, 4.0, 0.99)
    g = torch.Generator().manual_seed(seed)
    psi = torch.randn(H, W, generator=g).to(device)
    T = torch.rand(H, W, generator=g).to(device)
    return consts, psi, T, torch.tensor(3.0, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("H,W", [(128, 506), (256, 256), (16, 32), (5, 7),
                                 (18, 34)])
def test_cuda_epilogue_matches_plain(cuda, H, W):
    """u, v, T_new within 1e-5 of max |plain|, dt within 1e-6, and the
    same bits on a second call; one launch per call."""
    consts, psi, T, src = _epilogue_inputs(H, W, cuda)
    n0 = curl_advect_epilogue.launches
    out = curl_advect_epilogue(psi, T, consts, 37.5, src)
    assert curl_advect_epilogue.launches == n0 + 1
    ref = curl_advect_epilogue_plain(psi, T, consts, 37.5, src)
    again = curl_advect_epilogue(psi, T, consts, 37.5, src)
    torch.cuda.synchronize()
    for a, b in zip(out[:3], ref[:3]):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    assert abs(float(out[3]) - float(ref[3])) <= 1e-6 * float(ref[3])
    assert all(torch.equal(a, b) for a, b in zip(out, again))


@pytest.mark.cuda
@pytest.mark.parametrize("H,W", [(128, 506), (5, 7)])
def test_cuda_energy_kernels_at_zero_velocity(cuda, H, W):
    """A constant ψ (epilogue) or u = v = 0 (energy step): the advective
    limit is infinite, and dt must be the plain version's dt_diffuse to
    the bit; T_new agrees with the plain version."""
    consts, psi, T, src = _epilogue_inputs(H, W, cuda)
    psi = torch.full_like(psi, 0.7)
    u, v, T_new, dt = curl_advect_epilogue(psi, T, consts, 37.5, src)
    ref = curl_advect_epilogue_plain(psi, T, consts, 37.5, src)
    assert not u.any() and not v.any()
    assert float(dt) == float(ref[3]) == consts.dt_diffuse
    assert float((T_new - ref[2]).abs().max()) <= 1e-5 * float(
        ref[2].abs().max())
    for dtype in (torch.float32, torch.float64):
        met = grid_metrics(*Grid(H=H, W=W).coords(cuda, dtype), aspect=4.0)
        z = torch.zeros(2, H, W, dtype=dtype, device=cuda)
        Tb = torch.rand(2, H, W, dtype=dtype, device=cuda)
        out, dt = advect_diffuse_step_fused(z, z, Tb, 2.5, met)
        ref, dt_ref = advect_diffuse_step_plain(z, z, Tb, 2.5, met)
        assert float(dt) == float(dt_ref) and torch.isfinite(out).all()
        tol = 1e-5 if dtype == torch.float32 else 1e-12
        assert float((out - ref).abs().max()) <= tol * float(
            ref.abs().max())


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
    consts, psi, T, src = _epilogue_inputs(16, 32, cuda)
    with pytest.raises(TypeError):
        curl_advect_epilogue(psi.double(), T, consts, 37.5, src)
    with pytest.raises(ValueError):     # constants of another grid
        curl_advect_epilogue(psi[:, :-1].contiguous(), T[:, :-1].contiguous(),
                             consts, 37.5, src)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,H,W,field,core_cool,clip_T", [
    (1, 128, 506, False, False, False),
    (2, 128, 506, True, False, False),
    (2, 128, 506, False, True, True),
    (1, 128, 506, True, True, True),
    (16, 128, 506, True, False, False),
    (16, 128, 506, False, True, True),
    (3, 5, 7, True, True, True),
    (2, 18, 34, False, False, False)])
def test_cuda_advect_matches_plain(cuda, dtype, B, H, W, field, core_cool,
                                   clip_T):
    """The energy step: scalar and field sources, core cooling and the
    clip, at 128×506, at small and odd grids, and at B = 16 (more points
    than the card holds threads at once, so the blocks loop and re-read
    their inputs past the grid sync). max |diff| / max |plain| ≤ 1e-5 in
    float32 (the kernel contracts multiply-adds into FMAs), ≤ 1e-12 in
    float64; one dt for the batch, the same max/min reduction and formula,
    within 1e-6; the same bits on a second call; one launch per call."""
    met = grid_metrics(*Grid(H=H, W=W).coords(cuda, dtype), aspect=4.0)
    g = torch.Generator().manual_seed(4 + B + H)
    u, v = (40 * torch.randn(B, H, W, generator=g, dtype=dtype)
            for _ in range(2))
    T = torch.rand(B, H, W, generator=g, dtype=dtype) * (3 if clip_T else 1)
    src = (torch.randn(B, H - 2, W - 2, generator=g, dtype=dtype) + 2.0
           if field else torch.tensor(2.5, dtype=dtype))
    u, v, T, src = (t.to(cuda) for t in (u, v, T, src))
    kw = dict(core_cool=core_cool, clip_T=clip_T)
    n0 = advect_diffuse_step_fused.launches
    out, dt = advect_diffuse_step_fused(u, v, T, src, met, cn_max=0.99, **kw)
    assert advect_diffuse_step_fused.launches == n0 + 1
    again = advect_diffuse_step_fused(u, v, T, src, met, cn_max=0.99, **kw)
    ref, dt_ref = advect_diffuse_step_plain(u, v, T, src, met, cn_max=0.99,
                                            **kw)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    assert out.dtype == dtype and out.shape == (B, H, W)
    assert abs(float(dt) - float(dt_ref)) <= 1e-6 * float(dt_ref)
    assert float((out - ref).abs().max()) <= tol * float(ref.abs().max())
    assert torch.equal(out, again[0]) and torch.equal(dt, again[1])
    # a given dt is used as it is
    out2, dt2 = advect_diffuse_step_fused(u, v, T, src, met, dt=dt_ref, **kw)
    assert dt2 is dt_ref
    assert float((out2 - ref).abs().max()) <= tol * float(ref.abs().max())


@pytest.mark.cuda
def test_cuda_energy_kernels_replay_in_a_graph(cuda):
    """One epilogue call and one adaptive energy step captured in a CUDA
    graph: replays on new inputs copied into the static buffers give the
    bits of eager calls on the same inputs."""
    consts, psi, T, src = _epilogue_inputs(128, 506, cuda)
    met = consts.metrics
    u = 40 * torch.randn(1, 128, 506, device=cuda)
    static = [psi.clone(), T.clone(), u.clone(), u.flip(-1).contiguous()]

    def both(psi, T, u, v):
        return (*curl_advect_epilogue(psi, T, consts, 37.5, src),
                *advect_diffuse_step_fused(u, v, T[None], src, met,
                                           cn_max=0.99))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        both(*static)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = both(*static)
    for k in range(3):
        new = [psi * (1 + 0.2 * k), torch.clamp(T + 0.01 * k, 0, 1),
               u * (1 - 0.2 * k), u.flip(-2).contiguous()]
        for a, b in zip(static, new):
            a.copy_(b)
        graph.replay()
        eager = both(*new)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(outs, eager))


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


def _slice_inputs(BH, N, D, G, dtype, device, seed=6):
    g = torch.Generator().manual_seed(seed)
    fx, xm = (torch.randn(BH, N, D, generator=g, dtype=dtype)
              for _ in range(2))
    ws = 0.3 * torch.randn(D, G, generator=g, dtype=dtype)
    bs = 0.1 * torch.randn(G, generator=g, dtype=dtype)
    temp = 0.3 + 0.4 * torch.rand(BH, generator=g, dtype=dtype)
    tok = torch.randn(BH, G, D, generator=g, dtype=dtype)
    return [t.to(device) for t in (fx, xm, ws, bs, temp, tok)]


# max |kernel - plain| / max |plain|: float32 sums in another order than
# the plain product (the pool's on the tensor cores in 3xTF32); 16-bit
# storage against the plain version in float32 of the same 16-bit inputs,
# within the rounding of a bfloat16 output (2^-8 relative, ~4e-3, twice)
SLICE_TOL = {torch.float32: 1e-5, torch.float64: 1e-12,
             torch.bfloat16: 8e-3, torch.float16: 1e-3}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16, torch.float16])
@pytest.mark.parametrize("BH,N,D,G", [(6, 200, 8, 16), (8, 4133, 16, 32),
                                      (3, 1000, 32, 64), (2, 300, 64, 64),
                                      (2, 700, 128, 128), (4, 1001, 16, 128),
                                      (4, 1001, 128, 16)])
def test_cuda_slice_kernels_match_plain(cuda, dtype, BH, N, D, G):
    """Both kernels against their plain versions, ragged N (no size here
    is a multiple of the tile), D and G up to 128, every storage type
    (tolerances: SLICE_TOL); two calls give the same bits."""
    fx, xm, ws, bs, temp, tok = _slice_inputs(BH, N, D, G, dtype, cuda)
    n0, m0 = slice_pool.launches, slice_deslice.launches
    num, den = slice_pool(fx, xm, ws, bs, temp)
    out = slice_deslice(xm, tok, ws, bs, temp)
    assert (slice_pool.launches, slice_deslice.launches) == (n0 + 1, m0 + 1)
    wide = [t.float() if dtype in (torch.bfloat16, torch.float16) else t
            for t in (fx, xm, ws, bs, temp, tok)]
    num_p, den_p = slice_pool_plain(*wide[:5])
    out_p = slice_deslice_plain(wide[1], wide[5], *wide[2:5])
    torch.cuda.synchronize()
    for a, b in ((num, num_p), (den, den_p), (out, out_p)):
        assert a.dtype == dtype and a.shape == b.shape
        assert (float((a.to(b.dtype) - b).abs().max())
                <= SLICE_TOL[dtype] * float(b.abs().max()))
    num2, den2 = slice_pool(fx, xm, ws, bs, temp)
    assert torch.equal(num, num2) and torch.equal(den, den2)
    assert torch.equal(out, slice_deslice(xm, tok, ws, bs, temp))


def _heads_view(x, B, H, pad=0):
    """(B·H, N, D) values as the (B, H, N, D) view of a (B, N, H·D + pad)
    tensor: the layout of the Dense or channels-last projections (pad > 0:
    rows that are not a multiple of 16 bytes apart)."""
    BH, N, D = x.shape
    rows = torch.zeros(B, N, H * D + pad, dtype=x.dtype, device=x.device)
    view = rows[..., :H * D].view(B, N, H, D).permute(0, 2, 1, 3)
    view.copy_(x.reshape(B, H, N, D))
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16, torch.float16])
@pytest.mark.parametrize("BH,N,D,G", [(6, 200, 8, 16), (8, 4133, 16, 32),
                                      (3, 1000, 32, 64), (2, 300, 64, 64),
                                      (2, 700, 128, 128), (4, 1001, 16, 128),
                                      (4, 1001, 128, 16), (3, 777, 7, 5),
                                      (5, 333, 20, 24)])
def test_cuda_slice_kernels_strided_match_plain(cuda, dtype, BH, N, D, G):
    """Both kernels on (B, H, N, D) views of (B, N, H·D) rows (x_mid) and
    of padded rows (fx, unaligned for the 16-bit types' cp.async), with
    the ws of a Dense weight's transpose, against the plain versions of
    the same values (tolerances: SLICE_TOL); the deslice writes the
    (B, N, H·D) rows, and a second call gives the same bits."""
    fx, xm, ws, bs, temp, tok = _slice_inputs(BH, N, D, G, dtype, cuda)
    B = 2 if BH % 2 == 0 else 1
    H = BH // B
    fxv, xmv = _heads_view(fx, B, H, pad=1), _heads_view(xm, B, H)
    wsv = ws.t().contiguous().t()
    temp = temp[:H].contiguous()
    tokv = tok.reshape(B, H, G, D)
    num, den = slice_pool(fxv, xmv, wsv, bs, temp)
    out = slice_deslice(xmv, tokv, wsv, bs, temp)
    assert out.shape == (B, H, N, D)
    flat = out.transpose(1, 2).reshape(B, N, H * D)
    assert flat.data_ptr() == out.data_ptr() and flat.is_contiguous()
    wide = [t.float() if dtype in (torch.bfloat16, torch.float16) else t
            for t in (fxv, xmv, ws, bs, temp, tokv)]
    num_p, den_p = slice_pool_plain(*wide[:5])
    out_p = slice_deslice_plain(wide[1], wide[5], *wide[2:5])
    torch.cuda.synchronize()
    for a, b in ((num, num_p), (den, den_p), (out, out_p)):
        assert a.dtype == dtype and a.shape == b.shape
        assert (float((a.to(b.dtype) - b).abs().max())
                <= SLICE_TOL[dtype] * float(b.abs().max()))
    assert torch.equal(out, slice_deslice(xmv, tokv, wsv, bs, temp))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,G", [(256, 160), (160, 256)])
def test_cuda_slice_kernels_simt_wide_match_plain(cuda, dtype, D, G):
    """D or G > 128 runs through the SIMT kernels, contiguous and on
    (B, H, N, D) views, and matches the plain versions (SLICE_TOL)."""
    fx, xm, ws, bs, temp, tok = _slice_inputs(4, 700, D, G, dtype, cuda)
    temp = temp[:2].repeat(2)           # temp[h] of bh = 2 b + h
    wide = [t.float() for t in (fx, xm, ws, bs, temp, tok)]
    num_p, den_p = slice_pool_plain(*wide[:5])
    out_p = slice_deslice_plain(wide[1], wide[5], *wide[2:5])
    views = (_heads_view(fx, 2, 2, pad=3), _heads_view(xm, 2, 2),
             temp[:2].contiguous(), tok.reshape(2, 2, G, D))
    for f, x, t, k in ((fx, xm, temp, tok), views):
        num, den = slice_pool(f, x, ws, bs, t)
        out = slice_deslice(x, k, ws, bs, t)
        torch.cuda.synchronize()
        for a, b in ((num, num_p), (den, den_p), (out, out_p)):
            a = a.reshape(b.shape).float()
            assert (float((a - b).abs().max())
                    <= SLICE_TOL[dtype] * float(b.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_slice_attention_matches_plain(cuda, dtype):
    g = torch.Generator().manual_seed(7)
    B, H, N, D, G = 2, 3, 517, 16, 32
    fx, xm = (torch.randn(B, H, N, D, generator=g, dtype=dtype)
              for _ in range(2))
    ws = 0.3 * torch.randn(D, G, generator=g, dtype=dtype)
    bs = 0.1 * torch.randn(G, generator=g, dtype=dtype)
    temp = 0.4 + 0.2 * torch.rand(1, H, 1, 1, generator=g, dtype=dtype)
    wq, wk, wv = (0.3 * torch.randn(D, D, generator=g, dtype=dtype)
                  for _ in range(3))
    args = [t.to(cuda) for t in (fx, xm, ws, bs, temp, wq, wk, wv)]
    out = slice_attention_fused(*args)
    ref = slice_attention_plain(*args)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    assert float((out - ref).abs().max()) <= tol * float(ref.abs().max())


@pytest.mark.cuda
def test_cuda_slice_kernels_raise_on_bad_input(cuda):
    fx, xm, ws, bs, temp, tok = _slice_inputs(2, 100, 8, 16, F32, cuda)
    with pytest.raises(TypeError):
        slice_pool(fx.int(), xm.int(), ws.int(), bs.int(), temp.int())
    with pytest.raises(TypeError):
        slice_deslice(xm, tok, ws.double(), bs, temp)
    big = _slice_inputs(1, 10, 129, 4, F32, cuda)
    num, den = slice_pool(*big[:5])
    num_p, den_p = slice_pool_plain(*big[:5])
    torch.cuda.synchronize()
    assert float((num - num_p).abs().max()) <= 1e-5 * float(num_p.abs().max())
    assert float((den - den_p).abs().max()) <= 1e-5 * float(den_p.abs().max())
    huge = _slice_inputs(1, 10, 4096, 4, F32, cuda)
    with pytest.raises(ValueError, match="what shared memory holds"):
        slice_pool(*huge[:5])
    with pytest.raises(ValueError):
        slice_pool(fx, xm.transpose(1, 2).contiguous().transpose(1, 2), ws,
                   bs, temp)
    with pytest.raises(ValueError):
        slice_deslice(xm, tok[:, :8].contiguous(), ws, bs, temp)


@pytest.mark.cuda
def test_cuda_transolver_goes_through_the_kernels(cuda):
    """A small TransolverStructured2D on the card: one launch of each
    kernel per block, and the kernel path's u, v within 1e-4 (relative to
    max |plain|) of the same model with the einsum formulation."""
    from pbml_mantle_convection_tpu_torch.models import transolver
    m = transolver.TransolverStructured2D(H=16, W=24, n_layers=3,
                                          n_hidden=32, n_head=2,
                                          slice_num=8, device=cuda)
    x = torch.randn(1, 16 * 24, 7, generator=torch.Generator().manual_seed(8))
    x = x.to(cuda)
    n0, m0 = slice_pool.launches, slice_deslice.launches
    with torch.no_grad():
        u, v, _ = m(x)
        assert (slice_pool.launches - n0, slice_deslice.launches - m0) == (3, 3)
        with plain_slice_attention():
            up, vp, _ = m(x)
    for a, b in ((u, up), (v, vp)):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


def _rel64(a, ref):
    return float((a.double() - ref).abs().max()) / float(ref.abs().max())


@pytest.mark.cuda
def test_cuda_module_convs_float32_at_default_flags(cuda, monkeypatch):
    """Under PyTorch's default flags (cuDNN may run float32 convs in TF32:
    8.9e-4 and 2.4e-4 here before the float32 guard, on an H100) the
    port's module paths convolve in float32: a NewFluidNet with c_h=16 and
    a TransolverStructured2D with n_hidden=256 (narrower convs do not take
    the TF32 kernels) within 1e-4 of max |f64| of the same modules in
    float64 (PERF.md §2's bound for the conv kernels)."""
    import copy

    from pbml_mantle_convection_tpu_torch.models.fluidnet import NewFluidNet
    from pbml_mantle_convection_tpu_torch.models.transolver import (
        TransolverStructured2D)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    g = torch.Generator().manual_seed(12)
    nets = [
        (NewFluidNet(levels=3, c_i=7, c_h=16, c_o=1, act_fn="gelu",
                     r_p="learned", loss_type="curl", repeats=2, f=5,
                     p_pred=False, seed=0, device=cuda),
         torch.rand(1, 64, 96, 7, generator=g)),
        (TransolverStructured2D(H=32, W=48, n_layers=2, n_hidden=256,
                                n_head=8, slice_num=32, seed=0, device=cuda),
         torch.rand(1, 32 * 48, 7, generator=g))]
    with torch.no_grad():
        for net, x in nets:
            x = x.to(cuda)
            got = net(x)
            ref = copy.deepcopy(net).double()(x.double())
            assert torch.backends.cudnn.allow_tf32     # restored
            for a, b in zip(got[:2], ref[:2]):
                assert a.dtype == F32
                assert _rel64(a, b) <= 1e-4


ZERO_STACKS = [
    (7, 16, 1, 4, True, True, (128, 506)),     # the stem
    (16, 16, 6, 4, True, True, (64, 253)),     # a branch
    (16, 16, 6, 4, True, True, (8, 31)),
    (16, 16, 1, 1, False, True, (128, 506)),   # merge 2
    (16, 1, 1, 1, False, False, (128, 506)),   # merge 3
    (87, 16, 1, 4, True, True, (40, 70)),
    (16, 8, 3, 2, True, True, (30, 45)),
    (8, 8, 2, 2, True, True, (3, 5)),          # smaller than the window
    (16, 16, 2, 4, True, True, (9, 33))]       # one past a tile each way


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", ZERO_STACKS)
def test_cuda_layer_stack_zero_padding_matches_plain(cuda, cfg):
    """The zero-padded instance (learned=False of the JAX kernel) against
    ``F.conv2d(F.pad(x, (2, 2, 2, 2)), w, b)`` + GroupNorm + GELU within
    1e-4 of max |plain|, at the flagship's shapes and at the edge cases
    of its item decode (8×32 tiles from (0, 0) with the window at -2, no
    ring items: fields smaller than one window, one past a tile each
    way). The ring is where a clamped read (replicate padding) would
    show, and where padding must stay 0 after the next layer's GroupNorm
    and GELU are applied while it stages (R > 1). Same bits twice."""
    c_i, c_o, R, groups, use_gn, use_act, (H, W) = cfg
    sw = _random_stack(c_i, c_o, R, groups, use_gn, use_act, seed=3,
                       device=cuda, zero_pad=True)
    assert sw.zero_pad
    x = torch.randn(c_i, H, W, generator=torch.Generator().manual_seed(4))
    x = x.to(cuda)
    n0 = layer_stack.launches
    y, _ = layer_stack(x, sw)
    assert layer_stack.launches == n0 + 1
    y2, _ = layer_stack(x, sw)
    ref, _ = layer_stack_plain(x, sw)
    torch.cuda.synchronize()
    assert y.shape == (c_o, H, W)
    assert _rel(y, ref) <= 1e-4
    assert torch.equal(y, y2)
    # the ring alone: where replicate padding (a clamped read) would differ
    edge = torch.ones(H, W, dtype=torch.bool, device=cuda)
    edge[2:-2, 2:-2] = False
    assert _rel(y[:, edge], ref[:, edge]) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("H,W", [(128, 506), (256, 256)])
def test_cuda_layer_stacks_zero_padding_grouped_and_pyramid(cuda, H, W):
    """The zero instance as the executor calls it: the stem with its
    four pyramid pools, then the five branch stacks in one call per
    layer; each against its plain version within 1e-4; 2 launches."""
    g = torch.Generator().manual_seed(12)
    stem = _random_stack(7, 16, 1, 4, seed=30, device=cuda, zero_pad=True)
    sws = [_random_stack(16, 16, 6, 4, seed=40 + l, device=cuda,
                         zero_pad=True) for l in range(5)]
    x = torch.randn(7, H, W, generator=g).to(cuda)
    n0 = layer_stack.launches
    b0, pools = layer_stack(x, stem, pyramid=4)
    ys = layer_stacks([b0, *pools], sws)
    assert layer_stack.launches == n0 + 2
    rb0, rpools = layer_stack_plain(x, stem, pyramid=4)
    refs = layer_stacks_plain([b0, *pools], sws)
    torch.cuda.synchronize()
    for a, b in zip([b0, *pools, *ys], [rb0, *rpools, *refs]):
        assert a.shape == b.shape
        assert _rel(a, b) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("H,W,c_h", [(128, 506, 16), (256, 256, 16),
                                     (96, 130, 8)])
def test_cuda_trunk_zero_padding_matches_plain(cuda, H, W, c_h):
    """The trunk's zero instance: the upsampled branches and the skip
    channels read 0 outside the field (not an interpolated or clamped
    value), then the zero-padded merge-1, GroupNorm, GELU; within 1e-4 of
    the plain version, one launch, the same bits twice."""
    merge = _random_stack(5 * c_h + 7, c_h, 1, max(1, c_h // 4), seed=9,
                          device=cuda, zero_pad=True)
    hw = [(H // 2 ** l, W // 2 ** l) for l in range(1, 5)]
    tw = trunk_weights(merge, hw, H, W)
    assert tw.zero_pad
    g = torch.Generator().manual_seed(10)
    b0 = torch.randn(c_h, H, W, generator=g).to(cuda)
    coarse = [torch.randn(c_h, h, w, generator=g).to(cuda) for h, w in hw]
    x = torch.randn(7, H, W, generator=g).to(cuda)
    n0 = trunk.launches
    y = trunk(b0, coarse, x, tw)
    assert trunk.launches == n0 + 1
    y2 = trunk(b0, coarse, x, tw)
    yp = trunk_plain(b0, coarse, x, tw)
    torch.cuda.synchronize()
    assert _rel(y, yp) <= 1e-4
    assert torch.equal(y, y2)


@pytest.mark.cuda
def test_cuda_zero_padding_rollout_through_the_kernels(cuda):
    """The flagship's widths with ``r_p="zeros"`` at 128×506, B = 1: the
    fused executor runs the zero instances, 4 ``layer_stack`` + 1
    ``trunk`` + 1 ``curl_advect_epilogue`` launches per step; 10 steps
    agree with the module path within chip_smoke.py's TOL_ROLLOUT."""
    import numpy as np
    from pbml_mantle_convection_tpu_torch.cli.benchmark import (
        initial_temperature)
    from pbml_mantle_convection_tpu_torch.constants import SimParams
    from pbml_mantle_convection_tpu_torch.models.fast_path import (
        FastNewFluidNet)
    from pbml_mantle_convection_tpu_torch.models.fluidnet import NewFluidNet
    from pbml_mantle_convection_tpu_torch.sim.engine import SimEngine
    from pbml_mantle_convection_tpu_torch.sim.stepper import TimeStepper
    H, W, K = 128, 506, 10
    grid = Grid(H=H, W=W, aspect=(W - 2) / (H - 2))
    model = NewFluidNet(levels=5, c_i=7, c_h=16, c_o=1, act_fn="gelu",
                        r_p="zeros", loss_type="curl", repeats=6, f=5,
                        p_pred=False, seed=0, device=cuda)
    fast = FastNewFluidNet(model, H, W)
    assert fast.zero_pad
    finals = []
    wrappers = (layer_stack, trunk, curl_advect_epilogue,
                advect_diffuse_step_fused)
    for apply_fn in (fast, model):
        eng = SimEngine(TimeStepper(grid, SimParams(3.0, 1e8, 10.0),
                                    apply_fn, cn_max=0.99, device=cuda))
        before = [fn.launches for fn in wrappers]
        state = eng.multi_step(eng.init_state(initial_temperature(grid)),
                               K)[0]
        torch.cuda.synchronize()
        got = [fn.launches - n for fn, n in zip(wrappers, before)]
        fused = apply_fn is fast
        assert got == [4 * K * fused, K * fused, K * fused, K * (not fused)]
        assert bool(torch.isfinite(state.T).all())
        finals.append(state)
    for name, tol in (("T", 1e-3), ("u", 2e-2), ("v", 2e-2)):
        k, p = getattr(finals[0], name), getattr(finals[1], name)
        rel = float((k - p).abs().max() / p.abs().max())
        assert rel <= tol, (name, rel)
    assert np.isclose(float(finals[0].t), float(finals[1].t), rtol=1e-3)


@pytest.mark.cuda
def test_cuda_batched_rollout_through_the_kernels(cuda):
    """B = 4 at 128×506: the fused executor runs each simulation (4B
    ``layer_stack`` + B ``trunk`` launches per step), the energy step one
    batched ``advect_diffuse_step_fused`` launch, no epilogue; 10 steps
    agree with the module path within chip_smoke.py's TOL_ROLLOUT."""
    import numpy as np
    from pbml_mantle_convection_tpu_torch.cli.benchmark import (
        initial_temperature)
    from pbml_mantle_convection_tpu_torch.constants import SimParams
    from pbml_mantle_convection_tpu_torch.models.fast_path import (
        FastNewFluidNet)
    from pbml_mantle_convection_tpu_torch.models.fluidnet import NewFluidNet
    from pbml_mantle_convection_tpu_torch.sim.engine import SimEngine
    from pbml_mantle_convection_tpu_torch.sim.stepper import TimeStepper
    H, W, B, K = 128, 506, 4, 10
    grid = Grid(H=H, W=W, aspect=(W - 2) / (H - 2))
    model = NewFluidNet(levels=5, c_i=7, c_h=16, c_o=1, act_fn="gelu",
                        r_p="learned", loss_type="curl", repeats=6, f=5,
                        p_pred=False, seed=0, device=cuda)
    T0 = initial_temperature(grid, B)
    finals = []
    wrappers = (layer_stack, trunk, advect_diffuse_step_fused,
                curl_advect_epilogue)
    for apply_fn in (FastNewFluidNet(model, H, W), model):
        eng = SimEngine(TimeStepper(grid, SimParams(3.0, 1e8, 10.0),
                                    apply_fn, cn_max=0.99, device=cuda))
        before = [fn.launches for fn in wrappers]
        state = eng.multi_step(eng.init_state(T0), K)[0]
        torch.cuda.synchronize()
        got = [fn.launches - n for fn, n in zip(wrappers, before)]
        fused = apply_fn is not model
        assert got == [4 * B * K * fused, B * K * fused, K, 0]
        assert state.T.shape == (B, H, W)
        assert bool(torch.isfinite(state.T).all())
        finals.append(state)
    for name, tol in (("T", 1e-3), ("u", 2e-2), ("v", 2e-2)):
        k, p = getattr(finals[0], name), getattr(finals[1], name)
        rel = float((k - p).abs().max() / p.abs().max())
        assert rel <= tol, (name, rel)
    assert np.isclose(float(finals[0].t), float(finals[1].t), rtol=1e-3)


def _train_grads(net, x, y, net_name, guarded=True):
    """Parameter gradients of one train step of ``net`` (``guarded``:
    through ``make_train_step``; else the loss and backward outside the
    step's float32 guard, the modules' forward guard alone)."""
    from pbml_mantle_convection_tpu_torch.train.train_step import (
        TrainStepConfig, make_loss_fn, make_train_step)
    from pbml_mantle_convection_tpu_torch.train.trainer import adam_l2
    cfg = TrainStepConfig(net=net_name, loss_scale=True, loss_derivative=True,
                          loss_type="curl")
    batch = {"x": x, "y": y}
    if guarded:
        make_train_step(net, adam_l2(net.parameters(), 0.0), cfg)(batch)
    else:
        make_loss_fn(net, cfg)(batch).total.backward()
    return {n: q.grad for n, q in net.named_parameters()}


def _small_train_nets(cuda):
    from pbml_mantle_convection_tpu_torch.models.fluidnet import NewFluidNet
    from pbml_mantle_convection_tpu_torch.models.transolver import (
        TransolverStructured2D)
    g = torch.Generator().manual_seed(13)
    return [
        ("newfluidnet",
         lambda: NewFluidNet(levels=3, c_i=7, c_h=16, c_o=1, act_fn="gelu",
                             r_p="learned", loss_type="curl", repeats=2,
                             f=5, p_pred=False, seed=0, device=cuda),
         torch.rand(2, 64, 96, 7, generator=g).to(cuda),
         torch.randn(2, 2, 64, 96, generator=g).to(cuda)),
        ("transolver_structured",
         lambda: TransolverStructured2D(H=32, W=48, n_layers=2, n_hidden=256,
                                        n_head=8, slice_num=32, seed=0,
                                        device=cuda),
         torch.rand(2, 32 * 48, 7, generator=g).to(cuda),
         torch.randn(2, 2, 32, 48, generator=g).to(cuda))]


@pytest.mark.cuda
def test_cuda_train_step_gradients_float32_at_default_flags(cuda,
                                                            monkeypatch):
    """Under PyTorch's default flags (cuDNN may run float32 convs in TF32)
    a train step's parameter gradients of a NewFluidNet (c_h=16) and a
    TransolverStructured2D (n_hidden=256) read ≤ 1e-4 (max |diff| over
    max |f64|, all parameters) of the same step in float64; the same
    gradients with the backward outside the step's float32 guard (the
    TF32 control) read above it; the flag is restored and no kernel
    wrapper launches."""
    import copy
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    wrappers = (layer_stack, trunk, curl_advect_epilogue,
                advect_diffuse_step_fused, slice_pool, slice_deslice)
    for name, build, x, y in _small_train_nets(cuda):
        net = build()
        ref = _train_grads(copy.deepcopy(net).double(), x.double(),
                           y.double(), name)
        top = max(float(g.abs().max()) for g in ref.values())
        before = [fn.launches for fn in wrappers]
        errs = []
        for guarded in (True, False):
            got = _train_grads(copy.deepcopy(net), x, y, name, guarded)
            errs.append(max(float((got[n].double() - g).abs().max())
                            for n, g in ref.items()) / top)
            assert torch.backends.cudnn.allow_tf32
        assert [fn.launches for fn in wrappers] == before
        assert errs[0] <= 1e-4 < errs[1], (name, errs)


@pytest.mark.cuda
def test_cuda_transolver_train_step_reaches_every_parameter(cuda):
    """On the card a train step of the Transolver runs the einsum path
    (no slice kernel launches) and every parameter gets a gradient; the
    two biases of the last block that the curl head differentiates away
    get rounding noise only."""
    name, build, x, y = _small_train_nets(cuda)[1]
    net = build()
    n0, m0 = slice_pool.launches, slice_deslice.launches
    grads = _train_grads(net, x, y, name)
    assert (slice_pool.launches, slice_deslice.launches) == (n0, m0)
    noise = {"blocks_1.ln_3.bias", "blocks_1.mlp2.bias"}
    for n, g in grads.items():
        assert g is not None, n
        if n not in noise:
            assert float(g.abs().max()) > 0, n
    with torch.no_grad():
        net(x)
    assert (slice_pool.launches - n0, slice_deslice.launches - m0) == (2, 2)


@pytest.mark.cuda
def test_cuda_transolver_forward_under_autograd_keeps_the_kernels(cuda):
    """A Transolver forward on the card with grad on, outside the train
    step (``model(x)`` in a script), launches the slice kernels, and its
    backward (the einsum formulation recomputed) gives the train step's
    gradients, within the train-step bound (1e-4 of max |grad|) of the
    einsum path throughout."""
    import copy

    from pbml_mantle_convection_tpu_torch.models.layers import float32_convs
    from pbml_mantle_convection_tpu_torch.train.losses import fluidnet_loss
    name, build, x, y = _small_train_nets(cuda)[1]
    net = build()
    want = _train_grads(copy.deepcopy(net), x, y, name)
    n0, m0 = slice_pool.launches, slice_deslice.launches
    with float32_convs(x):
        u, v, p = net(x)
        fluidnet_loss(u, v, p, y[..., 1:-1, 1:-1], p_pred=False,
                      loss_scale=True, loss_derivative=True,
                      loss_type="curl").total.backward()
    assert (slice_pool.launches - n0, slice_deslice.launches - m0) == (2, 2)
    top = max(float(g.abs().max()) for g in want.values())
    err = max(float((q.grad - want[n]).abs().max())
              for n, q in net.named_parameters())
    assert err <= 1e-4 * top, err / top


@pytest.mark.cuda
def test_cuda_slice_kernels_raise_under_autograd(cuda):
    fx, xm, ws, bs, temp, tok = _slice_inputs(2, 100, 8, 16, F32, cuda)
    n0, m0 = slice_pool.launches, slice_deslice.launches
    xm = xm.clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        slice_pool(fx, xm, ws, bs, temp)
    with pytest.raises(RuntimeError, match="no backward"):
        slice_deslice(xm, tok, ws, bs, temp)
    assert (slice_pool.launches, slice_deslice.launches) == (n0, m0)
    with torch.no_grad():
        slice_pool(fx, xm, ws, bs, temp)
    assert slice_pool.launches == n0 + 1


@pytest.mark.cuda
def test_cuda_host_resident_batches_equal_device_resident(cuda):
    """The host-resident mode (a prefetch thread gathers rows from a numpy
    store and copies them to the card) gives the device-resident mode's
    batches bit for bit, noise included, over two epochs."""
    import numpy as np
    from pbml_mantle_convection_tpu_torch.constants import SimParams
    from pbml_mantle_convection_tpu_torch.data.dataset import SnapshotDataset
    from pbml_mantle_convection_tpu_torch.data.synthetic import (
        synthetic_store)
    store = synthetic_store(Grid(H=128, W=506, aspect=504 / 126),
                            params_list=[SimParams(3.0, 1e8, 10.0),
                                         SimParams(1.0, 1e7, 3.0)],
                            n_snapshots=12, with_p=True)
    kw = dict(p_pred=True, noise=1e-5, device=cuda)
    dev = SnapshotDataset(store, host_resident=False, **kw)
    host = SnapshotDataset(store, host_resident=True, prefetch=3, **kw)
    r1, r2 = np.random.default_rng(4), np.random.default_rng(4)
    n = 0
    for _ in range(2):
        for a, b in zip(dev.epoch_batches(r1, 5), host.epoch_batches(r2, 5)):
            assert a["x"].is_cuda and b["x"].is_cuda
            for k in a:
                assert torch.equal(a[k], b[k]), k
            n += 1
    assert n == 2 * (24 // 5)


ACTS = ("gelu", "selu", "elu", "silu", "relu", "tanh", "sine")


def _double(sw):
    """The same layers as ``sw`` in float64, for the plain version."""
    import dataclasses
    return dataclasses.replace(
        sw, kernels=tuple(tuple(k.double() for k in ws) for ws in sw.kernels),
        bias=sw.bias.double(), gn_scale=sw.gn_scale.double(),
        gn_bias=sw.gn_bias.double())


def _hold_act(act, got, plain, plain64):
    """Kernel against plain within 1e-4 of max |plain|; for ``sine``
    (each sin(30·) turns float32 rounding into ~1e-4) the kernel's error
    against float64 within 10x the plain float32 path's own."""
    if act != "sine":
        assert _rel(got, plain) <= 1e-4
        return
    ek, ep = _rel(got.double(), plain64), _rel(plain.double(), plain64)
    assert ek <= 10 * ep, (ek, ep)


@pytest.mark.cuda
@pytest.mark.parametrize("zero_pad", [False, True])
@pytest.mark.parametrize("act", ACTS)
def test_cuda_layer_stack_activations_match_plain(cuda, act, zero_pad):
    """Each activation's instances (learned and zero padding) at the
    three sites that apply it: staging the next layer's input (R = 2),
    the pass after the last GroupNorm, and the epilogue of a layer
    without GroupNorm (merge 2's form); the grouped branch call; the same
    bits twice."""
    g = torch.Generator().manual_seed(21)
    for c_i, R, use_gn, (H, W) in ((16, 2, True, (64, 253)),
                                   (16, 1, False, (40, 70)),
                                   (7, 1, True, (128, 506))):
        sw = _random_stack(c_i, 16, R, 4 if use_gn else 1, use_gn,
                           seed=5, device=cuda, zero_pad=zero_pad, act=act)
        assert sw.act == act
        x = torch.randn(c_i, H, W, generator=g).to(cuda)
        n0 = layer_stack.launches
        y, _ = layer_stack(x, sw)
        assert layer_stack.launches == n0 + 1
        y2, _ = layer_stack(x, sw)
        ref, _ = layer_stack_plain(x, sw)
        ref64, _ = layer_stack_plain(x.double(), _double(sw))
        torch.cuda.synchronize()
        _hold_act(act, y, ref, ref64)
        assert torch.equal(y, y2)
    sws = [_random_stack(16, 16, 2, 4, seed=50 + l, device=cuda,
                         zero_pad=zero_pad, act=act) for l in range(5)]
    xs = [torch.randn(16, 128 >> l, 506 >> l, generator=g).to(cuda)
          for l in range(5)]
    for y, ref, ref64 in zip(layer_stacks(xs, sws),
                             layer_stacks_plain(xs, sws),
                             layer_stacks_plain([x.double() for x in xs],
                                                [_double(s) for s in sws])):
        _hold_act(act, y, ref, ref64)


@pytest.mark.cuda
@pytest.mark.parametrize("zero_pad", [False, True])
@pytest.mark.parametrize("act", ACTS)
def test_cuda_trunk_activations_match_plain(cuda, act, zero_pad):
    """The trunk's GroupNorm pass with each activation, at 128×506."""
    H, W, c_h = 128, 506, 16
    merge = _random_stack(5 * c_h + 7, c_h, 1, 4, seed=9, device=cuda,
                          zero_pad=zero_pad, act=act)
    hw = [(H // 2 ** l, W // 2 ** l) for l in range(1, 5)]
    tw = trunk_weights(merge, hw, H, W)
    assert tw.merge.act == act
    g = torch.Generator().manual_seed(10)
    b0 = torch.randn(c_h, H, W, generator=g).to(cuda)
    coarse = [torch.randn(c_h, h, w, generator=g).to(cuda) for h, w in hw]
    x = torch.randn(7, H, W, generator=g).to(cuda)
    n0 = trunk.launches
    y = trunk(b0, coarse, x, tw)
    assert trunk.launches == n0 + 1
    y2 = trunk(b0, coarse, x, tw)
    yp = trunk_plain(b0, coarse, x, tw)
    tw64 = trunk_weights(_double(merge), hw, H, W)
    y64 = trunk_plain(b0.double(), [c.double() for c in coarse], x.double(),
                      tw64)
    torch.cuda.synchronize()
    _hold_act(act, y, yp, y64)
    assert torch.equal(y, y2)


@pytest.mark.cuda
def test_cuda_layer_stacks_refuse_mixed_activations(cuda):
    """One launch runs one activation: stacks that differ in it raise."""
    a = _random_stack(16, 16, 1, 4, device=cuda, act="selu")
    b = _random_stack(16, 16, 1, 4, device=cuda, act="relu")
    x = torch.randn(16, 32, 40, device=cuda)
    with pytest.raises(ValueError, match="differ"):
        layer_stacks([x, x], [a, b])


@pytest.mark.cuda
@pytest.mark.parametrize("zero_pad", [False, True])
@pytest.mark.parametrize("c_o", [1, 2, 3])
def test_cuda_merge3_of_every_head_matches_plain(cuda, c_o, zero_pad):
    """Merge 3 as the executor runs it for each head (no GroupNorm, no
    activation; c_o 1: the curl head, 2: curl + p or mae/mass, 3:
    mae/mass + p, the output tile's last 8 - c_o columns zero weights) at
    128×506 and at the ragged 30×45, within 1e-4 of max |plain| (also on
    the boundary ring alone); one launch counted; the same bits twice."""
    g = torch.Generator().manual_seed(30 + c_o)
    for H, W in ((128, 506), (30, 45)):
        sw = _random_stack(16, c_o, 1, 1, False, False, seed=12 + c_o,
                           device=cuda, zero_pad=zero_pad)
        assert sw.c_o == c_o and not (sw.use_gn or sw.use_act)
        x = torch.randn(16, H, W, generator=g).to(cuda)
        n0 = layer_stack.launches
        y, _ = layer_stack(x, sw)
        assert layer_stack.launches == n0 + 1
        y2, _ = layer_stack(x, sw)
        ref, _ = layer_stack_plain(x, sw)
        torch.cuda.synchronize()
        assert y.shape == (c_o, H, W)
        assert _rel(y, ref) <= 1e-4
        assert torch.equal(y, y2)
        edge = torch.ones(H, W, dtype=torch.bool, device=cuda)
        edge[2:-2, 2:-2] = False
        assert _rel(y[:, edge], ref[:, edge]) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("loss_type,p_pred,r_p", [
    ("mae", True, "learned"), ("curl", True, "learned"),
    ("mass", False, "zeros")])
def test_cuda_head_rollout_through_the_kernels(cuda, loss_type, p_pred, r_p):
    """The flagship's widths with the ``mae``/``mass`` heads or ``p_pred``
    at 128×506, B = 1: the fused executor (merge 3 at c_o 2 or 3), no
    fused epilogue, 4 ``layer_stack`` + 1 ``trunk`` + 0 + 1
    ``advect_diffuse_step_fused`` launches per step; one forward's u, v
    (and p) within 1e-4 of the module's, and 10 steps within
    chip_smoke.py's TOL_ROLLOUT of the module path, p carried in the
    state."""
    from pbml_mantle_convection_tpu_torch.cli.benchmark import (
        initial_temperature)
    from pbml_mantle_convection_tpu_torch.constants import SimParams
    from pbml_mantle_convection_tpu_torch.models.fast_path import (
        FastNewFluidNet)
    from pbml_mantle_convection_tpu_torch.models.fluidnet import NewFluidNet
    from pbml_mantle_convection_tpu_torch.sim.engine import SimEngine
    from pbml_mantle_convection_tpu_torch.sim.stepper import TimeStepper
    H, W, K = 128, 506, 10
    c_o = (1 if loss_type == "curl" else 2) + p_pred
    grid = Grid(H=H, W=W, aspect=(W - 2) / (H - 2))
    model = NewFluidNet(levels=5, c_i=7, c_h=16, c_o=c_o, act_fn="gelu",
                        r_p=r_p, loss_type=loss_type, repeats=6, f=5,
                        p_pred=p_pred, seed=0, device=cuda)
    fast = FastNewFluidNet(model, H, W)
    assert fast.merge3.c_o == c_o
    x = torch.randn(1, H, W, 7, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        got, want = fast(x.to(cuda)), model(x.to(cuda))
    assert (got[2] is None) == (not p_pred)
    for a, b in zip(got, want):
        if b is not None:
            assert _rel(a, b) <= 1e-4
    finals = []
    wrappers = (layer_stack, trunk, curl_advect_epilogue,
                advect_diffuse_step_fused)
    for apply_fn in (fast, model):
        eng = SimEngine(TimeStepper(grid, SimParams(3.0, 1e8, 10.0),
                                    apply_fn, cn_max=0.99, device=cuda))
        assert eng._epi is None
        before = [fn.launches for fn in wrappers]
        state = eng.multi_step(eng.init_state(initial_temperature(grid)),
                               K)[0]
        torch.cuda.synchronize()
        got = [fn.launches - n for fn, n in zip(wrappers, before)]
        fused = apply_fn is fast
        assert got == [4 * K * fused, K * fused, 0, K]
        assert bool(torch.isfinite(state.T).all())
        assert bool(state.p.abs().max() > 0) == p_pred
        finals.append(state)
    names = [("T", 1e-3), ("u", 2e-2), ("v", 2e-2)] + [("p", 2e-2)] * p_pred
    for name, tol in names:
        k, p = getattr(finals[0], name), getattr(finals[1], name)
        rel = float((k - p).abs().max() / p.abs().max())
        assert rel <= tol, (name, rel)
