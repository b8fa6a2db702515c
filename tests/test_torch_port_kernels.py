"""The port's three kernels: each plain PyTorch version against the JAX
package's kernel run as the JAX tests run it (Pallas interpret mode, or
the Flax composition). The CUDA kernels themselves are held against
these plain versions on the card by tests/test_torch_port_cuda.py."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from pbml_mantle_convection_tpu.models import layers as jl  # noqa: E402
from pbml_mantle_convection_tpu.ops.branch_kernel import LayerStack  # noqa: E402
from pbml_mantle_convection_tpu.ops.epilogue_kernel import (  # noqa: E402
    CurlAdvectEpilogue)
from pbml_mantle_convection_tpu.ops.resize import (  # noqa: E402
    resize_bicubic_nhwc as j_resize)
from pbml_mantle_convection_tpu.ops.s2d import (  # noqa: E402
    depth_to_space_rect, space_to_depth_rect)
from pbml_mantle_convection_tpu.physics.advection import (  # noqa: E402
    grid_metrics as j_grid_metrics)
from pbml_mantle_convection_tpu.sim.grid import Grid as JGrid  # noqa: E402

from pbml_mantle_convection_tpu_torch.models.layers import BLC_CLASSES  # noqa: E402
from pbml_mantle_convection_tpu_torch.ops.branch_kernel import (  # noqa: E402
    _tf32, layer_stack, layer_stack_plain, layer_stacks, layer_stacks_plain,
    pack_stack, weight_fragments)
from pbml_mantle_convection_tpu_torch.ops.epilogue_kernel import (  # noqa: E402
    curl_advect_epilogue, curl_advect_epilogue_plain, epilogue_consts)
from pbml_mantle_convection_tpu_torch.ops.merge_kernel import (  # noqa: E402
    trunk, trunk_plain, trunk_weights)
from pbml_mantle_convection_tpu_torch.ops.resize import (  # noqa: E402
    _resize_matrix_np, avg_pool_nchw)
from pbml_mantle_convection_tpu_torch.physics.advection import (  # noqa: E402
    grid_metrics)

F32 = torch.float32


def _oihw(hwio, dtype):
    return torch.tensor(np.asarray(hwio).transpose(3, 2, 0, 1),
                        dtype=dtype)


def _flax_layer_weights(tree, dtype, gn=None):
    """(9 OIHW kernels, bias, gn scale, gn bias) of a Flax FluidLayer's
    (``gn`` None) or a bare BLC tree (GN from ``gn``)."""
    conv = tree["conv"] if gn is None else tree
    g = tree["gn"]["GroupNorm_0"] if gn is None else gn
    w9 = [_oihw(conv[n]["kernel"], dtype) for n in BLC_CLASSES]
    bias = torch.tensor(np.asarray(conv["learnable_bias"]).reshape(-1),
                        dtype=dtype)
    return (w9, bias, torch.tensor(np.asarray(g["scale"]), dtype=dtype),
            torch.tensor(np.asarray(g["bias"]), dtype=dtype))


def _jax_layer_dict(tree):
    conv = tree["conv"]
    d = {"gn_scale": np.asarray(tree["gn"]["GroupNorm_0"]["scale"],
                                np.float32),
         "gn_bias": np.asarray(tree["gn"]["GroupNorm_0"]["bias"], np.float32),
         "w": np.asarray(conv["conv"]["kernel"], np.float32),
         "bias": np.asarray(conv["learnable_bias"], np.float32)[0, 0, 0]}
    for nm in BLC_CLASSES[:4] + BLC_CLASSES[5:]:
        d[nm] = np.asarray(conv[nm]["kernel"], np.float32)
    return d


def _fluid_stack(H, W, c_i, C, R, seed):
    """R Flax FluidLayers (learned padding, GELU) with non-trivial GN
    affine and bias, their float32 params and a seeded input."""
    x = jax.random.normal(jax.random.PRNGKey(seed), (1, H, W, c_i),
                          jnp.float32)
    params, ref = [], x
    for i in range(R):
        lay = jl.FluidLayer(features=C, act_fn="gelu", r_p="learned",
                            kernel_size=5, dtype=jnp.float32)
        p = lay.init(jax.random.PRNGKey(seed + i + 1), ref)["params"]
        p = jax.tree.map(lambda a: a * 1.1 + 0.02, p)
        params.append(p)
    return x, params


@pytest.mark.parametrize("c_i,R,W", [(16, 3, 24), (7, 1, 32)])
def test_layer_stack_plain_matches_jax_kernel(c_i, R, W):
    """As tests/test_branch_kernel.py: the JAX LayerStack in interpret mode
    vs the port's plain layer stack, float32, tol 2e-5."""
    H, C = 16, 16
    x, params = _fluid_stack(H, W, c_i, C, R, seed=0)
    stack = LayerStack([_jax_layer_dict(p) for p in params], H, W, 5,
                       act=jl.get_activation("gelu"), learned=True,
                       interpret=True)
    out6 = stack(space_to_depth_rect(x, 2, 4)[0])
    ref = np.asarray(depth_to_space_rect(out6[None], 2, 4, C)[0])

    sw = pack_stack([_flax_layer_weights(p, F32) for p in params],
                    groups=C // 4)
    xt = torch.tensor(np.asarray(x[0])).permute(2, 0, 1).contiguous()
    y, pooled = layer_stack(xt, sw)          # CPU tensor → plain version
    assert pooled is None
    np.testing.assert_allclose(y.permute(1, 2, 0).numpy(), ref,
                               rtol=2e-5, atol=2e-5)


def test_layer_stack_pool_matches_jax_kernel():
    """The fused VALID 2×2 pool of the stack input (ragged width 18 → 9),
    as tests/test_branch_kernel.py::test_stack_ragged_pool."""
    H, W, C = 12, 18, 16
    x, params = _fluid_stack(H, W, C, C, 1, seed=5)
    stack = LayerStack([_jax_layer_dict(params[0])], H, W, 5,
                       act=jl.get_activation("gelu"), learned=True,
                       interpret=True, pool=True)
    wc = -(-W // 4)
    xp = jnp.pad(x, ((0, 0), (0, 0), (0, wc * 4 - W), (0, 0)))
    _, pooled_h = stack.call_raw(stack.prep(space_to_depth_rect(xp, 2, 4)[0]))
    H2, W2 = H // 2, W // 2
    pooled6 = pooled_h[1:H2 // 2 + 1, 1:-(-W2 // 4) + 1, :8 * C]
    ref = np.asarray(depth_to_space_rect(pooled6[None], 2, 4, C)[0])[:, :W2]

    sw = pack_stack([_flax_layer_weights(params[0], F32)], groups=C // 4)
    xt = torch.tensor(np.asarray(x[0])).permute(2, 0, 1).contiguous()
    _, pooled = layer_stack(xt, sw, pool=True)
    np.testing.assert_allclose(pooled.permute(1, 2, 0).numpy(), ref,
                               rtol=2e-6, atol=2e-6)


def _jax_stack(x, params, H, W, C):
    """The JAX LayerStack of ``params`` on NHWC ``x`` in interpret mode."""
    stack = LayerStack([_jax_layer_dict(p) for p in params], H, W, 5,
                       act=jl.get_activation("gelu"), learned=True,
                       interpret=True)
    out6 = stack(space_to_depth_rect(x, 2, 4)[0])
    return np.asarray(depth_to_space_rect(out6[None], 2, 4, C)[0])


def test_layer_stacks_plain_matches_jax_kernel_per_level():
    """The grouped call (one stack per pyramid level, fields of different
    sizes) on CPU tensors: each level against the JAX LayerStack in
    interpret mode, float32, tol 2e-5, as
    test_layer_stack_plain_matches_jax_kernel."""
    C, R = 16, 2
    sizes = [(16, 24), (16, 32), (12, 16)]
    xs, sws, refs = [], [], []
    for l, (H, W) in enumerate(sizes):
        x, params = _fluid_stack(H, W, C, C, R, seed=10 * l)
        refs.append(_jax_stack(x, params, H, W, C))
        sws.append(pack_stack([_flax_layer_weights(p, F32) for p in params],
                              groups=C // 4))
        xs.append(torch.tensor(np.asarray(x[0])).permute(2, 0, 1)
                  .contiguous())
    n0 = layer_stack.launches
    ys = layer_stacks(xs, sws)               # CPU tensors → plain version
    assert layer_stack.launches == n0
    for y, ref, y1 in zip(ys, refs, layer_stacks_plain(xs, sws)):
        assert torch.equal(y, y1)
        np.testing.assert_allclose(y.permute(1, 2, 0).numpy(), ref,
                                   rtol=2e-5, atol=2e-5)


def test_layer_stack_pyramid_plain_is_successive_pools():
    """``pyramid`` returns the successive VALID 2×2 pools of the output
    (odd sizes floor), as the per-level ``pool`` of the unfused chain
    computed them from each level's input."""
    x, params = _fluid_stack(40, 75, 7, 16, 1, seed=4)
    sw = pack_stack([_flax_layer_weights(params[0], F32)], groups=4)
    xt = torch.tensor(np.asarray(x[0])).permute(2, 0, 1).contiguous()
    y, pools = layer_stack(xt, sw, pyramid=3)
    assert [tuple(p.shape) for p in pools] == [(16, 20, 37), (16, 10, 18),
                                              (16, 5, 9)]
    prev = y
    for p in pools:
        assert torch.equal(p, avg_pool_nchw(prev, 2))
        prev = p
    with pytest.raises(ValueError):
        layer_stack(xt, sw, pool=True, pyramid=1)


def test_weight_fragments_layout():
    """The kernel's B fragments: lane 4g + t of (class, chunk q, tap, tile
    j) holds the TF32 hi/lo parts of w[8j + g, 8q + t] and
    w[8j + g, 8q + t + 4]; hi + lo recovers the float32 weight to ~2^-22
    relative; channels past c_in and c_o are zero."""
    g = torch.Generator().manual_seed(0)
    c_o, c_in = 16, 11
    w9 = [torch.randn(c_o, c_in, 5, 5, generator=g) for _ in range(9)]
    frag = weight_fragments(w9).reshape(9, 2, 25, 2, 32, 4)
    for cls, tap, q, j, lane in ((0, 0, 0, 0, 0), (4, 12, 1, 1, 31),
                                 (8, 24, 1, 0, 6), (3, 7, 0, 1, 13)):
        gg, t = lane // 4, lane % 4
        ky, kx = divmod(tap, 5)
        for k, (hi, lo) in enumerate(((0, 2), (1, 3))):
            ci, co = 8 * q + t + 4 * k, 8 * j + gg
            want = w9[cls][co, ci, ky, kx] if ci < c_in else torch.tensor(0.)
            h, l_ = frag[cls, q, tap, j, lane, hi], frag[cls, q, tap, j,
                                                          lane, lo]
            assert torch.equal(h, _tf32(h)) and torch.equal(l_, _tf32(l_))
            assert abs(float(h + l_ - want)) <= 2.0 ** -21 * abs(float(want))
    # round to nearest, ties away from zero, at 10 mantissa bits
    v = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 2.0 ** -12])
    assert _tf32(v).tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1.0]


@pytest.mark.parametrize("H,W,still", [(16, 32, False), (18, 34, False),
                                        (16, 32, True), (128, 506, False)])
def test_epilogue_plain_matches_jax_kernel(H, W, still):
    """As tests/test_epilogue_kernel.py: the JAX CurlAdvectEpilogue in
    interpret mode vs the port's plain epilogue, float32, also at the
    production grid. ``still``: a constant ψ, so zero velocity, where dt
    must be exactly dt_diffuse (max |u, v| = 0 makes the advective limit
    infinite) in both, and in the port's constants."""
    jg = JGrid(H=H, W=W, aspect=(W - 2) / (H - 2), dtype="float32")
    jm = j_grid_metrics(jnp.asarray(jg.xc_np, jnp.float32),
                        jnp.asarray(jg.yc_np, jnp.float32), aspect=jg.aspect)
    rng = np.random.default_rng(3)
    psi = rng.normal(size=(H, W)).astype(np.float32)
    if still:
        psi = np.full((H, W), 0.7, np.float32)
    T = rng.random((H, W)).astype(np.float32)
    s, src = 37.5, 2.3e-3
    epi = CurlAdvectEpilogue(jm, H, W, 4.0, 0.99, dtype=jnp.float32,
                             interpret=True)
    ju, jv, jt, jdt = epi(jnp.asarray(psi), jnp.asarray(T),
                          jnp.asarray(s, jnp.float32),
                          jnp.asarray(src, jnp.float32))

    tm = grid_metrics(torch.as_tensor(jg.xc_np, dtype=F32),
                      torch.as_tensor(jg.yc_np, dtype=F32), aspect=jg.aspect)
    consts = epilogue_consts(tm, 4.0, 0.99)
    tu, tv, tt, tdt = curl_advect_epilogue(
        torch.as_tensor(psi), torch.as_tensor(T), consts,
        float(np.float32(s)), torch.tensor(src, dtype=F32))
    for a, b in ((tu, ju), (tv, jv), (tt, jt)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5,
                                   atol=1e-5)
    np.testing.assert_allclose(float(tdt), float(jdt), rtol=1e-5)
    assert np.all(tt.numpy()[0] == 1.0) and np.all(tt.numpy()[-1] == 0.0)
    if still:
        assert not tu.any() and not tv.any()
        assert float(tdt) == float(jdt) == consts.dt_diffuse


def test_trunk_plain_matches_flax_composition():
    """resize_bicubic_nhwc + concat + BoundaryLearnedConvolution2D +
    GroupNormTorch + GELU (the Flax merge-1 of NewFluidNet), float64."""
    H, W, c_h, levels, c_x = 32, 60, 8, 4, 7
    rng = np.random.default_rng(9)
    b0 = rng.normal(size=(1, H, W, c_h))
    coarse = [rng.normal(size=(1, H // 2 ** l, W // 2 ** l, c_h))
              for l in range(1, levels)]
    x = rng.normal(size=(1, H, W, c_x))
    cat = jnp.concatenate(
        [jnp.asarray(b0)] + [j_resize(jnp.asarray(c), (H, W))
                             for c in coarse] + [jnp.asarray(x)], axis=-1)
    blc = jl.BoundaryLearnedConvolution2D(c_h, 5)
    gn = jl.GroupNormTorch(c_h // 4)
    pb = jax.tree.map(lambda a: a + 0.05, blc.init(jax.random.PRNGKey(1), cat))
    y = blc.apply(pb, cat)
    pg = jax.tree.map(lambda a: a * 0.7 + 0.1, gn.init(jax.random.PRNGKey(2),
                                                       y))
    ref = np.asarray(jl.get_activation("gelu")(gn.apply(pg, y)))[0]

    f64 = torch.float64
    merge = pack_stack(
        [_flax_layer_weights(pb["params"], f64,
                             gn=pg["params"]["GroupNorm_0"])],
        groups=c_h // 4)
    tw = trunk_weights(merge, [c.shape[1:3] for c in coarse], H, W)

    def t(a):
        return torch.as_tensor(a[0]).permute(2, 0, 1).contiguous()

    out = trunk(t(b0), [t(c) for c in coarse], t(x), tw)
    np.testing.assert_allclose(out.permute(1, 2, 0).numpy(), ref,
                               rtol=1e-12, atol=1e-12)
    # the kernel's tap tables hold the same resize matrix
    for l, (h, w) in enumerate(tw.coarse_hw):
        My = np.zeros((H, h))
        np.add.at(My, (np.repeat(np.arange(H), 4), tw.y_idx[l].reshape(-1)),
                  tw.y_w[l].reshape(-1).numpy())
        np.testing.assert_array_equal(My, _resize_matrix_np(h, H))


def test_cpu_wrappers_use_plain_versions_without_counting():
    """On CPU tensors the wrappers are their plain versions and launch
    nothing (the launch counters stay put)."""
    before = (layer_stack.launches, trunk.launches,
              curl_advect_epilogue.launches)
    x, params = _fluid_stack(12, 16, 16, 16, 2, seed=3)
    sw = pack_stack([_flax_layer_weights(p, F32) for p in params], groups=4)
    xt = torch.tensor(np.asarray(x[0])).permute(2, 0, 1).contiguous()
    a, pa = layer_stack(xt, sw, pool=True)
    b, pb = layer_stack_plain(xt, sw, pool=True)
    assert torch.equal(a, b) and torch.equal(pa, pb)
    assert (layer_stack.launches, trunk.launches,
            curl_advect_epilogue.launches) == before
    assert trunk_plain is not trunk
    assert curl_advect_epilogue_plain is not curl_advect_epilogue
