"""The zero-padding instance of ``layer_stack`` and ``trunk`` (the JAX
kernels' ``learned=False``) and the fused executor over a zero-padded
NewFluidNet, on the CPU, where every stage runs its plain version:

1. ``layer_stack_plain`` with zero padding against the JAX ``LayerStack``
   (``learned=False``) in Pallas interpret mode, as
   tests/test_branch_kernel.py:42,108 runs it (float32, rtol/atol 2e-5),
   on an aligned and a ragged width;
2. ``trunk_plain`` with zero padding against the JAX ``TrunkStack``
   (``learned=False``) in interpret mode, fed the same branch outputs
   (float32, 2e-5);
3. ``FastNewFluidNet`` of a ``r_p="zeros"`` NewFluidNet against the Flax
   module in float64 (≤1e-9) on 32×64 and the ragged 36×54 (JAX
   tests/test_fast_path.py:128,132);
4. a ``-pad zeros`` coupled rollout through the executor against the JAX
   engine over the Flax module, float64, rtol 1e-10;
5. the host side of the kernels' work list: the zero instance packs one
   weight class, and a zero-padded config the executor cannot take
   raises as a learned one does.

The CUDA kernels themselves (item decode, zero staging at the field's
edge on both sides, padding that stays 0 after the GroupNorm apply, the
trunk's upsampled channels reading 0 outside the field) are held against
these plain versions on the card by tests/test_torch_port_cuda.py.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from pbml_mantle_convection_tpu.constants import SimParams as JParams  # noqa: E402
from pbml_mantle_convection_tpu.models import NewFluidNet as JNewFluidNet  # noqa: E402
from pbml_mantle_convection_tpu.models import layers as jl  # noqa: E402
from pbml_mantle_convection_tpu.models.fast_path import (  # noqa: E402
    FastNewFluidNet as JFast)
from pbml_mantle_convection_tpu.ops.branch_kernel import (  # noqa: E402
    FC, FR, LayerStack)
from pbml_mantle_convection_tpu.ops.s2d import (  # noqa: E402
    depth_to_space_rect, space_to_depth_rect)
from pbml_mantle_convection_tpu.sim.engine import SimEngine as JEngine  # noqa: E402
from pbml_mantle_convection_tpu.sim.grid import Grid as JGrid  # noqa: E402
from pbml_mantle_convection_tpu.sim.stepper import TimeStepper as JStepper  # noqa: E402

from pbml_mantle_convection_tpu_torch.cli.benchmark import (  # noqa: E402
    initial_temperature)
from pbml_mantle_convection_tpu_torch.constants import SimParams  # noqa: E402
from pbml_mantle_convection_tpu_torch.models.fast_path import (  # noqa: E402
    FastNewFluidNet, conv_weights, unsupported_reason)
from pbml_mantle_convection_tpu_torch.models.fluidnet import NewFluidNet  # noqa: E402
from pbml_mantle_convection_tpu_torch.ops.branch_kernel import (  # noqa: E402
    layer_stack, pack_stack, weight_fragments)
from pbml_mantle_convection_tpu_torch.ops.merge_kernel import (  # noqa: E402
    trunk, trunk_plain, trunk_weights)
from pbml_mantle_convection_tpu_torch.sim.engine import SimEngine  # noqa: E402
from pbml_mantle_convection_tpu_torch.sim.grid import Grid  # noqa: E402
from pbml_mantle_convection_tpu_torch.sim.stepper import TimeStepper  # noqa: E402
from pbml_mantle_convection_tpu_torch.utils.flax_convert import (  # noqa: E402
    from_jax_params)

F32, F64 = torch.float32, torch.float64


def _oihw(hwio, dtype=F32):
    return torch.tensor(np.asarray(hwio).transpose(3, 2, 0, 1), dtype=dtype)


def _zero_layer(tree, dtype=F32):
    """(the one OIHW kernel, bias, gn scale, gn bias) of a Flax
    FluidLayer with zero padding."""
    g = tree["gn"]["GroupNorm_0"]
    return ([_oihw(tree["conv"]["kernel"], dtype)],
            torch.tensor(np.asarray(tree["conv"]["bias"]), dtype=dtype),
            torch.tensor(np.asarray(g["scale"]), dtype=dtype),
            torch.tensor(np.asarray(g["bias"]), dtype=dtype))


def _jax_layer_dict(tree):
    conv, g = tree["conv"], tree["gn"]["GroupNorm_0"]
    return {"w": np.asarray(conv["kernel"], np.float32),
            "bias": np.asarray(conv["bias"], np.float32),
            "gn_scale": np.asarray(g["scale"], np.float32),
            "gn_bias": np.asarray(g["bias"], np.float32)}


@pytest.mark.parametrize("c_i,R,H,W", [(16, 3, 16, 24), (7, 1, 16, 32),
                                       (16, 2, 12, 18)])
def test_layer_stack_zero_plain_matches_jax_kernel(c_i, R, H, W):
    """As tests/test_branch_kernel.py:42 and :108 with r_p="zeros": R Flax
    FluidLayers (zero padding, GELU, non-trivial GN affine) through the
    JAX LayerStack(learned=False) in interpret mode, against the port's
    plain zero-padded stack (F.conv2d of the field padded by 2, then
    GroupNorm and GELU); W = 18 is the ragged last block column."""
    C = 16
    x = jax.random.normal(jax.random.PRNGKey(0), (1, H, W, c_i), jnp.float32)
    params, ref = [], x
    for i in range(R):
        lay = jl.FluidLayer(features=C, act_fn="gelu", r_p="zeros",
                            kernel_size=5, dtype=jnp.float32)
        p = lay.init(jax.random.PRNGKey(i + 1), ref)["params"]
        params.append(jax.tree.map(lambda a: a * 1.1 + 0.02, p))
        ref = lay.apply({"params": params[-1]}, ref)
    stack = LayerStack([_jax_layer_dict(p) for p in params], H, W, 5,
                       act=jl.get_activation("gelu"), learned=False,
                       interpret=True)
    wc = -(-W // FC)
    xp = jnp.pad(x, ((0, 0), (0, 0), (0, wc * FC - W), (0, 0)))
    out6 = stack(space_to_depth_rect(xp, FR, FC)[0])
    kern = np.asarray(depth_to_space_rect(out6[None], FR, FC, C)[0])[:, :W]

    sw = pack_stack([_zero_layer(p) for p in params], groups=C // 4)
    assert sw.zero_pad and sw.frag.numel() == weight_fragments(
        sw.kernels[0]).numel() + (R - 1) * weight_fragments(
            sw.kernels[-1]).numel()
    xt = torch.tensor(np.asarray(x[0])).permute(2, 0, 1).contiguous()
    n0 = layer_stack.launches
    y, _ = layer_stack(xt, sw)           # CPU tensor → plain version
    assert layer_stack.launches == n0
    np.testing.assert_allclose(y.permute(1, 2, 0).numpy(), kern,
                               rtol=2e-5, atol=2e-5)
    # and the Flax layers themselves
    np.testing.assert_allclose(y.permute(1, 2, 0).numpy(),
                               np.asarray(ref[0]), rtol=2e-5, atol=2e-5)


def _dense(raw, c, h, w):
    """A raw haloed block-layout piece of the JAX kernels → (c, h, w)."""
    hr, wc = raw.shape[0] - 2, raw.shape[1] - 2
    d = depth_to_space_rect(raw[None, 1:hr + 1, 1:wc + 1, :FR * FC * c],
                            FR, FC, c)[0, :h, :w]
    return torch.tensor(np.asarray(d)).permute(2, 0, 1).contiguous()


def test_trunk_zero_plain_matches_jax_kernel():
    """The JAX TrunkStack(learned=False) in interpret mode (the merge-1 of
    a zero-padded NewFluidNet's megakernel path: bicubic upsampling of
    the coarse branches, the 3×3 merge conv, GN0, GELU) against the
    port's ``trunk_plain`` on the same branch outputs (its 3×3 kernel as
    a 5×5 with a zero ring), float32, 2e-5; ragged widths 40 → 20 → 10."""
    H, W, levels, c_h = 24, 40, 3, 8
    jm = JNewFluidNet(levels=levels, c_i=7, c_h=c_h, c_o=1, act_fn="gelu",
                      r_p="zeros", loss_type="curl", repeats=1, f=5,
                      p_pred=False)
    x = jax.random.normal(jax.random.PRNGKey(3), (1, H, W, 7), jnp.float32)
    p = jm.init(jax.random.PRNGKey(4), x)
    p = jax.tree.map(lambda a: a * 1.1 + 0.02, p)
    fast = JFast(jm, p, H, W, megakernel=True)
    assert fast.use_megakernel
    b0_raw, raw_outs, x6r = fast._megakernel_branches(x, H, W)

    def lanepad(pc):
        return jnp.pad(pc, ((0, 0), (0, 0), (0, 128 - pc.shape[-1])))

    xh = lanepad(jnp.pad(x6r[0], ((1, 1), (1, 1), (0, 0))))
    y1 = fast.mkm1(lanepad(b0_raw), *[lanepad(o) for o in raw_outs], xh)
    ref = _dense(y1, c_h, H, W)

    sizes = [(H >> l, W >> l) for l in range(1, levels)]
    b0 = _dense(b0_raw, c_h, H, W)
    coarse = [_dense(o, c_h, h, w) for o, (h, w) in zip(raw_outs, sizes)]
    xt = torch.tensor(np.asarray(x[0])).permute(2, 0, 1).contiguous()
    net = NewFluidNet(levels=levels, c_i=7, c_h=c_h, c_o=1, act_fn="gelu",
                      r_p="zeros", loss_type="curl", repeats=1, f=5,
                      p_pred=False, device="cpu")
    net.load_state_dict(from_jax_params(jax.tree.map(np.asarray, p)))
    merge = pack_stack([(*conv_weights(net.conv_1), net.gn_0.weight,
                         net.gn_0.bias)], groups=c_h // 4)
    tw = trunk_weights(merge, sizes, H, W)
    assert tw.zero_pad
    n0 = trunk.launches
    got = trunk(b0, coarse, xt, tw)          # CPU tensor → plain version
    assert trunk.launches == n0
    torch.testing.assert_close(got, trunk_plain(b0, coarse, xt, tw),
                               rtol=0, atol=0)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=2e-5,
                               atol=2e-5)


def _zero_models(levels=3, c_h=8, repeats=2):
    cfg = dict(levels=levels, c_i=7, c_h=c_h, c_o=1, act_fn="gelu",
               r_p="zeros", loss_type="curl", repeats=repeats, f=5,
               p_pred=False)
    return JNewFluidNet(**cfg), NewFluidNet(**cfg, device="cpu", dtype=F64)


@pytest.mark.parametrize("H,W", [(32, 64), (36, 54)])
def test_fast_newfluidnet_zero_padding_matches_flax(H, W):
    """JAX tests/test_fast_path.py::test_zeros_padding and
    ::test_zeros_nondivisible: the executor of a zero-padded NewFluidNet
    (its stages' plain versions) equals the Flax module, float64, ≤1e-9
    of max |u|, |v|."""
    jm, tm = _zero_models()
    x = np.random.default_rng(7).normal(size=(1, H, W, 7))
    p = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    tm.load_state_dict(from_jax_params(jax.tree.map(np.asarray, p)))
    assert unsupported_reason(tm) is None
    fast = FastNewFluidNet(tm, H, W)
    assert fast.zero_pad and fast.trunk.zero_pad
    assert all(sw.zero_pad for sw in [fast.stem, *fast.branches,
                                      fast.merge2, fast.merge3])
    ju, jv, _ = jm.apply(p, jnp.asarray(x))
    with torch.no_grad():
        u, v, _ = fast(torch.as_tensor(x))
    for a, b in ((u, ju), (v, jv)):
        scale = float(np.abs(np.asarray(b)).max())
        assert float(np.abs(a.numpy() - np.asarray(b)).max()) <= 1e-9 * scale


def test_zero_padding_rollout_matches_the_jax_engine():
    """Six coupled ML_STOKES steps of a zero-padded NewFluidNet through
    the port's fused executor and fused epilogue (plain versions on the
    CPU) against the JAX engine over the Flax module, float64, rtol
    1e-10 on dt, the mean-T trace and the fields."""
    H, W, steps = 20, 28, 6
    jm, tm = _zero_models(levels=2, repeats=1)
    w = jax.jit(jm.init)(jax.random.PRNGKey(0),
                         jnp.zeros((1, H, W, 7), jnp.float64))
    tm.load_state_dict(from_jax_params(jax.tree.map(np.asarray, w)))
    grid = Grid(H=H, W=W, aspect=(W - 2) / (H - 2))
    T0 = initial_temperature(grid)
    jgrid = JGrid(H=H, W=W, aspect=(W - 2) / (H - 2), dtype="float64")
    pp = JParams(3.0, 1e8, 10.0)
    jeng = JEngine(grid=jgrid, params=pp, dtype=jnp.float64,
                   stepper=JStepper(grid=jgrid, params=pp,
                                    apply_fn=lambda x: jm.apply(w, x),
                                    net="newfluidnet", cn_max=0.99,
                                    dtype=jnp.float64))
    jstate, jtrace = jax.jit(jeng.multi_step, static_argnums=1)(
        jeng.init_state(jnp.asarray(T0)), steps)
    eng = SimEngine(TimeStepper(grid, SimParams(3.0, 1e8, 10.0),
                                FastNewFluidNet(tm, H, W), cn_max=0.99,
                                dtype=F64, device="cpu"))
    assert eng._epi is not None              # the fused step
    state, trace = eng.multi_step(eng.init_state(T0), steps)
    np.testing.assert_allclose(trace.dt.numpy(), np.asarray(jtrace.dt),
                               rtol=1e-10)
    np.testing.assert_allclose(trace.mean_T.numpy(),
                               np.asarray(jtrace.mean_T), rtol=1e-10)
    for f in ("T", "u", "v"):
        np.testing.assert_allclose(getattr(state, f).numpy(),
                                   np.asarray(getattr(jstate, f)),
                                   rtol=1e-10, atol=1e-10)


def test_zero_instance_weights_and_refusals():
    """The zero instance packs one weight class per layer (a 3×3 merge
    kernel as a 5×5 with a zero ring: the same function), stacks of the
    two instances do not mix, and a zero-padded config the executor
    cannot take raises as a learned one does."""
    tm = _zero_models(levels=2, repeats=1)[1]
    (k,), b = conv_weights(tm.conv_2)
    assert k.shape == (8, 8, 5, 5) and torch.equal(k[..., 1:4, 1:4],
                                                   tm.conv_2.weight)
    assert not k[..., 0, :].any() and not k[..., :, 4].any()
    assert b is tm.conv_2.bias
    x = torch.randn(1, 8, 9, 11, dtype=F64)
    torch.testing.assert_close(
        torch.nn.functional.conv2d(torch.nn.functional.pad(x, (2,) * 4), k,
                                   b), tm.conv_2(x), rtol=1e-13, atol=1e-13)
    with pytest.raises(ValueError, match="9 learned-boundary kernels"):
        pack_stack([([k, k], b, None, None)], groups=1, use_gn=False)
    base = dict(levels=2, c_i=7, c_h=8, c_o=1, act_fn="gelu",
                loss_type="curl", repeats=1, f=5, p_pred=False)
    for bad in (dict(r_p="replicate"), dict(r_p="zeros", f=3),
                dict(r_p="zeros", c_h=12)):
        m = NewFluidNet(**{**base, **bad}, device="cpu")
        assert unsupported_reason(m) is not None
        with pytest.raises(ValueError, match="unsupported config"):
            FastNewFluidNet(m, 20, 28)
    # a zero-padded selu network runs the zero instances' selu kernels
    m = NewFluidNet(**{**base, "r_p": "zeros", "act_fn": "selu"},
                    device="cpu")
    assert unsupported_reason(m) is None
    fast = FastNewFluidNet(m, 20, 28)
    assert fast.zero_pad and fast.stem.act == fast.trunk.merge.act == "selu"
