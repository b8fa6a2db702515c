"""Every activation of ``models/layers.py`` through ``layer_stack``,
``trunk`` and the fused executor, against the JAX package on the CPU.

The JAX kernels take the activation as a parameter (``LayerStack(...,
act=...)``, ``TrunkStack(..., act=...)``) and JAX's ``FastNewFluidNet``
passes the model's ``act_fn`` to both; the port's kernels have one
instance per activation (``csrc/blc_layer.cuh::activate``), whose plain
versions run here:

1. ``layer_stack`` (plain version) against the JAX ``LayerStack`` in
   Pallas interpret mode and the Flax FluidLayers, float64, for the seven
   activations with learned padding and for ``selu`` and ``sine`` with
   zero padding (R = 3 and 2 layers: the activation on the staged input,
   the last pass, and the epilogue of a layer without GroupNorm);
2. the port's ``FastNewFluidNet`` against JAX's
   ``FastNewFluidNet(megakernel=True)`` (interpret mode) and against the
   Flax module, float64, levels=2, c_h=8, repeats=2 at 16×32; its
   ``trunk`` against JAX's ``TrunkStack`` on the same branch outputs
   (:func:`check_executor`): here with zero padding for ``selu`` and
   ``sine``, in tests/test_torch_port_activations_executor.py with
   learned padding for each activation (JAX traces its interpret-mode
   kernels anew for each activation, ~15 s: two files, so two workers
   share them);
3. a fused ``SimEngine`` rollout of a ``selu`` network against the JAX
   engine over the Flax module, float64, rtol 1e-10;
4. every activation builds the executor with either padding, and an
   activation without a kernel instance raises.

Tolerances (max |diff| / max |ref|): 1e-9, PARITY.md's forward bound,
for the six activations other than ``sine``; 1e-7 for ``sine``, 25× the
4.0e-9 at which JAX's own executor reads against its module at the size
of (2): each ``sin(30·)`` multiplies an error by up to 30, so float64
rounding grows through the network's layers.
"""

import functools

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
    FastNewFluidNet, unsupported_reason)
from pbml_mantle_convection_tpu_torch.models.fluidnet import NewFluidNet  # noqa: E402
from pbml_mantle_convection_tpu_torch.models.layers import (  # noqa: E402
    _ACTIVATIONS, BLC_CLASSES, get_activation)
from pbml_mantle_convection_tpu_torch.ops.branch_kernel import (  # noqa: E402
    ACT_CODES, act_code, layer_stack, layer_stack_plain, pack_stack)
from pbml_mantle_convection_tpu_torch.ops.merge_kernel import (  # noqa: E402
    trunk, trunk_plain)
from pbml_mantle_convection_tpu_torch.sim.engine import SimEngine  # noqa: E402
from pbml_mantle_convection_tpu_torch.sim.grid import Grid  # noqa: E402
from pbml_mantle_convection_tpu_torch.sim.stepper import TimeStepper  # noqa: E402
from pbml_mantle_convection_tpu_torch.utils.flax_convert import (  # noqa: E402
    from_jax_params)

F64 = torch.float64
ACTS = ("gelu", "selu", "elu", "silu", "relu", "tanh", "sine")
# max |diff| / max |ref| (module doc)
TOL = {a: 1e-9 for a in ACTS}
TOL["sine"] = 1e-7


def _close(got, want, act, what):
    got, want = np.asarray(got), np.asarray(want)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max()) / scale
    assert err <= TOL[act], f"{what} [{act}]: {err:.3e} > {TOL[act]}"


def _planar(x):
    """(1, H, W, C) NHWC → (C, H, W) float64 tensor."""
    return torch.tensor(np.asarray(x[0])).permute(2, 0, 1).contiguous()


def _oihw(hwio):
    return torch.tensor(np.asarray(hwio).transpose(3, 2, 0, 1), dtype=F64)


def _port_layer(tree, learned):
    """(OIHW kernels, bias, gn scale, gn bias) of a Flax FluidLayer."""
    conv, g = tree["conv"], tree["gn"]["GroupNorm_0"]
    if learned:
        ws = [_oihw(conv[n]["kernel"]) for n in BLC_CLASSES]
        bias = np.asarray(conv["learnable_bias"]).reshape(-1)
    else:
        ws, bias = [_oihw(conv["kernel"])], np.asarray(conv["bias"])
    return (ws, torch.tensor(bias, dtype=F64),
            torch.tensor(np.asarray(g["scale"]), dtype=F64),
            torch.tensor(np.asarray(g["bias"]), dtype=F64))


def _jax_layer(tree, learned):
    """The JAX LayerStack's dict of a Flax FluidLayer, float64."""
    conv, g = tree["conv"], tree["gn"]["GroupNorm_0"]
    d = {"gn_scale": np.asarray(g["scale"]), "gn_bias": np.asarray(g["bias"])}
    if learned:
        d["w"] = np.asarray(conv["conv"]["kernel"])
        d["bias"] = np.asarray(conv["learnable_bias"])[0, 0, 0]
        for nm in BLC_CLASSES[:4] + BLC_CLASSES[5:]:
            d[nm] = np.asarray(conv[nm]["kernel"])
    else:
        d["w"] = np.asarray(conv["kernel"])
        d["bias"] = np.asarray(conv["bias"])
    return d


@pytest.mark.parametrize("act,r_p", [(a, "learned") for a in ACTS]
                         + [("selu", "zeros"), ("sine", "zeros")])
def test_layer_stack_matches_jax_kernel(act, r_p):
    """R Flax FluidLayers (non-trivial GN affine and bias) through the JAX
    LayerStack in interpret mode with ``act=get_activation(act)``, and
    the port's plain layer stack of the same weights; both against the
    Flax layers. Learned: R = 3 at 16×24; zeros: R = 2 at the ragged
    12×18. Then one layer without GroupNorm (merge 2's form: the
    activation in the conv's epilogue)."""
    learned = r_p == "learned"
    H, W, R, C = (16, 24, 3, 16) if learned else (12, 18, 2, 16)
    x = jnp.asarray(np.random.default_rng(0).normal(size=(1, H, W, C)))
    params, ref = [], x
    for i in range(R):
        lay = jl.FluidLayer(features=C, act_fn=act, r_p=r_p, kernel_size=5,
                            dtype=jnp.float64)
        p = lay.init(jax.random.PRNGKey(i + 1), ref)["params"]
        params.append(jax.tree.map(lambda a: a * 1.1 + 0.02, p))
        ref = lay.apply({"params": params[-1]}, ref)
    stack = LayerStack([_jax_layer(p, learned) for p in params], H, W, 5,
                       act=jl.get_activation(act), learned=learned,
                       dtype=jnp.float64, interpret=True)
    wc = -(-W // FC)
    xp = jnp.pad(x, ((0, 0), (0, 0), (0, wc * FC - W), (0, 0)))
    out6 = stack(space_to_depth_rect(xp, FR, FC)[0])
    kern = np.asarray(depth_to_space_rect(out6[None], FR, FC, C)[0])[:, :W]

    sw = pack_stack([_port_layer(p, learned) for p in params],
                    groups=C // 4, act=act)
    assert sw.act == act and sw.zero_pad == (not learned)
    n0 = layer_stack.launches
    y, _ = layer_stack(_planar(x), sw)         # CPU tensor → plain version
    assert layer_stack.launches == n0
    got = y.permute(1, 2, 0).numpy()
    _close(got, kern, act, "layer_stack vs JAX LayerStack")
    _close(got, ref[0], act, "layer_stack vs Flax FluidLayers")

    # no GroupNorm: bias + activation (merge 2's form)
    one = [(w, b, None, None) for w, b, _, _ in
           [_port_layer(params[0], learned)]]
    sw1 = pack_stack(one, groups=1, use_gn=False, act=act)
    d = _jax_layer(params[0], learned)
    d["gn_scale"], d["gn_bias"] = np.ones(C), np.zeros(C)
    st1 = LayerStack([d], H, W, 5, act=jl.get_activation(act),
                     learned=learned, dtype=jnp.float64, interpret=True,
                     use_gn=False)
    k1 = np.asarray(depth_to_space_rect(
        st1(space_to_depth_rect(xp, FR, FC)[0])[None], FR, FC, C)[0])[:, :W]
    y1, _ = layer_stack(_planar(x), sw1)
    _close(y1.permute(1, 2, 0).numpy(), k1, act, "merge-2 form vs JAX")


def _dense(raw, c, h, w):
    """A raw haloed block-layout piece of the JAX kernels → (c, h, w)."""
    hr, wc = raw.shape[0] - 2, raw.shape[1] - 2
    d = depth_to_space_rect(raw[None, 1:hr + 1, 1:wc + 1, :FR * FC * c],
                            FR, FC, c)[0, :h, :w]
    return torch.tensor(np.asarray(d)).permute(2, 0, 1).contiguous()


H, W, LEVELS, C_H = 16, 32, 2, 8


def _cfg(act, r_p):
    return dict(levels=LEVELS, c_i=7, c_h=C_H, c_o=1, act_fn=act, r_p=r_p,
                loss_type="curl", repeats=2, f=5, p_pred=False)


@functools.lru_cache(maxsize=None)
def _params(r_p):
    """Seeded Flax params of the network of :func:`_nets` (the tree does
    not depend on the activation) and a seeded input."""
    x = jnp.asarray(np.random.default_rng(7).normal(size=(1, H, W, 7)))
    jm = JNewFluidNet(**_cfg("gelu", r_p))
    return jax.jit(jm.init)(jax.random.PRNGKey(0), x), x


def _nets(act, r_p):
    """JAX's NewFluidNet (levels=2, c_h=8, repeats=2) with activation
    ``act``, its params, its executor with the interpret-mode kernels, and
    the port's NewFluidNet with the same weights, float64; the input."""
    cfg = _cfg(act, r_p)
    jm = JNewFluidNet(**cfg)
    p, x = _params(r_p)
    fast = JFast(jm, p, H, W, megakernel=True)
    assert fast.use_megakernel
    tm = NewFluidNet(**cfg, device="cpu", dtype=F64)
    tm.load_state_dict(from_jax_params(jax.tree.map(np.asarray, p)))
    return jm, p, fast, tm, x


def check_executor(act, r_p):
    """u, v of the port's executor against JAX's megakernel executor and
    the Flax module; the trunk against JAX's TrunkStack on the same
    branch outputs."""
    jm, p, jfast, tm, x = _nets(act, r_p)
    assert unsupported_reason(tm) is None
    fast = FastNewFluidNet(tm, H, W)
    assert fast.zero_pad == (r_p == "zeros")
    stacks = [fast.stem, *fast.branches, fast.trunk.merge, fast.merge2,
              fast.merge3]
    assert all(sw.act == act for sw in stacks)
    with torch.no_grad():
        u, v, _ = fast(torch.as_tensor(np.array(x)))
    ju, jv, _ = jfast(x)
    mu, mv, _ = jm.apply(p, x)
    for a, b, c, name in ((u, ju, mu, "u"), (v, jv, mv, "v")):
        _close(a.numpy(), b, act, f"executor {name} vs JAX megakernel")
        _close(a.numpy(), c, act, f"executor {name} vs Flax module")

    # the trunk against JAX's TrunkStack on the same branch outputs
    b0_raw, raw_outs, x6r = jfast._megakernel_branches(x, H, W)

    def lanepad(pc):
        return jnp.pad(pc, ((0, 0), (0, 0), (0, 128 - pc.shape[-1])))

    xh = lanepad(jnp.pad(x6r[0], ((1, 1), (1, 1), (0, 0))))
    ref = _dense(jfast.mkm1(lanepad(b0_raw), *[lanepad(o) for o in raw_outs],
                            xh), C_H, H, W)
    sizes = [(H >> l, W >> l) for l in range(1, LEVELS)]
    b0 = _dense(b0_raw, C_H, H, W)
    coarse = [_dense(o, C_H, h, w) for o, (h, w) in zip(raw_outs, sizes)]
    n0 = trunk.launches
    got = trunk(b0, coarse, _planar(x), fast.trunk)  # CPU → plain version
    assert trunk.launches == n0
    torch.testing.assert_close(got, trunk_plain(b0, coarse, _planar(x),
                                                fast.trunk), rtol=0, atol=0)
    _close(got.numpy(), ref.numpy(), act, "trunk vs JAX TrunkStack")


@pytest.mark.parametrize("act", ["selu", "sine"])
def test_zero_padded_executor_matches_jax(act):
    """:func:`check_executor` with zero padding (the kernels' zero
    instance); learned padding, every activation:
    tests/test_torch_port_activations_executor.py."""
    check_executor(act, "zeros")


def test_selu_fused_rollout_matches_the_jax_engine():
    """Six coupled ML_STOKES steps of a ``selu`` network (the NewFluidNet
    class's default activation) through the port's fused executor and
    fused epilogue against the JAX engine over the Flax module, float64,
    rtol 1e-10 on dt, the mean-T trace and the fields."""
    Hs, Ws, steps = 20, 28, 6
    cfg = dict(levels=2, c_i=7, c_h=8, c_o=1, act_fn="selu", r_p="learned",
               loss_type="curl", repeats=1, f=5, p_pred=False)
    jm = JNewFluidNet(**cfg)
    w = jax.jit(jm.init)(jax.random.PRNGKey(0),
                         jnp.zeros((1, Hs, Ws, 7), jnp.float64))
    tm = NewFluidNet(**cfg, device="cpu", dtype=F64)
    tm.load_state_dict(from_jax_params(jax.tree.map(np.asarray, w)))
    grid = Grid(H=Hs, W=Ws, aspect=(Ws - 2) / (Hs - 2))
    T0 = initial_temperature(grid)
    jgrid = JGrid(H=Hs, W=Ws, aspect=(Ws - 2) / (Hs - 2), dtype="float64")
    pp = JParams(3.0, 1e8, 10.0)
    jeng = JEngine(grid=jgrid, params=pp, dtype=jnp.float64,
                   stepper=JStepper(grid=jgrid, params=pp,
                                    apply_fn=lambda x: jm.apply(w, x),
                                    net="newfluidnet", cn_max=0.99,
                                    dtype=jnp.float64))
    jstate, jtrace = jax.jit(jeng.multi_step, static_argnums=1)(
        jeng.init_state(jnp.asarray(T0)), steps)
    eng = SimEngine(TimeStepper(grid, SimParams(3.0, 1e8, 10.0),
                                FastNewFluidNet(tm, Hs, Ws), cn_max=0.99,
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


@pytest.mark.parametrize("r_p", ["learned", "zeros"])
def test_every_activation_builds_the_executor(r_p):
    """Each activation of ``get_activation`` has its kernel code and
    builds the executor (no refusal, no module fallback); the plain stack
    applies that activation."""
    assert set(ACT_CODES) == set(_ACTIVATIONS) == set(ACTS)
    assert sorted(ACT_CODES.values()) == list(range(1, len(ACTS) + 1))
    for act in ACTS:
        net = NewFluidNet(levels=2, c_i=7, c_h=8, c_o=1, act_fn=act,
                          r_p=r_p, loss_type="curl", repeats=1, f=5,
                          p_pred=False, device="cpu")
        assert unsupported_reason(net) is None
        fast = FastNewFluidNet(net, 16, 30)
        assert fast.stem.act == fast.trunk.merge.act == fast.merge2.act == act
        assert act_code(act) == ACT_CODES[act]
    g = torch.Generator().manual_seed(0)
    w = [torch.randn(8, 8, 5, 5, generator=g, dtype=F64) * 0.1]
    b = torch.zeros(8, dtype=F64)
    x = torch.randn(8, 12, 20, generator=g, dtype=F64)
    for act in ACTS:
        sw = pack_stack([(w, b, None, None)], groups=1, use_gn=False,
                        act=act)
        lin = pack_stack([(w, b, None, None)], groups=1, use_gn=False,
                         use_act=False, act=act)
        y, _ = layer_stack_plain(x, sw)
        torch.testing.assert_close(
            y, get_activation(act)(layer_stack_plain(x, lin)[0]),
            rtol=0, atol=0)


def test_unknown_activation_raises():
    """An activation without a kernel instance raises; nothing falls back
    to GELU."""
    w = [torch.zeros(8, 8, 5, 5)]
    with pytest.raises(ValueError, match="no instance of activation"):
        pack_stack([(w, torch.zeros(8), None, None)], groups=1,
                   use_gn=False, act="swish")
    with pytest.raises(ValueError, match="no instance of activation"):
        act_code("softplus")
