"""The U-Net path of the port against the JAX package's, in float64 on the
CPU, with the Flax weights carried across by ``from_jax_params``:

1. ``ops/curl.py::gaussian_blur_5x9`` (≤1e-12);
2. ``models/unet.py::Unet`` (replicate, zero and learned padding, with and
   without ``blurr`` and ``p_pred``, the mae head) and ``ConvAE`` (curl
   with and without p, mae) against the Flax modules (≤1e-9), and the
   registry building them as JAX's does;
3. a U-Net coupled rollout (``SimEngine.step_unet``) against the JAX
   engine, rtol 1e-10, with and without the 11th (previous pressure)
   channel;
4. the train step's U-Net branch (``roll_forward`` 1 and 2) and ConvAE
   branch on the real networks: gradients against ``jax.grad`` ≤1e-10 of
   each tensor's max |grad|, parameters after 3 Adam steps against
   optax's ≤1e-9 (the parameters the loss cannot see are held to
   rounding noise and the losses after the steps compared instead, as in
   tests/test_torch_port_train_step.py);
5. the benchmark CLI's U-Net and ConvAE runs under the JAX CLI's metric
   names.
"""

import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from pbml_mantle_convection_tpu.cli.benchmark import main as jax_cli  # noqa: E402
from pbml_mantle_convection_tpu.constants import SimParams as JParams  # noqa: E402
from pbml_mantle_convection_tpu.models import registry as jreg  # noqa: E402
from pbml_mantle_convection_tpu.models.unet import ConvAE as JConvAE  # noqa: E402
from pbml_mantle_convection_tpu.models.unet import Unet as JUnet  # noqa: E402
from pbml_mantle_convection_tpu.ops.curl import (  # noqa: E402
    gaussian_blur_5x9 as j_blur)
from pbml_mantle_convection_tpu.sim.engine import SimEngine as JEngine  # noqa: E402
from pbml_mantle_convection_tpu.sim.grid import Grid as JGrid  # noqa: E402
from pbml_mantle_convection_tpu.sim.stepper import TimeStepper as JStepper  # noqa: E402
from pbml_mantle_convection_tpu.train import train_step as jts  # noqa: E402

from pbml_mantle_convection_tpu_torch.cli.benchmark import main as cli  # noqa: E402
from pbml_mantle_convection_tpu_torch.constants import SimParams  # noqa: E402
from pbml_mantle_convection_tpu_torch.models import registry  # noqa: E402
from pbml_mantle_convection_tpu_torch.models.unet import ConvAE, Unet  # noqa: E402
from pbml_mantle_convection_tpu_torch.ops.curl import gaussian_blur_5x9  # noqa: E402
from pbml_mantle_convection_tpu_torch.sim.engine import SimEngine  # noqa: E402
from pbml_mantle_convection_tpu_torch.sim.grid import Grid  # noqa: E402
from pbml_mantle_convection_tpu_torch.sim.stepper import TimeStepper  # noqa: E402
from pbml_mantle_convection_tpu_torch.train import train_step as tts  # noqa: E402
from pbml_mantle_convection_tpu_torch.train.trainer import adam_l2  # noqa: E402
from pbml_mantle_convection_tpu_torch.utils.flax_convert import (  # noqa: E402
    from_jax_params)

F64 = torch.float64
STEP = dict(loss_scale=True, loss_derivative=True, loss_type="curl")
# a gradient below this share of the model's largest is rounding noise
NOISE = 1e-12


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port(cls, params, **kw):
    m = cls(**kw, device="cpu", dtype=F64)
    m.load_state_dict(from_jax_params(_np(params)))
    return m


@pytest.mark.parametrize("shape", [(13, 21), (2, 6, 40)])
def test_gaussian_blur_5x9_matches_jax(shape):
    a = np.random.default_rng(0).normal(size=shape)
    np.testing.assert_allclose(gaussian_blur_5x9(torch.as_tensor(a)).numpy(),
                               np.asarray(j_blur(jnp.asarray(a))),
                               rtol=1e-12, atol=1e-12)


UNETS = [
    ((16, 30), dict(levels=3, c_i=10, c_h=8, c_o=2, r_p="replicate")),
    ((16, 30), dict(levels=2, c_i=11, c_h=8, c_o=3, r_p="replicate",
                    p_pred=True, blurr=True)),
    ((16, 30), dict(levels=2, c_i=10, c_h=4, c_o=2, r_p="replicate",
                    blurr=True)),
    ((16, 30), dict(levels=2, c_i=10, c_h=8, c_o=3, r_p="zeros",
                    loss_type="mae")),
    ((32, 40), dict(levels=3, c_i=10, c_h=8, c_o=2, r_p="learned")),
]


@pytest.mark.parametrize("shape,cfg", UNETS)
def test_unet_matches_flax(shape, cfg):
    """Every output (u, v, p when predicted, T) against the Flax Unet;
    learned padding grows the first layer by 6 columns (bc_x = 4)."""
    H, W = shape
    jm = JUnet(**cfg)
    x = np.random.default_rng(1).normal(size=(2, H, W, cfg["c_i"]))
    p = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    tm = _port(Unet, p, **cfg)
    assert set(tm.state_dict()) == set(from_jax_params(_np(p)))
    ref = jm.apply(p, jnp.asarray(x))
    with torch.no_grad():
        out = tm(torch.as_tensor(x))
    assert (out[2] is None) == (ref[2] is None)
    for a, b in zip(out, ref):
        if b is not None:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9,
                                       atol=1e-9)


CONVAES = [
    dict(levels=1, c_i=3, c_h=8, c_o=2, loss_type="curl", p_pred=False),
    dict(levels=2, c_i=3, c_h=4, c_o=3, loss_type="curl", p_pred=True),
    dict(levels=1, c_i=3, c_h=8, c_o=3, loss_type="mae", r_p="replicate"),
]


@pytest.mark.parametrize("cfg", CONVAES)
def test_convae_matches_flax(cfg):
    H, W = 32, 40
    jm = JConvAE(**cfg)
    x = np.random.default_rng(2).normal(size=(2, H, W, 3))
    p = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    tm = _port(ConvAE, p, **cfg)
    ref = np.asarray(jm.apply(p, jnp.asarray(x)))
    with torch.no_grad():
        out = tm(torch.as_tensor(x)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("net", ["unet", "iunet", "convae"])
def test_registry_builds_the_unet_family_as_jax(net):
    """``build_model`` builds unet, iunet (the same U-Net) and convae from
    a ModelConfig with JAX's channel rule: the parameter names and shapes
    of the Flax module the JAX registry builds."""
    kw = dict(network=net, levels=2, c_h=4, repeats=1, kernel=3,
              r_p="replicate", loss_type="curl", p_pred=False)
    jm = jreg.build_model(jreg.ModelConfig(**kw))
    c_i = jreg.ModelConfig(**kw).channels[0]
    assert registry.ModelConfig(**kw).channels == \
        jreg.ModelConfig(**kw).channels
    p = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 24, c_i)))
    tm = registry.build_model(registry.ModelConfig(**kw), device="cpu")
    assert isinstance(tm, ConvAE if net == "convae" else Unet)
    want = {k: tuple(v.shape) for k, v in from_jax_params(_np(p)).items()}
    assert {k: tuple(v.shape) for k, v in tm.state_dict().items()} == want
    # the layer options build too (their forwards: tests/
    # test_torch_port_fluidnet_item6.py)
    tm = registry.build_model(registry.ModelConfig(**{**kw, "dilation": 2}),
                              device="cpu")
    layer = tm.stem if net == "convae" else tm.convs_0_0
    assert layer.conv.dilation == 2


@pytest.mark.parametrize("p_pred", [False, True])
def test_unet_rollout_matches_the_jax_engine(p_pred):
    """Five coupled U-Net steps (the network advances u, v and T; dt from
    the driver's CFL rule; with ``unet_p_pred`` the previous pressure is
    the 11th channel) against the JAX engine, float64, rtol 1e-10."""
    H, W, steps = 16, 30, 5
    cfg = dict(levels=2, c_i=11 if p_pred else 10, c_h=8,
               c_o=3 if p_pred else 2, r_p="replicate", p_pred=p_pred,
               a_bound=4.0)
    jm = JUnet(**cfg)
    w = jm.init(jax.random.PRNGKey(5), jnp.zeros((1, H, W, cfg["c_i"]),
                                                 jnp.float64))
    w = jax.tree.map(lambda a: a * 0.3, w)
    T0 = np.clip(1.0 - Grid(H=H, W=W).yc + 0.05 * np.sin(
        6.28 * Grid(H=H, W=W).xc), 0, 1)[None]
    jgrid = JGrid(H=H, W=W, aspect=(W - 2) / (H - 2), dtype="float64")
    pp = JParams(3.0, 1e8, 10.0)
    jeng = JEngine(grid=jgrid, params=pp, dtype=jnp.float64,
                   stepper=JStepper(grid=jgrid, params=pp,
                                    apply_fn=lambda x: jm.apply(w, x),
                                    net="unet", unet_p_pred=p_pred,
                                    dtype=jnp.float64))
    jstate, jtrace = jax.jit(jeng.multi_step, static_argnums=1)(
        jeng.init_state(jnp.asarray(T0)), steps)
    grid = Grid(H=H, W=W, aspect=(W - 2) / (H - 2))
    eng = SimEngine(TimeStepper(grid, SimParams(3.0, 1e8, 10.0),
                                _port(Unet, w, **cfg), dtype=F64,
                                device="cpu", net="unet",
                                unet_p_pred=p_pred))
    state, trace = eng.multi_step(eng.init_state(T0), steps)
    np.testing.assert_allclose(trace.dt.numpy(), np.asarray(jtrace.dt),
                               rtol=1e-10)
    np.testing.assert_allclose(trace.mean_T.numpy(),
                               np.asarray(jtrace.mean_T), rtol=1e-10)
    for f in ("T", "u", "v", "p", "V"):
        np.testing.assert_allclose(getattr(state, f).numpy(),
                                   np.asarray(getattr(jstate, f)),
                                   rtol=1e-10, atol=1e-10)
    assert int(state.n_step) == steps


def _unet_batch(rng, B, H, W, c_i):
    yc = np.broadcast_to(Grid(H=H, W=W).yc, (B, H, W)).copy()
    return dict(x=rng.uniform(0.1, 0.9, size=(B, H, W, c_i)),
                y=rng.normal(size=(B, 3, H, W)),
                paras=np.tile([[3.0, 1e8, 10.0]], (B, 1)), yc=yc)


TRAIN_CASES = {
    "unet_rf1": ("unet", 1, dict(levels=2, c_i=10, c_h=4, c_o=2,
                                 r_p="replicate", repeats=1)),
    "unet_rf2": ("unet", 2, dict(levels=3, c_i=10, c_h=4, c_o=2,
                                 r_p="replicate", repeats=1)),
    "convae": ("convae", 1, dict(levels=1, c_i=3, c_h=4, c_o=2,
                                 loss_type="curl", p_pred=False,
                                 repeats=1)),
}


@pytest.fixture(scope="module", params=sorted(TRAIN_CASES))
def train_case(request):
    """The JAX side of one network, computed once: weights (perturbed),
    batch, the loss and gradients at them, and the compiled
    value_and_grad."""
    net, rf, cfg = TRAIN_CASES[request.param]
    rng = np.random.default_rng(0)
    H, W = 16, 24
    if net == "unet":
        jm = JUnet(**cfg)
        batch = _unet_batch(rng, 2, H, W, cfg["c_i"])
    else:
        jm = JConvAE(**cfg)
        batch = dict(x=rng.normal(size=(2, H, W, 3)),
                     y=rng.normal(size=(2, 2, H, W)))
    p = jm.init(jax.random.PRNGKey(0), jnp.asarray(batch["x"]))
    noise = np.random.default_rng(1)
    p = jax.tree.map(lambda a: np.asarray(a, np.float64)
                     + 0.02 * noise.normal(size=np.shape(a)), p)
    scfg = dict(net=net, roll_forward=rf, **STEP)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    grad = jax.jit(jax.value_and_grad(
        jts.make_loss_fn(jm.apply, jts.TrainStepConfig(**scfg)),
        has_aux=True))
    (_, br), g = grad(p, jbatch)
    return dict(cls=Unet if net == "unet" else ConvAE, cfg=cfg, p=p,
                batch=batch, jbatch=jbatch, scfg=scfg, br=br, grad=grad,
                grads=from_jax_params(_np(g)))


def _tbatch(case):
    return {k: torch.as_tensor(v) for k, v in case["batch"].items()}


def _noise(grads):
    top = max(float(g.abs().max()) for g in grads.values())
    return {n for n, g in grads.items() if float(g.abs().max()) <= NOISE * top}


def _close_breakdown(br, jbr, rtol):
    ref = np.asarray(jbr)
    np.testing.assert_allclose(br.stack().numpy(), ref, rtol=rtol,
                               atol=1e-12 * abs(ref[0]))


def test_unet_family_gradients_match_jax(train_case):
    """One train step of the real network: the loss breakdown ≤1e-12 and
    every parameter's gradient ≤1e-10 of its max |grad|; a bias the loss
    cannot see gets rounding noise on both sides: the last conv's (the
    mean subtraction or the curl head removes it) and that of a conv
    whose GroupNorm has one channel per group (the ConvAE's last decoder
    layer)."""
    case = train_case
    m = _port(case["cls"], case["p"], **case["cfg"])
    step = tts.make_train_step(m, adam_l2(m.parameters(), 0.0),
                               tts.TrainStepConfig(**case["scfg"]))
    _close_breakdown(step(_tbatch(case)), case["br"], rtol=1e-12)
    grads = case["grads"]
    assert sorted(n for n, _ in m.named_parameters()) == sorted(grads)
    noise = _noise(grads)
    assert all(n.endswith("bias") for n in noise)
    top = max(float(g.abs().max()) for g in grads.values())
    for n, q in m.named_parameters():
        g = grads[n]
        if n in noise:
            assert float(q.grad.abs().max()) <= NOISE * top, n
            continue
        err = float((q.grad - g).abs().max()) / float(g.abs().max())
        assert err <= 1e-10, (n, err)


def test_unet_family_three_adam_steps_match_optax(train_case):
    case = train_case
    m = _port(case["cls"], case["p"], **case["cfg"])
    cfg = tts.TrainStepConfig(**case["scfg"])
    step = tts.make_train_step(m, adam_l2(m.parameters(), 1e-3), cfg)
    opt = optax.chain(optax.add_decayed_weights(0.0), optax.adam(1e-3))
    q = case["p"]
    state = opt.init(q)
    for _ in range(3):
        br = step(_tbatch(case))
        (_, jbr), g = case["grad"](q, case["jbatch"])
        updates, state = opt.update(g, state, q)
        q = optax.apply_updates(q, updates)
    _close_breakdown(br, jbr, rtol=1e-9)
    ref = from_jax_params(_np(q))
    noise = _noise(case["grads"])
    for n, w in m.named_parameters():
        if n not in noise:
            err = float((w.detach() - ref[n]).abs().max())
            assert err <= 1e-9 * float(ref[n].abs().max()), (n, err)
    (_, jbr), _ = case["grad"](q, case["jbatch"])
    _close_breakdown(tts.make_eval_step(m, cfg)(_tbatch(case)), jbr,
                     rtol=1e-9)


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("what,net", [("inference", "unet"),
                                      ("rollout", "unet"),
                                      ("rollout", "iunet"),
                                      ("train", "unet"),
                                      ("inference", "convae"),
                                      ("train", "convae")])
def test_benchmark_cli_unet_family_is_the_jax_clis(capsys, what, net):
    """``--what inference|rollout|train -net unet|iunet|convae`` run and
    print the JAX CLI's metric name (``rollout_steps_per_s_unet_{H}x{W}``,
    JAX cli/benchmark.py:257-263) with its keys; the loss of the train
    step (the default batch, 8, which splits over the JAX tests' 8 CPU
    devices) is finite."""
    argv = ["--what", what, "-net", net, "-l", "2", "-f", "4", "-r", "1",
            "-k", "3", "-pad", "replicate", "--H", "16", "--W", "24",
            "--iters", "1", "--steps", "2"]
    jax_cli(argv)
    ref = _last_json(capsys)
    cli(argv + ["--device", "cpu"])
    rec = _last_json(capsys)
    assert rec["metric"] == ref["metric"]
    assert set(ref) <= set(rec)
    if what == "train":
        assert np.isfinite(rec["loss"])


def test_convae_has_no_rollout():
    with pytest.raises(ValueError, match="no coupled rollout"):
        cli(["--what", "rollout", "-net", "convae", "-l", "1", "-f", "4",
             "-r", "1", "-k", "3", "--H", "16", "--W", "24", "--steps", "1",
             "--device", "cpu"])


@pytest.mark.parametrize("bias", [True, False])
def test_routed_weight_gradient_conv_is_conv2d(bias):
    """The conv whose gradients take a route off cuDNN on the card
    (``models/layers.py::_WgradOffCudnnConv``; ROADMAP §3 faults 7, 8):
    its forward is ``F.conv2d`` and its gradients pass gradcheck in
    float64; the U-Net routes its pooled levels' convs and its merge,
    NewFluidNet its merge-1 slabs, the rest stay on cuDNN."""
    from pbml_mantle_convection_tpu_torch.models.fluidnet import NewFluidNet
    from pbml_mantle_convection_tpu_torch.models.layers import (
        _WgradOffCudnnConv, conv2d_routed)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, 7, 9, dtype=F64, generator=g, requires_grad=True)
    w = torch.randn(4, 3, 3, 3, dtype=F64, generator=g, requires_grad=True)
    b = (torch.randn(4, dtype=F64, generator=g, requires_grad=True)
         if bias else None)

    def fn(x, w, b):
        return _WgradOffCudnnConv.apply(x, w, b)

    assert torch.equal(fn(x, w, b), torch.nn.functional.conv2d(x, w, b))
    assert torch.autograd.gradcheck(fn, (x, w, b))
    # on a CPU tensor the route is not taken
    assert torch.equal(conv2d_routed(x, w, b, True),
                       torch.nn.functional.conv2d(x, w, b))
    net = Unet(levels=3, c_i=10, c_h=4, c_o=2, device="cpu")
    routed = {n for n, m in net.named_modules()
              if getattr(m, "wgrad_off_cudnn", False)}
    assert routed == {"conv_m3", "convs_0_0.conv", "convs_0_1.conv",
                      "convs_1_0.conv", "convs_1_1.conv",
                      "upconvs_0_0.conv", "upconvs_0_1.conv"}
    learned = Unet(levels=3, c_i=10, c_h=4, c_o=2, r_p="learned",
                   device="cpu")
    assert {n for n, m in learned.named_modules()
            if getattr(m, "wgrad_off_cudnn", False)} == routed
    nfn = NewFluidNet(levels=2, c_i=7, c_h=4, c_o=1, r_p="learned", f=5,
                      repeats=1, device="cpu")
    assert {n for n, m in nfn.named_modules()
            if getattr(m, "wgrad_off_cudnn", False)} == {"conv_1"}
