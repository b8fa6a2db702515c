"""The port's counterparts of the JAX package's remaining public helpers,
and the ``sine`` activation through the training CLI, on the CPU in
float64:

1. ``constants.scale_var`` / ``unscale_var`` against JAX's (numpy and
   tensors; only ``uprev`` / ``vprev`` scale), ≤1e-15;
2. ``physics/viscosity.py::fk_viscosity_feature`` against JAX's, ≤1e-14;
3. ``sim/grid.py``'s ``Grid.xc_np``, ``Grid.yc_np`` and ``DEFAULT_GRID``
   against JAX's, to the bit;
4. ROADMAP §3 fault 11: ``cli/train.py -a sine`` raised ``ValueError``
   (the port had no ``sine`` activation) where JAX's CLI trains. It now
   trains one epoch, and the first step of its configuration matches
   JAX's train step in float64. The tolerances of
   tests/test_torch_port_train_step.py (loss breakdown 1e-12, each
   parameter's gradient 1e-10 of its max |grad|) are below what JAX
   itself holds for ``sine``: its jitted and its eager evaluation of this
   step differ by 8.8e-13 in the breakdown and 4.3e-10 in the gradients
   (each ``sin(30·)`` multiplies a rounding error by up to 30; for
   ``gelu`` the same two read 4.6e-18 and 3.8e-15). So, as for the
   ``sine`` forward in tests/test_torch_port_activations.py, the bounds
   are 25× JAX's own spread: ``SINE_STEP_TOL``.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from pbml_mantle_convection_tpu import constants as jc  # noqa: E402
from pbml_mantle_convection_tpu.cli import train as jtrain  # noqa: E402
from pbml_mantle_convection_tpu.models.registry import (  # noqa: E402
    ModelConfig as JConfig, build_model as j_build)
from pbml_mantle_convection_tpu.physics import viscosity as jvisc  # noqa: E402
from pbml_mantle_convection_tpu.sim import grid as jgrid  # noqa: E402
from pbml_mantle_convection_tpu.train import train_step as jts  # noqa: E402

from pbml_mantle_convection_tpu_torch import constants as tc  # noqa: E402
from pbml_mantle_convection_tpu_torch.cli import train  # noqa: E402
from pbml_mantle_convection_tpu_torch.models.registry import (  # noqa: E402
    build_model)
from pbml_mantle_convection_tpu_torch.physics import viscosity as tvisc  # noqa: E402
from pbml_mantle_convection_tpu_torch.sim import grid as tgrid  # noqa: E402
from pbml_mantle_convection_tpu_torch.train import train_step as tts  # noqa: E402
from pbml_mantle_convection_tpu_torch.train.trainer import (  # noqa: E402
    adam_l2, parse_loss_log)
from pbml_mantle_convection_tpu_torch.utils.flax_convert import (  # noqa: E402
    from_jax_params)

F64 = torch.float64
# a gradient below this share of the model's largest is rounding noise
NOISE = 1e-12
# the sine train step against JAX's (module doc): loss breakdown, gradients
SINE_STEP_TOL = {"breakdown": 2.5e-11, "grad": 1e-8}


@pytest.mark.parametrize("var", ["uprev", "vprev", "p", "V", "T"])
def test_scale_var_matches_jax(var):
    x = np.random.default_rng(0).normal(size=(3, 8, 12))
    for raq, fkt, fkp in ((3.0, 1e8, 10.0), (np.array([0.5, 3.0, 9.0]),
                                             np.array([1e6, 1e8, 1e9]),
                                             np.array([1.0, 10.0, 90.0]))):
        if np.ndim(raq):
            raq, fkt, fkp = (a[:, None, None] for a in (raq, fkt, fkp))
        want = jc.scale_var(x, raq, fkt, fkp, var)
        got = tc.scale_var(x, raq, fkt, fkp, var)
        np.testing.assert_allclose(got, want, rtol=1e-15, atol=0)
        back = tc.unscale_var(got, raq, fkt, fkp, var)
        np.testing.assert_allclose(back, jc.unscale_var(want, raq, fkt, fkp,
                                                        var),
                                   rtol=1e-15, atol=0)
        np.testing.assert_allclose(back, x, rtol=1e-14, atol=0)
        t = tc.scale_var(torch.as_tensor(x), raq, fkt, fkp, var)
        np.testing.assert_allclose(np.asarray(t), want, rtol=1e-15, atol=0)
        assert (got is x) == (var not in ("uprev", "vprev"))


def test_fk_viscosity_feature_matches_jax():
    g = tgrid.Grid(H=16, W=40)
    T = np.random.default_rng(1).random((2, 16, 40))
    z = 1.0 - g.yc
    for gamma, beta in ((1e8, 10.0), (1e6, 1.0), (1e9, 90.0)):
        want = jvisc.fk_viscosity_feature(gamma, beta, jnp.asarray(z),
                                          jnp.asarray(T))
        got = tvisc.fk_viscosity_feature(gamma, beta, torch.as_tensor(z),
                                         torch.as_tensor(T))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-14, atol=1e-15)
        assert float(got.min()) >= -1.0 and float(got.max()) <= 0.0


def test_grid_host_coordinates_and_default_grid():
    for H, W, aspect in ((128, 506, 4.0), (20, 28, 26 / 18), (256, 256, 1.0)):
        j, t = jgrid.Grid(H=H, W=W, aspect=aspect), tgrid.Grid(H=H, W=W,
                                                               aspect=aspect)
        np.testing.assert_array_equal(t.xc_np, j.xc_np)
        np.testing.assert_array_equal(t.yc_np, j.yc_np)
        assert t.xc_np.dtype == np.float64
    d, jd = tgrid.DEFAULT_GRID, jgrid.DEFAULT_GRID
    assert (d.H, d.W, d.aspect) == (jd.H, jd.W, jd.aspect) == (128, 506, 4.0)
    np.testing.assert_array_equal(d.yc_np, jd.yc_np)
    from pbml_mantle_convection_tpu_torch.sim import DEFAULT_GRID
    assert DEFAULT_GRID is d


SINE_ARGV = ["-a", "sine", "-l", "2", "-f", "4", "-r", "1", "-p", "learned",
             "-b", "8", "-l_sc", "1", "-l_de", "1", "--synthetic",
             "--epochs", "1"]


def test_train_cli_sine_takes_jaxs_first_step(tmp_path):
    tr = train.main([*SINE_ARGV, "--device", "cpu",
                     "--nn_dir", str(tmp_path)])
    assert tr.cfg.model.act_fn == "sine" and tr.model.act_fn == "sine"
    log = parse_loss_log(tr.log_path)
    assert [e["epoch"] for e in log] == [0]
    assert np.isfinite(log[0]["train"]).all()

    # the first step of that configuration, float64, against JAX's
    a = jtrain.build_parser().parse_args([*SINE_ARGV, "--nn_dir",
                                          str(tmp_path)])
    jm = j_build(JConfig(network=a.network, levels=a.levels, c_h=a.c_h,
                         act_fn=a.act_fn, r_p=a.r_p, loss_type=a.loss_type,
                         repeats=a.repeats, kernel=a.kernel))
    tm = build_model(dataclasses.replace(tr.cfg.model, dtype=F64),
                     device="cpu")
    H, W = 16, 24
    rng = np.random.default_rng(0)
    x = rng.uniform(0.0, 0.5, size=(2, H, W, 7))
    x[..., 2] = rng.uniform(-1.0, 0.0, size=(2, H, W))
    y = rng.normal(size=(2, 2, H, W))
    p = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    p = jax.tree.map(lambda v: np.asarray(v, np.float64), p)
    cfg = dict(net=a.network, loss_scale=bool(a.loss_scale),
               loss_derivative=bool(a.loss_derivative),
               loss_type=a.loss_type)
    (_, jbr), g = jax.jit(jax.value_and_grad(
        jts.make_loss_fn(jm.apply, jts.TrainStepConfig(**cfg)),
        has_aux=True))(p, {"x": jnp.asarray(x), "y": jnp.asarray(y)})
    grads = from_jax_params(jax.tree.map(np.asarray, g))
    tm.load_state_dict(from_jax_params(p), strict=True)
    br = tts.make_train_step(tm, adam_l2(tm.parameters(), 0.0),
                             tts.TrainStepConfig(**cfg))(
        {"x": torch.as_tensor(x), "y": torch.as_tensor(y)})
    ref = np.asarray(jbr)
    tol = SINE_STEP_TOL["breakdown"]
    np.testing.assert_allclose(br.stack().numpy(), ref, rtol=tol,
                               atol=tol * abs(ref[0]))
    top = max(float(v.abs().max()) for v in grads.values())
    for n, q in tm.named_parameters():
        want = grads[n]
        if float(want.abs().max()) <= NOISE * top:
            assert float(q.grad.abs().max()) <= NOISE * top, n
            continue
        err = float((q.grad - want).abs().max()) / float(want.abs().max())
        assert err <= SINE_STEP_TOL["grad"], (n, err)
