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
   are 25× JAX's own spread: ``SINE_STEP_TOL``;
5. the last public names (ROADMAP queue 1 item 11): the grid constants
   and ``dim_raq``/``dim_fkt``/``dim_fkp`` (≤1e-15, and the inverses of
   ``nondim_*``), ``Grid.n_layers``, ``fk_viscosity``'s ``Tref``/``zref``
   (≤1e-14; with the defaults bitwise the function it was, and
   ``fk_viscosity_clipped`` with them), and ``resize_bicubic`` /
   ``resize_bicubic_nhwc`` with ``a`` ∈ {-0.5, -0.75} and both
   ``align_corners`` (matrices bitwise, resizes ≤1e-14), the default
   matrix one cache entry however it is asked for;
6. every name the JAX package's ``__init__.py`` files export imports
   from the port's package of the same path (but ``utils``' XLA
   ``TPU_COMPILER_OPTIONS`` and ``tpu_jit``), as the same object as the
   port module's own.
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
from pbml_mantle_convection_tpu.ops import resize as jresize  # noqa: E402
from pbml_mantle_convection_tpu.physics import viscosity as jvisc  # noqa: E402
from pbml_mantle_convection_tpu.sim import grid as jgrid  # noqa: E402
from pbml_mantle_convection_tpu.train import train_step as jts  # noqa: E402

from pbml_mantle_convection_tpu_torch import constants as tc  # noqa: E402
from pbml_mantle_convection_tpu_torch.cli import train  # noqa: E402
from pbml_mantle_convection_tpu_torch.models.registry import (  # noqa: E402
    build_model)
from pbml_mantle_convection_tpu_torch.ops import resize as tresize  # noqa: E402
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


def test_grid_constants_and_dimensionalizations_match_jax():
    for name in ("GRID_H", "GRID_W", "ASPECT_RATIO", "N_LAYERS"):
        assert getattr(tc, name) == getattr(jc, name), name
        assert type(getattr(tc, name)) is type(getattr(jc, name)), name
    g = tgrid.Grid(H=tc.GRID_H, W=tc.GRID_W, aspect=tc.ASPECT_RATIO)
    assert g.n_layers == jgrid.Grid().n_layers == tc.N_LAYERS == 126
    for H in (20, 256):
        assert tgrid.Grid(H=H, W=40).n_layers == jgrid.Grid(H=H,
                                                            W=40).n_layers
    x = np.random.default_rng(2).random(64)
    for name in ("raq", "fkt", "fkp"):
        dim, jdim = getattr(tc, f"dim_{name}"), getattr(jc, f"dim_{name}")
        np.testing.assert_allclose(dim(x), jdim(x), rtol=1e-15, atol=0)
        assert dim(0.25) == jdim(0.25)
        np.testing.assert_allclose(getattr(tc, f"nondim_{name}")(dim(x)), x,
                                   rtol=1e-12, atol=1e-14)


def test_fk_viscosity_reference_state_matches_jax():
    g = tgrid.Grid(H=16, W=40)
    T = np.random.default_rng(3).random((2, 16, 40))
    z, Tt, zt = 1.0 - g.yc, torch.as_tensor(T), torch.as_tensor(1.0 - g.yc)
    for gamma, beta in ((1e8, 10.0), (1e6, 1.0)):
        for Tref, zref in ((0.5, 0.0), (0.0, 0.3), (0.7, 0.6)):
            want = jvisc.fk_viscosity(gamma, beta, jnp.asarray(z),
                                      jnp.asarray(T), Tref, zref)
            got = tvisc.fk_viscosity(gamma, beta, zt, Tt, Tref=Tref,
                                     zref=zref)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-14, atol=0)
        # the defaults: bitwise the law as it was, exp(ln γ·(0 - T) +
        # ln β·z), in each dtype, and the clipped law the stepper reads
        for dt in (torch.float64, torch.float32):
            T_, z_ = Tt.to(dt), zt.to(dt)
            old = torch.exp(np.log(gamma) * (0.0 - T_) + np.log(beta) * z_)
            new = tvisc.fk_viscosity(gamma, beta, z_, T_)
            assert torch.equal(new, old)
            assert torch.equal(tvisc.fk_viscosity(gamma, beta, z_, T_, 0.0,
                                                  0.0), old)
            assert torch.equal(
                tvisc.fk_viscosity_clipped(gamma, beta, z_, T_),
                torch.clamp(old, 1e-8, 1.0))


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("a", [-0.5, -0.75])
def test_resize_bicubic_arguments_match_jax(a, align_corners):
    rng = np.random.default_rng(4)
    for (h, w), out in (((8, 31), (16, 62)), ((16, 63), (128, 506)),
                        ((12, 20), (5, 7))):
        for n_in, n_out in ((h, out[0]), (w, out[1])):
            np.testing.assert_array_equal(
                tresize._resize_matrix_np(n_in, n_out, a, align_corners),
                jresize._resize_matrix_np(n_in, n_out, a, align_corners))
        x = rng.normal(size=(2, 3, h, w))
        want = jresize.resize_bicubic(jnp.asarray(x), out, a, align_corners)
        got = tresize.resize_bicubic(torch.as_tensor(x), out, a=a,
                                     align_corners=align_corners)
        scale = float(np.abs(np.asarray(want)).max())
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-14 * scale)
        xn = rng.normal(size=(2, h, w, 3))
        want = jresize.resize_bicubic_nhwc(jnp.asarray(xn), out, a,
                                           align_corners)
        got = tresize.resize_bicubic_nhwc(torch.as_tensor(xn), out, a,
                                          align_corners)
        assert got.shape == (2, *out, 3)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-14 * float(np.abs(want).max()))
    # the default matrix, however it is asked for, is one cache entry:
    # the one the trunk kernel's tap tables and resize_matrix read
    from pbml_mantle_convection_tpu_torch.ops.merge_kernel import _taps
    before = tresize._cubic_matrix_np.cache_info()
    m = tresize._resize_matrix_np(63, 506)
    assert tresize._resize_matrix_np(63, 506, -0.75, False) is m
    assert tresize._resize_matrix_np(63, 506, a=-0.75) is m
    _taps(63, 506)
    after = tresize._cubic_matrix_np.cache_info()
    assert after.currsize - before.currsize <= 1
    np.testing.assert_array_equal(
        tresize.resize_matrix(63, 506, torch.float64, "cpu").numpy(), m)


# the JAX package's __init__.py re-exports, by package; utils' XLA
# compiler options (utils/jit.py) have no counterpart, and the port has
# no StepTimer: it synchronised the card at every step, which no rate may
# do, and nothing read it (utils/profiling.py::span marks the layers)
JAX_ONLY = {"utils": {"TPU_COMPILER_OPTIONS", "tpu_jit", "StepTimer"}}
PACKAGES = ("", "models", "train", "data", "utils", "ops", "physics", "sim",
            "parallel")


def _exports(pkg):
    """The names the __init__.py of ``pkg`` imports (its re-exports)."""
    import ast
    import importlib
    from pathlib import Path
    mod = importlib.import_module(pkg)
    tree = ast.parse(Path(mod.__file__).read_text())
    names = set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            names |= {a.asname or a.name for a in node.names}
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets}
    return names


@pytest.mark.parametrize("sub", PACKAGES, ids=[s or "top" for s in PACKAGES])
def test_package_exports_match_jax(sub):
    import importlib
    import subprocess
    import sys
    jname = "pbml_mantle_convection_tpu" + (f".{sub}" if sub else "")
    tname = "pbml_mantle_convection_tpu_torch" + (f".{sub}" if sub else "")
    want = _exports(jname) - JAX_ONLY.get(sub, set())
    assert want, jname
    assert _exports(tname) == want
    jmod, tmod = importlib.import_module(jname), importlib.import_module(tname)
    for name in sorted(want):
        got = getattr(tmod, name)
        assert type(got) is not type(jax) or got.__name__.startswith(
            "pbml_mantle_convection_tpu_torch."), name
        j = getattr(jmod, name)
        if isinstance(j, str):
            assert got == j, name          # __version__
        elif hasattr(j, "__module__") and not isinstance(j, type(jax)):
            # each export is the port module's own object of that name
            src = importlib.import_module(
                j.__module__.replace("pbml_mantle_convection_tpu",
                                     "pbml_mantle_convection_tpu_torch", 1))
            assert getattr(src, name) is got, name
    # `from <package> import <names>` in a fresh interpreter: no JAX
    # loaded, no kernel built
    code = (f"import sys\nfrom {tname} import {', '.join(sorted(want))}\n"
            "from pbml_mantle_convection_tpu_torch.ops import _cuda\n"
            "assert _cuda.library.cache_info().currsize == 0\n"
            "assert not any(m.split('.')[0] in ('jax', 'flax', "
            "'pbml_mantle_convection_tpu') for m in sys.modules)\n")
    subprocess.run([sys.executable, "-c", code], check=True)


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
