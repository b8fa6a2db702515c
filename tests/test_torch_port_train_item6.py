"""Training the other models on the port against the JAX package's, in
float64 on the CPU, the Flax weights carried across by
``from_jax_params``:

1. one train step of each new network (the symmetric NewFluidNet, the
   spectral NewFluidNet, FluidNet, the multi-scale ensemble, the ViT),
   dropout off: the loss breakdown ≤1e-12 and every parameter's gradient
   against ``jax.grad`` ≤1e-10 of its max |grad| (a parameter the loss
   cannot see gets rounding noise on both sides and is held to that, as
   in tests/test_torch_port_train_step.py);
2. the experiments of the other models through ``run_experiment`` on the
   JAX CLI's synthetic stores (32×68), one epoch, finite losses. Cut to
   test size: ``-l 2 -r 1`` for the FluidNet family (``fluidnet_base``'s
   six levels need 192 cells each way; ``multiscale``'s four learned
   levels 96), the spectral and ViT entries as registered.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from pbml_mantle_convection_tpu.models import fluidnet as jfn  # noqa: E402
from pbml_mantle_convection_tpu.models import vit as jvit  # noqa: E402
from pbml_mantle_convection_tpu.train import train_step as jts  # noqa: E402

from pbml_mantle_convection_tpu_torch.models import fluidnet as tfn  # noqa: E402
from pbml_mantle_convection_tpu_torch.models import vit as tvit  # noqa: E402
from pbml_mantle_convection_tpu_torch.train import experiments  # noqa: E402
from pbml_mantle_convection_tpu_torch.train import train_step as tts  # noqa: E402
from pbml_mantle_convection_tpu_torch.train.trainer import (  # noqa: E402
    adam_l2, parse_loss_log)
from pbml_mantle_convection_tpu_torch.utils.flax_convert import (  # noqa: E402
    from_jax_params)

F64 = torch.float64
STEP = dict(loss_scale=True, loss_derivative=True, loss_type="curl")
# a gradient below this share of the model's largest is rounding noise
NOISE = 1e-12
FL = dict(levels=2, c_i=7, c_h=4, c_o=1, act_fn="gelu", loss_type="curl",
          repeats=1, f=5, p_pred=False)
H, W = 16, 24
NETS = {
    "symm": ("NewFluidNet", "newfluidnet",
             dict(FL, r_p="learned", use_symm=True, c_h=8)),
    "spectral": ("NewFluidNet", "newfluidnet",
                 dict(FL, r_p="zeros", spectral_conv=True)),
    "fluidnet": ("FluidNet", "fluidnet", dict(FL, r_p="learned")),
    "multiscale": ("MultiScaleNewFluidNet", "multiscalenewfluidnet",
                   dict(FL, r_p="zeros", scales=(1e-4, 1e-1))),
    "vit": ("ViTField", "vit",
            dict(image_size=(H, W), patch_size=(8, 2), c_o=2, dim=16,
                 depth=1, heads=2, mlp_dim=32, channels=7)),
}


def _modules(name):
    cls, net, cfg = NETS[name]
    jmod, tmod = (jvit, tvit) if name == "vit" else (jfn, tfn)
    return (getattr(jmod, cls)(**cfg),
            getattr(tmod, cls)(**cfg, device="cpu", dtype=F64), net)


@pytest.mark.parametrize("name", sorted(NETS))
def test_train_step_gradients_match_jax(name):
    jm, tm, net = _modules(name)
    rng = np.random.default_rng(0)
    x = rng.uniform(0.0, 0.5, size=(2, H, W, 7))
    x[..., 2] = rng.uniform(-1.0, 0.0, size=(2, H, W))
    y = rng.normal(size=(2, 2, H, W))
    p = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    noise = np.random.default_rng(1)
    p = jax.tree.map(lambda a: np.asarray(a, np.float64)
                     + 0.02 * noise.normal(size=np.shape(a)), p)
    cfg = dict(net=net, **STEP)
    (_, jbr), g = jax.jit(jax.value_and_grad(
        jts.make_loss_fn(jm.apply, jts.TrainStepConfig(**cfg)),
        has_aux=True))(p, {"x": jnp.asarray(x), "y": jnp.asarray(y)})
    grads = from_jax_params(jax.tree.map(np.asarray, g))
    tm.load_state_dict(from_jax_params(p), strict=True)
    br = tts.make_train_step(tm, adam_l2(tm.parameters(), 0.0),
                             tts.TrainStepConfig(**cfg))(
        {"x": torch.as_tensor(x), "y": torch.as_tensor(y)})
    ref = np.asarray(jbr)
    np.testing.assert_allclose(br.stack().numpy(), ref, rtol=1e-12,
                               atol=1e-12 * abs(ref[0]))
    assert sorted(n for n, _ in tm.named_parameters()) == sorted(grads)
    top = max(float(v.abs().max()) for v in grads.values())
    for n, q in tm.named_parameters():
        want = grads[n]
        if float(want.abs().max()) <= NOISE * top:
            assert n.endswith("bias"), n
            assert float(q.grad.abs().max()) <= NOISE * top, n
            continue
        err = float((q.grad - want).abs().max()) / float(want.abs().max())
        assert err <= 1e-10, (n, err)


CUT = ["-l", "2", "-r", "1"]


@pytest.mark.parametrize("name,cut", [
    ("newfluidnet_symm", CUT), ("fluidnet_base", CUT), ("multiscale", CUT),
    ("newfluidnet_spectral", []), ("vit", [])])
def test_experiments_of_the_other_models_run(tmp_path, name, cut):
    tr = experiments.run_experiment(name, [
        *cut, "--device", "cpu", "--epochs", "1", "--nn_dir", str(tmp_path)])
    log = parse_loss_log(tr.log_path)
    assert [e["epoch"] for e in log] == [0]
    assert np.isfinite(log[0]["train"]).all()
    assert np.isfinite(log[0]["cv"]).all()
