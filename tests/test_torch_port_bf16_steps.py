"""``--dtype bfloat16`` train steps and rollouts: the port against the
JAX package on the CPU at small sizes, the JAX modules' bfloat16 weights
carried across (``tests/test_torch_port_bf16.py::jax_and_port``).

* ``--what train`` (B = 2, the JAX CLI's seeded batch): the loss of the
  first step, JAX's ``make_loss_fn`` against the port's, for the flagship,
  FluidNet, the ensemble, the ViT, the U-Net and the structured
  Transolver, on the points its step reads (the JAX CLI feeds it an
  image: a ValueError in float32 too); the irregular Transolver's point
  head, on which JAX's train step fails in float32 too, against the
  port's own float32 loss;
* ``--what rollout`` where the JAX CLI runs in bfloat16 (FluidNet, the
  ensemble, the ViT, the U-Net): coupled steps from the CLI's initial
  field against JAX's engine. The port's energy step runs in float32 on
  the bfloat16 values, JAX's in bfloat16: after ``ENERGY_STEPS`` steps
  the change of T, T - T0, against JAX's within ``TOL_BF16_DT`` of its
  largest change, and a planted halved or skipped energy step outside
  it; t within ``TOL_BF16``. The U-Net advances T itself (no energy
  step) and parts from JAX as a chaotic random network does: T after
  two steps within ``TOL_BF16``.

Then each combination through the port's CLI.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from pbml_mantle_convection_tpu.constants import SimParams as JParams  # noqa: E402
from pbml_mantle_convection_tpu.sim.engine import SimEngine as JEngine  # noqa: E402
from pbml_mantle_convection_tpu.sim.grid import Grid as JGrid  # noqa: E402
from pbml_mantle_convection_tpu.sim.stepper import TimeStepper as JStepper  # noqa: E402
from pbml_mantle_convection_tpu.train import train_step as jts  # noqa: E402

from pbml_mantle_convection_tpu_torch.cli.benchmark import (  # noqa: E402
    initial_temperature, main, train_batch)
from pbml_mantle_convection_tpu_torch.constants import SimParams  # noqa: E402
from pbml_mantle_convection_tpu_torch.sim.engine import SimEngine  # noqa: E402
from pbml_mantle_convection_tpu_torch.sim.grid import Grid  # noqa: E402
from pbml_mantle_convection_tpu_torch.sim.stepper import TimeStepper  # noqa: E402
from pbml_mantle_convection_tpu_torch.train import train_step as tts  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_port_bf16 import (  # noqa: E402
    ROWS, SMALL, TOL_BF16, _argv, jax_and_port, rel_err)

# the change of T after ENERGY_STEPS coupled steps against JAX's,
# max |diff| / max |JAX's change|: the two energy steps part by one
# bfloat16 rounding of T (2^-8 near T = 1) at a few cells, 3.7e-2 to
# 4.9e-2 of the largest change (0.079 to 0.105) for FluidNet, the ensemble
# and the ViT at 16x24; a planted halved energy step reads 0.36 to 0.48,
# a skipped one 0.89 to 1.0
TOL_BF16_DT = 0.1
ENERGY_STEPS = 8

TRAIN = {k: ROWS[k][0] for k in ("raw_module", "fluidnet", "ensemble",
                                 "vit", "unet", "transolver_structured")}
ROLLOUT = ("fluidnet", "ensemble", "vit", "unet")


@pytest.mark.parametrize("row", sorted(TRAIN))
def test_train_step_loss_matches_jax(row, capsys):
    fields = TRAIN[row]
    net = fields["network"]
    f = {**SMALL, **fields}
    jm, w, pm, _ = jax_and_port(fields)
    c_i = 7 if net != "unet" else 10
    batch = train_batch(net, 2, f["H"], f["W"], c_i, torch.bfloat16, "cpu")
    cfg = dict(net=net, p_pred=False, loss_scale=True, loss_derivative=True,
               loss_type="curl")
    jbatch = {k: jnp.asarray(v.float().numpy(), jnp.bfloat16)
              for k, v in batch.items()}
    _, jbr = jax.jit(jts.make_loss_fn(jm.apply, jts.TrainStepConfig(**cfg)))(
        w, jbatch)
    with torch.no_grad():
        br = tts.make_loss_fn(pm, tts.TrainStepConfig(**cfg))(batch)
    assert br.total.dtype == torch.bfloat16
    err = abs(float(br.total) - float(jbr.total)) / abs(float(jbr.total))
    assert err <= TOL_BF16, (float(br.total), float(jbr.total))
    argv = _argv(fields, ["--what", "train", "--batch", "2", "-net", net])
    main(argv + ["--device", "cpu"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["metric"] == f"train_step_{net}_{f['H']}x{f['W']}_B2"
    assert np.isfinite(rec["loss"])


def planted(eng, fault):
    """``eng`` with its energy step halved or skipped (a fault the
    comparison with JAX must catch); ``eng`` itself for None."""
    if fault is None:
        return eng
    step = eng._energy_step

    def energy_step(u, v, T, src, dt=None):
        T_new, dt = step(u, v, T, src, dt)
        if fault == "skip":
            return T, dt
        return (T.float() + 0.5 * (T_new.float() - T.float())).to(
            T.dtype), dt

    eng._energy_step = energy_step
    return eng


@pytest.mark.parametrize("row", ROLLOUT)
def test_rollout_matches_jax(row, capsys):
    fields = ROWS[row][0]
    net = fields["network"]
    f = {**SMALL, **fields}
    H, W = f["H"], f["W"]
    n = 2 if net == "unet" else ENERGY_STEPS
    jm, w, pm, _ = jax_and_port(fields)
    aspect = (W - 2) / (H - 2)
    jgrid = JGrid(H=H, W=W, aspect=aspect, dtype="bfloat16")
    pp = JParams(3.0, 1e8, 10.0)
    jeng = JEngine(grid=jgrid, params=pp, dtype=jnp.bfloat16,
                   stepper=JStepper(grid=jgrid, params=pp,
                                    apply_fn=lambda x: jm.apply(w, x),
                                    net=net, cn_max=0.99,
                                    dtype=jnp.bfloat16))
    grid = Grid(H=H, W=W, aspect=aspect)
    T0 = initial_temperature(grid)
    js0 = jeng.init_state(jnp.asarray(T0, jnp.bfloat16))
    jst, jtr = jax.jit(jeng.multi_step, static_argnums=1)(js0, n)

    def port(fault=None):
        eng = SimEngine(TimeStepper(grid, SimParams(3.0, 1e8, 10.0), pm,
                                    cn_max=0.99, dtype=torch.bfloat16,
                                    device="cpu", net=net))
        s0 = planted(eng, fault).init_state(T0)
        st, tr = eng.multi_step(s0, n)
        return st.T.float() - s0.T.float(), st, tr

    dT, st, tr = port()
    assert st.T.dtype == torch.bfloat16 and jst.T.dtype == jnp.bfloat16
    assert rel_err(tr.t, jtr.t) <= TOL_BF16
    if net == "unet":
        assert rel_err(st.T, jst.T) <= TOL_BF16
    else:
        jdT = jnp.asarray(jst.T, jnp.float32) - jnp.asarray(js0.T,
                                                            jnp.float32)
        assert rel_err(dT, jdT) <= TOL_BF16_DT
        for fault in ("half", "skip"):
            assert rel_err(port(fault)[0], jdT) > TOL_BF16_DT, fault
    main(_argv(fields, ["--what", "rollout", "-net", net])
         + ["--device", "cpu"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["metric"] == f"rollout_steps_per_s_{net}_{H}x{W}"


def test_irregular_transolver_train_step(capsys):
    fields = ROWS["transolver"][0]
    f = {**SMALL, **fields}
    jm, w, pm, _ = jax_and_port(fields)
    batch = train_batch("transolver", 2, f["H"], f["W"], 7, torch.bfloat16,
                        "cpu")
    cfg = dict(net="transolver", p_pred=False, loss_scale=True,
               loss_derivative=True, loss_type="curl")
    jbatch = {k: jnp.asarray(v.float().numpy(), jnp.bfloat16)
              for k, v in batch.items()}
    with pytest.raises(ValueError, match="not enough values to unpack"):
        jts.make_loss_fn(jm.apply, jts.TrainStepConfig(**cfg))(w, jbatch)
    with torch.no_grad():
        br = tts.make_loss_fn(pm, tts.TrainStepConfig(**cfg))(batch)
        br32 = tts.make_loss_fn(pm.float(), tts.TrainStepConfig(**cfg))(
            {k: v.float() for k, v in batch.items()})
    assert br.total.dtype == torch.bfloat16
    assert abs(float(br.total) - float(br32.total)) \
        <= TOL_BF16 * abs(float(br32.total))
    main(_argv(fields, ["--what", "train", "--batch", "2", "-net",
                        "transolver"]) + ["--device", "cpu"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["metric"] == f"train_step_transolver_{f['H']}x{f['W']}_B2"
