"""The port's benchmark script (``bench_torch.py``) and its 500-step
accuracy tool (``tools/torch_port_accuracy.py``) on the CPU:

1. ``bench_torch.main(["--device", "cpu"])`` at 96×96 (the smallest grid
   the flagship's five levels take) prints one JSON line with the port's
   metric name, the card keys and the launch counts (0 on the CPU, where
   each stage runs its plain version), after driving 4 + 1 + 1 fused
   stage calls per step;
2. the accuracy tool's float64 leg, with JAX weights converted by
   ``from_jax_params``, equals the JAX engine's float64 trajectory at
   rtol 1e-10 (20×28, levels 2, c_h 8, repeats 1, 10 steps), and takes
   the energy step's plain version, never the kernel wrapper;
3. its T_rmse and trace_mae equal a numpy transcription of
   tools/tpu_accuracy.py:193-195 on the same arrays;
4. both refuse to run without a card unless told ``--device cpu``.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _load(rel):
    spec = importlib.util.spec_from_file_location(
        Path(rel).stem, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


bench_torch = _load("bench_torch.py")
acc = _load("tools/torch_port_accuracy.py")

SMALL = dict(levels=2, c_i=7, c_h=8, c_o=1, act_fn="gelu", r_p="learned",
             loss_type="curl", repeats=1, f=5, p_pred=False)


def test_bench_torch_on_the_cpu(capsys, monkeypatch):
    from pbml_mantle_convection_tpu_torch.models import fast_path
    from pbml_mantle_convection_tpu_torch.sim import engine as engine_mod
    calls = {"layer_stack": 0, "layer_stacks": 0, "trunk": 0,
             "curl_advect_epilogue": 0}

    def counted(mod, name):
        fn = getattr(mod, name)

        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        monkeypatch.setattr(mod, name, wrapper)

    for name in ("layer_stack", "layer_stacks", "trunk"):
        counted(fast_path, name)
    counted(engine_mod, "curl_advect_epilogue")
    monkeypatch.setenv("PMC_BENCH_H", "96")
    monkeypatch.setenv("PMC_BENCH_W", "96")
    rec = bench_torch.main(["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == rec
    assert rec["metric"] == "torch_coupled_rollout_steps_per_s_96x96"
    assert rec["unit"] == "steps/s" and rec["value"] > 0
    assert "vs_baseline" not in rec
    assert rec["device"] == "cpu" and rec["power_limit"] is None
    assert (rec["warmup_steps"], rec["steps"], rec["reps"]) == (4, 10, 3)
    assert rec["launches_per_step"] == {
        "layer_stack": 0, "trunk": 0, "curl_advect_epilogue": 0,
        "advect_diffuse_step_fused": 0}
    steps = 4 + 3 * 10
    # stem, merges 2 and 3; the grouped branches; the trunk; the epilogue
    assert calls == {"layer_stack": 3 * steps, "layer_stacks": steps,
                     "trunk": steps, "curl_advect_epilogue": steps}


@pytest.mark.parametrize("run", [lambda: bench_torch.main([]),
                                 lambda: acc.main(["--steps", "1"])],
                         ids=["bench_torch", "torch_port_accuracy"])
def test_needs_a_card_unless_told_cpu(run):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="--device cpu"):
        run()


def _jax_trajectory(H, W, steps, seed=42):
    """The JAX engine over the module in float64 at the tool's
    configuration; returns (weights, final T, mean-T trace)."""
    from pbml_mantle_convection_tpu.constants import SimParams as JParams
    from pbml_mantle_convection_tpu.models import NewFluidNet as JNewFluidNet
    from pbml_mantle_convection_tpu.sim.engine import SimEngine as JEngine
    from pbml_mantle_convection_tpu.sim.grid import Grid as JGrid
    from pbml_mantle_convection_tpu.sim.stepper import (
        TimeStepper as JStepper)
    jm = JNewFluidNet(**SMALL)
    w = jax.jit(jm.init)(jax.random.PRNGKey(seed),
                         jnp.zeros((1, H, W, 7), jnp.float64))
    jgrid = JGrid(H=H, W=W, aspect=(W - 2) / (H - 2), dtype="float64")
    pp = JParams(3.0, 1e8, 10.0)
    jeng = JEngine(grid=jgrid, params=pp, dtype=jnp.float64,
                   stepper=JStepper(grid=jgrid, params=pp,
                                    apply_fn=lambda x: jm.apply(w, x),
                                    cn_max=0.99, dtype=jnp.float64))
    T0 = jnp.clip(1.0 - jgrid.yc + 0.05 * jnp.sin(6.28 * jgrid.xc), 0, 1)
    st, tr = jax.jit(jeng.multi_step, static_argnums=1)(
        jeng.init_state(T0[None]), steps)
    return w, np.asarray(st.T), np.asarray(tr.mean_T)


def test_f64_leg_is_the_jax_engines_trajectory():
    from pbml_mantle_convection_tpu_torch.utils.flax_convert import (
        from_jax_params)
    H, W, steps = 20, 28, 10
    w, T_ref, mean_ref = _jax_trajectory(H, W, steps)
    sd = from_jax_params(jax.tree.map(np.asarray, w))
    got = acc.reference(sd, H, W, steps, device="cpu", arch=SMALL)
    assert got["T"].shape == (1, H, W) and got["mean_T"].shape == (steps,)
    assert got["seconds"] > 0
    np.testing.assert_allclose(got["T"], T_ref, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(got["mean_T"], mean_ref, rtol=1e-10)


@pytest.mark.parametrize("mode", sorted(acc.MODES))
def test_f64_leg_takes_the_plain_energy_step(mode, monkeypatch):
    from pbml_mantle_convection_tpu_torch.sim import engine as engine_mod
    from pbml_mantle_convection_tpu_torch.sim import stepper as stepper_mod
    calls = []
    for mod in (stepper_mod, engine_mod):
        fn = mod.advect_diffuse_step_fused

        def counted(*a, fn=fn, **k):
            calls.append(1)
            return fn(*a, **k)
        monkeypatch.setattr(mod, "advect_diffuse_step_fused", counted)
    sd = acc.flagship_weights(0, SMALL)
    kw = dict(mode=mode, device="cpu", arch=SMALL)
    ref = acc.reference(sd, 20, 28, 3, **kw)
    assert calls == [] and np.isfinite(ref["T"]).all()
    # the float32 legs go through the wrapper, one call per step
    acc.rollout(sd, 20, 28, 3, dtype=torch.float32, **kw)
    assert len(calls) == 2 + 3


@pytest.mark.parametrize("mode", sorted(acc.MODES))
def test_metrics_are_tpu_accuracys(mode):
    H, W, steps = 20, 28, 5
    sd = acc.flagship_weights(0, SMALL)
    kw = dict(mode=mode, device="cpu", arch=SMALL)
    ref = acc.reference(sd, H, W, steps, **kw)
    got = acc.rollout(sd, H, W, steps, path="fused", dtype=torch.float32,
                      **kw)
    # tools/tpu_accuracy.py:193-195
    T = np.asarray(got["T"], np.float64)
    rmse = float(np.sqrt(np.mean((T - ref["T"]) ** 2)))
    tmae = float(np.mean(np.abs(np.asarray(got["mean_T"], np.float64)
                                - ref["mean_T"])))
    e = acc.errors(got["T"], got["mean_T"], ref["T"], ref["mean_T"])
    assert e == {"T_rmse": rmse, "trace_mae": tmae}
    assert 0 < rmse < 1e-3 and 0 < tmae < 1e-3

    rec = acc.measure(sd, H, W, steps, mode, device="cpu", arch=SMALL)
    assert (rec["grid"], rec["mode"], rec["steps"]) == ("20x28", mode, 5)
    assert rec["device"] == "cpu" and rec["power_limit"] is None
    assert rec["f64_seconds"] > 0
    assert rec["fused"]["T_rmse"] == rmse          # same start, same path
    # the CPU launches no kernel
    no_launch = {k: 0 for k in bench_torch.LAUNCHES_PER_STEP}
    assert rec["f64_launches_per_step"] == no_launch
    for name in acc.MODE_VARIANTS[mode]:
        assert set(rec[name]) == {"T_rmse", "trace_mae", "steps_per_s",
                                  "launches_per_step"}
        assert rec[name]["launches_per_step"] == no_launch
    if mode == "ML_STOKES":
        # the CPU has no TF32: the flag changes nothing there
        assert rec["module_tf32"]["T_rmse"] == rec["module_f32"]["T_rmse"]


def test_tf32_convs_lifts_the_guard_inside_only():
    from pbml_mantle_convection_tpu_torch.models import layers
    guard = layers.float32_convs
    cudnn = torch.backends.cudnn
    old = cudnn.allow_tf32
    cudnn.allow_tf32 = False
    try:
        with acc.tf32_convs():
            assert cudnn.allow_tf32 is True
            assert layers.float32_convs is not guard
        assert cudnn.allow_tf32 is False
        assert layers.float32_convs is guard
    finally:
        cudnn.allow_tf32 = old
