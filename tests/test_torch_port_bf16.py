"""``--dtype bfloat16``: the port against the JAX package, one case per
combination of the JAX CLI, on the CPU at small sizes.

Where the JAX CLI runs, the JAX module's bfloat16 weights are carried
into the port (``utils/flax_convert.py``: every leaf in its own type,
which the port's parameter must share) and the forwards agree within
``TOL_BF16`` of the largest JAX output; the port's CLI then runs the same
combination. Where the JAX CLI fails, both CLIs raise, the port's message
quoting JAX's. The U-Net runs at a size where float32 runs too (the
CLI's defaults fail in float32 as well).
"""

import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from pbml_mantle_convection_tpu.cli.benchmark import main as jax_main  # noqa: E402
from pbml_mantle_convection_tpu.models.fast_path import (  # noqa: E402
    FastNewFluidNet as JFast)
from pbml_mantle_convection_tpu.models.registry import (  # noqa: E402
    ModelConfig as JConfig, build_model as jax_build)

from pbml_mantle_convection_tpu_torch.cli.benchmark import main  # noqa: E402
from pbml_mantle_convection_tpu_torch.models.fast_path import (  # noqa: E402
    FastNewFluidNet)
from pbml_mantle_convection_tpu_torch.models.registry import (  # noqa: E402
    ModelConfig, build_model)
from pbml_mantle_convection_tpu_torch.utils.flax_convert import (  # noqa: E402
    from_jax_params)

# bfloat16 keeps 8 bits: 2^-8 ≈ 3.9e-3 per rounding; a few layers of
# roundings in another order (cuDNN/oneDNN vs XLA sums, GroupNorm and
# LayerNorm statistics) land the outputs up to ~2e-2 apart (measured
# 5e-3 to 1.8e-2 of the largest output at these sizes)
TOL_BF16 = 4e-2

SMALL = dict(levels=2, c_h=8, repeats=1, kernel=5, r_p="learned",
             H=16, W=24, n_hidden=32, n_layers=2)
ROWS = {
    "raw_module": (dict(network="newfluidnet"),
                   ["--what", "inference", "--raw-module"]),
    "zeros": (dict(network="newfluidnet", r_p="zeros"),
              ["--what", "inference", "-pad", "zeros"]),
    "fluidnet": (dict(network="fluidnet"),
                 ["--what", "inference", "-net", "fluidnet"]),
    "transolver": (dict(network="transolver"),
                   ["--what", "inference", "-net", "transolver"]),
    "transolver_structured": (
        dict(network="transolver_structured"),
        ["--what", "inference", "-net", "transolver_structured"]),
    "vit": (dict(network="vit"),
            ["--what", "inference", "-net", "vit"]),
    # two members (the CLI's four in its run): JAX compiles each
    "ensemble": (dict(network="multiscalenewfluidnet",
                      multi_scales=(1e-3, 1e-1)),
                 ["--what", "inference", "-net", "multiscalenewfluidnet"]),
    "unet": (dict(network="unet", r_p="replicate", kernel=3, c_h=4),
             ["--what", "inference", "-net", "unet"]),
}


def _argv(fields, extra):
    f = {**SMALL, **fields}
    return extra + ["-l", str(f["levels"]), "-f", str(f["c_h"]), "-r",
                    str(f["repeats"]), "-k", str(f["kernel"]), "-pad",
                    f["r_p"], "--H", str(f["H"]), "--W", str(f["W"]),
                    "--iters", "1", "--steps", "1", "--dtype", "bfloat16"]


def jax_and_port(fields, seed=0):
    """The JAX model in bfloat16 with its weights, and the port's model
    with them, plus a seeded bfloat16 input of the CLI's shape."""
    f = {**SMALL, "loss_type": "curl", "p_pred": False, **fields}
    jm = jax_build(JConfig(**f, dtype=jnp.bfloat16))
    c_i, _ = JConfig(**f).channels
    shape = ((1, f["H"] * f["W"], c_i) if "transolver" in f["network"]
             else (1, f["H"], f["W"], c_i))
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    w = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x, jnp.bfloat16))
    pm = build_model(ModelConfig(**f, dtype=torch.bfloat16), device="cpu")
    sd = from_jax_params(jax.tree.map(np.asarray, w))
    own = pm.state_dict()
    assert sorted(own) == sorted(sd)
    for k, v in sd.items():
        assert own[k].dtype == v.dtype, (k, own[k].dtype, v.dtype)
    pm.load_state_dict(sd)
    return jm, w, pm, x


def rel_err(got, want) -> float:
    got = np.asarray(torch.as_tensor(got).float())
    want = np.asarray(jnp.asarray(want, jnp.float32))
    return float(np.abs(got - want).max() / np.abs(want).max())


def _outputs(out):
    return [o for o in (out if isinstance(out, tuple) else (out,))
            if o is not None]


@pytest.mark.parametrize("row", sorted(ROWS))
def test_runs_where_jax_runs(row, capsys):
    fields, extra = ROWS[row]
    jm, w, pm, x = jax_and_port(fields)
    xb = jnp.asarray(x, jnp.bfloat16)
    xt = torch.as_tensor(x).to(torch.bfloat16)
    want_dtype, got_dtype = jnp.bfloat16, torch.bfloat16
    fwd = pm
    if row == "zeros":
        # JAX's fused executor in bfloat16, whose float32 constants
        # promote its outputs to float32 (what fails its rollout); the
        # port's CLI runs its executor on float32 copies of the weights
        f = {**SMALL, **fields}
        want = JFast(jm, w, f["H"], f["W"])(xb)
        want_dtype, got_dtype = jnp.float32, torch.float32
        fwd, xt = FastNewFluidNet.float32_of(pm, f["H"], f["W"]), xt.float()
    else:
        want = jax.jit(jm.apply)(w, xb)
    with torch.no_grad():
        got = fwd(xt)
    want, got = _outputs(want), _outputs(got)
    assert len(got) == len(want)
    for g, wt in zip(got, want):
        assert g.dtype == got_dtype and g.shape == wt.shape
        assert wt.dtype == want_dtype
        assert rel_err(g, wt) <= TOL_BF16
    main(_argv(fields, extra) + ["--device", "cpu"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["metric"].startswith(
        f"inference_latency_{fields['network']}_")
    assert np.isfinite(rec["value"])


@pytest.mark.parametrize("extra,reason", [
    (["--what", "inference"],
     "requires arguments to have the same dtypes, got float32, bfloat16"),
    (["--what", "rollout"],
     "requires arguments to have the same dtypes, got float32, bfloat16"),
    (["--what", "rollout", "-pad", "zeros"],
     "carry input and carry output must have equal types"),
])
def test_raises_where_jax_raises(extra, reason):
    """The fused executor in bfloat16 (learned padding: inference and
    rollout) and its zero-padded rollout: JAX's CLI fails with a
    TypeError, and the port's refuses first with JAX's reason."""
    argv = _argv({"network": "newfluidnet"}, extra)
    if "zeros" in extra:
        argv[argv.index("learned")] = "zeros"
    with pytest.raises(TypeError, match=reason):
        jax_main(argv)
    with pytest.raises(TypeError, match=reason):
        main(argv + ["--device", "cpu"])
