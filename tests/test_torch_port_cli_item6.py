"""The rollout CLI on the other models against the JAX CLI, on the CPU:
``python -m ...cli.rollout -m ML_STOKES -raq 3.0 -fkt 1e8 -fkp 10 -l 2
-f 8 -r 1`` with the parser's default ``-s 1`` (the symmetric NewFluidNet
on the module path, as JAX's CLI runs it), with ``-net fluidnet`` and
with ``-net vit`` (the ViT at its ModelConfig defaults, 128×506, one
step), float32 at 128×506, the same weights through each package's
``--nn_dir``: equal run names, byte-equal ``Gaia.ini``, T_vec at rtol
1e-5 and t_vec at 1e-4 (the tolerances of the flagship's CLI test in
tests/test_torch_port_drivers.py: dt follows max |v| of a float32
surrogate).
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from pbml_mantle_convection_tpu.cli import rollout as jcli  # noqa: E402
from pbml_mantle_convection_tpu.models import registry as jreg  # noqa: E402
from pbml_mantle_convection_tpu.utils.checkpoint import (  # noqa: E402
    save_checkpoint as jsave_checkpoint)

from pbml_mantle_convection_tpu_torch.cli import rollout as tcli  # noqa: E402
from pbml_mantle_convection_tpu_torch.train.trainer import LOG_HEADER  # noqa: E402
from pbml_mantle_convection_tpu_torch.utils.checkpoint import (  # noqa: E402
    load_pickle, save_checkpoint)
from pbml_mantle_convection_tpu_torch.utils.flax_convert import (  # noqa: E402
    from_jax_params)


def _pickles(run_dir):
    return {name: load_pickle(os.path.join(run_dir, f"{name}_ML_STOKES.pkl"))
            for name in ("snapshots", "T_vec", "t_vec", "TS_vec")}


def _run_cli(main, cwd, argv, monkeypatch):
    """``main(argv)`` from ``cwd`` with the relative ``--out_dir runs``
    (Gaia.ini names the profile by its path); returns the run directory."""
    os.makedirs(cwd, exist_ok=True)
    monkeypatch.chdir(cwd)
    main(argv + ["--out_dir", "runs"])
    runs = os.listdir(os.path.join(cwd, "runs"))
    assert len(runs) == 1
    return os.path.join(cwd, "runs", runs[0])


# the other models through both CLIs: (flags, ModelConfig of the CLI's
# model, steps); the parser's defaults -s 1 -l 6 -r 4 with -l 2 -r 1
OTHER = {
    "use_symm": ([], dict(network="newfluidnet", use_symm=True), 6),
    "fluidnet": (["-s", "0", "-net", "fluidnet"],
                 dict(network="fluidnet"), 6),
    "vit": (["-s", "0", "-net", "vit"], dict(network="vit"), 1),
}


@pytest.mark.parametrize("name", sorted(OTHER))
def test_rollout_cli_runs_the_other_models(tmp_path, monkeypatch, name):
    """See the module doc; the weights are the JAX registry's model's,
    seeded, written as each package's Trainer checkpoint (epoch 0 of a
    two-line loss log)."""
    flags, mc, steps = OTHER[name]
    cfg = jreg.ModelConfig(levels=2, c_h=8, repeats=1, kernel=5,
                           act_fn="gelu", r_p="learned", loss_type="curl",
                           p_pred=False, dtype=jnp.float32, **mc)
    c_i = cfg.channels[0]
    w = jax.tree.map(np.asarray, jax.jit(jreg.build_model(cfg).init)(
        jax.random.PRNGKey(13), jnp.zeros((1, cfg.H, cfg.W, c_i),
                                          jnp.float32)))
    log = LOG_HEADER + "".join(f"{e},[0.5, 0.4],[0.6, 0.5],0.001\n"
                               for e in range(2))
    dirs = {}
    for pkg in ("jax", "port"):
        d = tmp_path / f"nn_{pkg}"
        d.mkdir()
        (d / "fluidnet_uvpT.txt").write_text(log)
        ckpt = str(d / "0_fluidnet_uvp.ckpt")
        if pkg == "jax":
            jsave_checkpoint(ckpt, {"params": w, "epoch": 0})
        else:
            save_checkpoint(ckpt, {"model": from_jax_params(w), "epoch": 0})
        dirs[pkg] = str(d)
    argv = ["-m", "ML_STOKES", "-raq", "3.0", "-fkt", "1e8", "-fkp", "10",
            "-l", "2", "-f", "8", "-r", "1", "--max_steps", str(steps),
            *flags]
    jrun = _run_cli(jcli.main, str(tmp_path / "jax"),
                    argv + ["--nn_dir", dirs["jax"]], monkeypatch)
    trun = _run_cli(tcli.main, str(tmp_path / "port"),
                    argv + ["--device", "cpu", "--nn_dir", dirs["port"]],
                    monkeypatch)
    assert os.path.basename(trun) == os.path.basename(jrun)
    with open(os.path.join(trun, "Gaia.ini"), "rb") as a, \
            open(os.path.join(jrun, "Gaia.ini"), "rb") as b:
        assert a.read() == b.read()
    got, want = _pickles(trun), _pickles(jrun)
    assert all(type(x) is np.float32 for x in got["T_vec"])
    assert len(got["T_vec"]) == len(want["T_vec"]) == steps
    np.testing.assert_allclose(got["T_vec"], want["T_vec"], rtol=1e-5)
    np.testing.assert_allclose(got["t_vec"], want["t_vec"], rtol=1e-4)
