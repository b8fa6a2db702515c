"""The port's parallel paths (``parallel/``, ``SimEngine`` with a process
group, distributed checkpoints) against the JAX package's, float64 on the
CPU. Multi-rank runs are gloo processes
(``tests/torch_port_parallel_worker.py``), started once per world size:

* sequence-parallel Physics-Attention over 2 and 4 ranks against the
  port's and JAX's ``physics_attention_ref`` and the port's module
  (≤ 1e-12; JAX's own test: tests/test_sequence_parallel.py);
* the per-simulation sharded rollout of a small flagship (the fused
  executor's plain versions) over 2 ranks at local batch 1 and 2, against
  per-simulation B = 1 runs (≤ 1e-12) and JAX's ``rollout_batch_sharded``
  on its 8-device CPU mesh (rtol 1e-10, the golden rollout's tolerance);
* the coupled batch-sharded rollout over 2 ranks against the
  single-process batched run and JAX's jit over a batch-sharded state;
* the reusable callable and the divisibility error;
* a distributed-checkpoint round trip in one process and over 2 ranks;
* the dry run's four lines.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from pbml_mantle_convection_tpu.constants import SimParams as JParams  # noqa: E402
from pbml_mantle_convection_tpu.models import (  # noqa: E402
    NewFluidNet as JNewFluidNet,
    PhysicsAttentionIrregularMesh as JAttention)
from pbml_mantle_convection_tpu.parallel.mesh import (  # noqa: E402
    batch_sharding, make_mesh as jax_mesh)
from pbml_mantle_convection_tpu.parallel import rollout as jax_rollout  # noqa: E402
from pbml_mantle_convection_tpu.parallel.sequence import (  # noqa: E402
    physics_attention_ref as jax_attention_ref)
from pbml_mantle_convection_tpu.sim.engine import SimEngine as JEngine  # noqa: E402
from pbml_mantle_convection_tpu.sim.grid import Grid as JGrid  # noqa: E402
from pbml_mantle_convection_tpu.sim.stepper import TimeStepper as JStepper  # noqa: E402

from pbml_mantle_convection_tpu_torch.cli.benchmark import (  # noqa: E402
    initial_temperature)
from pbml_mantle_convection_tpu_torch.models.transolver import (  # noqa: E402
    PhysicsAttentionIrregularMesh)
from pbml_mantle_convection_tpu_torch.parallel import dryrun  # noqa: E402
from pbml_mantle_convection_tpu_torch.parallel.rollout import (  # noqa: E402
    make_batch_sharded, rollout_batch_sharded)
from pbml_mantle_convection_tpu_torch.parallel.sequence import (  # noqa: E402
    physics_attention_ref, physics_attention_sharded)
from pbml_mantle_convection_tpu_torch.sim.grid import Grid  # noqa: E402
from pbml_mantle_convection_tpu_torch.utils.checkpoint import (  # noqa: E402
    restore_checkpoint_distributed, save_checkpoint_distributed)
from pbml_mantle_convection_tpu_torch.utils.flax_convert import (  # noqa: E402
    from_jax_params)

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import torch_port_parallel_worker as worker  # noqa: E402

H, W, STEPS = worker.H, worker.W, worker.STEPS
B_JAX = 8       # JAX's mesh: 8 CPU devices


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.fixture(scope="module")
def inputs():
    """The JAX modules' weights carried into the port, the points and the
    CLI's phase-shifted initial fields (B = 8)."""
    ja = JAttention(dim=16, heads=2, dim_head=8, slice_num=4)
    x = jnp.asarray(np.random.default_rng(1).normal(size=(1, 128, 16)))
    wa = ja.init(jax.random.PRNGKey(0), x)
    jm = JNewFluidNet(**worker.NFN)
    wn = jax.jit(jm.init)(jax.random.PRNGKey(0),
                          jnp.zeros((1, H, W, 7), jnp.float64))
    grid = Grid(H=H, W=W, aspect=(W - 2) / (H - 2))
    return {
        "jax": (ja, wa, jm, wn),
        "attn": from_jax_params(jax.tree.map(np.asarray, wa)),
        "x_attn": torch.as_tensor(np.asarray(x)),
        "net": from_jax_params(jax.tree.map(np.asarray, wn)),
        "T0": torch.as_tensor(initial_temperature(grid, B_JAX)),
    }


def _run_ranks(inputs, world, tmp):
    torch.save({k: v for k, v in inputs.items() if k != "jax"},
               os.path.join(tmp, "inputs.pt"))
    port = _free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_port_parallel_worker.py"),
         str(r), str(world), str(port), str(tmp)], env=env)
        for r in range(world)]
    try:
        codes = [p.wait(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert codes == [0] * world
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=True)
            for r in range(world)]


@pytest.fixture(scope="module")
def two_ranks(inputs, tmp_path_factory):
    return _run_ranks(inputs, 2, tmp_path_factory.mktemp("ranks2"))


@pytest.fixture(scope="module")
def four_ranks(inputs, tmp_path_factory):
    return _run_ranks(inputs, 4, tmp_path_factory.mktemp("ranks4"))


@pytest.fixture(scope="module")
def jax_engine(inputs):
    _, _, jm, wn = inputs["jax"]
    jgrid = JGrid(H=H, W=W, aspect=(W - 2) / (H - 2), dtype="float64")
    pp = JParams(3.0, 1e8, 10.0)
    return JEngine(grid=jgrid, params=pp, dtype=jnp.float64,
                   stepper=JStepper(grid=jgrid, params=pp,
                                    apply_fn=lambda x: jm.apply(wn, x),
                                    net="newfluidnet", cn_max=0.99,
                                    dtype=jnp.float64))


def _module(inputs):
    m = PhysicsAttentionIrregularMesh(16, np.random.default_rng(0),
                                      **worker.ATTN)
    m.double().load_state_dict(inputs["attn"])
    return m


def test_attention_ref_matches_jax_and_the_module(inputs):
    ja, wa, _, _ = inputs["jax"]
    m, x = _module(inputs), inputs["x_attn"]
    with torch.no_grad():
        ref = physics_attention_ref(m, x, 2, 8)
        assert _rel(ref, m(x)) <= 1e-12
        assert _rel(physics_attention_ref(m.state_dict(), x, 2, 8),
                    ref) == 0.0
        # one rank alone, no group: the kernels' wrappers (plain on CPU)
        assert _rel(physics_attention_sharded(m, x, None, 2, 8), ref) \
            <= 1e-12
    want = jax_attention_ref(wa, jnp.asarray(x.numpy()), heads=2,
                             dim_head=8)
    assert _rel(ref, want) <= 1e-12


def test_attention_refuses_autograd(inputs):
    m, x = _module(inputs), inputs["x_attn"]
    with pytest.raises(RuntimeError, match="requires grad"):
        physics_attention_sharded(m, x, None, 2, 8)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_attention_matches_the_reference(inputs, world, request):
    ranks = request.getfixturevalue(
        {2: "two_ranks", 4: "four_ranks"}[world])
    ja, wa, _, _ = inputs["jax"]
    m, x = _module(inputs), inputs["x_attn"]
    with torch.no_grad():
        ref = physics_attention_ref(m, x, 2, 8)
    want = jax_attention_ref(wa, jnp.asarray(x.numpy()), heads=2,
                             dim_head=8)
    for r in ranks:
        assert r["attention"].shape == x.shape
        assert _rel(r["attention"], ref) <= 1e-12
        assert _rel(r["attention"], want) <= 1e-12


def _per_sim_runs(inputs, n):
    eng = worker.flagship_engine(inputs)
    out = []
    for b in range(n):
        st, tr = eng.multi_step(eng.init_state(inputs["T0"][b:b + 1]), STEPS)
        out.append((st.T[0], st.t, tr.mean_T))
    return out


@pytest.mark.parametrize("key,B", [("per_sim_b2", 2), ("per_sim_b4", 4)])
def test_per_sim_rollout_matches_b1_runs_and_jax(inputs, two_ranks,
                                                 jax_engine, key, B):
    """Two ranks at local batch 1 and 2: every simulation equals its own
    B = 1 run and JAX's shard_map rollout (one simulation per device of
    its 8-device mesh), on both ranks."""
    runs = _per_sim_runs(inputs, B)
    jout = jax_rollout.rollout_batch_sharded(
        jax_engine, jnp.asarray(inputs["T0"].numpy()), STEPS, jax_mesh(8))
    for r in two_ranks:
        out = r[key]
        assert out["T"].shape == (B, H, W) and out["t"].shape == (B,)
        assert out["mean_T"].shape == (STEPS, B)
        for b, (T, t, mean_T) in enumerate(runs):
            assert _rel(out["T"][b], T) <= 1e-12
            assert _rel(out["t"][b], t) <= 1e-12
            assert _rel(out["mean_T"][:, b], mean_T) <= 1e-12
        np.testing.assert_allclose(out["T"], np.asarray(jout.T)[:B],
                                   rtol=1e-10)
        np.testing.assert_allclose(out["t"], np.asarray(jout.t)[:B],
                                   rtol=1e-10)
        np.testing.assert_allclose(out["mean_T"],
                                   np.asarray(jout.mean_T)[:, :B],
                                   rtol=1e-10)


def test_coupled_rollout_matches_the_batch_and_jax(inputs, two_ranks,
                                                   jax_engine):
    """B = 8 over two ranks (local batch 4) with one dt over the ranks:
    the single-process batched rollout's trajectory, and JAX's jit of
    ``multi_step`` over the batch-sharded state on its 8 devices."""
    eng = worker.flagship_engine(inputs)
    st, tr = eng.multi_step(eng.init_state(inputs["T0"]), STEPS)
    jst = jax_engine.init_state(jnp.asarray(inputs["T0"].numpy()))
    sh = batch_sharding(jax_mesh(8))
    jst = jst._replace(**{f: jax.device_put(getattr(jst, f), sh)
                          for f in ("T", "u", "v", "p", "V")})
    jst, jtr = jax.jit(jax_engine.multi_step, static_argnums=1)(jst, STEPS)
    assert len(jst.T.sharding.device_set) == 8
    for r in two_ranks:
        c = r["coupled"]
        assert _rel(c["T"], st.T) <= 1e-12
        assert _rel(c["dt"], tr.dt) <= 1e-12
        assert _rel(c["mean_T"], tr.mean_T) <= 1e-12
        np.testing.assert_allclose(c["T"], np.asarray(jst.T), rtol=1e-10)
        np.testing.assert_allclose(c["dt"], np.asarray(jtr.dt), rtol=1e-10)
        np.testing.assert_allclose(c["mean_T"], np.asarray(jtr.mean_T),
                                   rtol=1e-10)
    assert torch.equal(two_ranks[0]["coupled"]["T"],
                       two_ranks[1]["coupled"]["T"])


def test_make_batch_sharded_is_reusable(inputs):
    """One callable for the warm-up and the timed call (a world of one
    process), equal to the one-shot wrapper."""
    eng = worker.flagship_engine(inputs)
    grid = Grid(H=H, W=W, aspect=(W - 2) / (H - 2))
    f = make_batch_sharded(eng, 3, None)
    f(initial_temperature(grid, 2, 0.11))
    out = f(inputs["T0"][:2])
    ref = rollout_batch_sharded(eng, inputs["T0"][:2], 3, None)
    assert torch.equal(out[0], ref.T) and torch.equal(out[7], ref.mean_T)
    assert out[7].shape == (3, 2)


def test_refusals(two_ranks):
    """3 rows over 2 ranks, and a coupled engine (one with a process
    group) handed to the per-simulation rollout."""
    for r in two_ranks:
        assert r["not_divisible"] == "batch 3 not divisible by mesh size 2"
        assert "process group" in r["coupled_refused"]


def test_checkpoint_round_trip_one_process(inputs, tmp_path):
    net = {k: v.clone() for k, v in inputs["net"].items()}
    state = {"model": net, "epoch": 7,
             "optimizer": {"state": {0: {"step": torch.tensor(3.0)}},
                           "param_groups": [{"lr": 1e-3, "params": [0]}]}}
    path = str(tmp_path / "ck")
    save_checkpoint_distributed(path, state)
    save_checkpoint_distributed(path, state)        # replaces it
    got = restore_checkpoint_distributed(path)
    assert got["epoch"] == 7
    assert got["optimizer"]["param_groups"] == [{"lr": 1e-3, "params": [0]}]
    assert torch.equal(got["optimizer"]["state"]["0"]["step"],
                       torch.tensor(3.0))
    for k, v in net.items():
        assert torch.equal(got["model"][k], v) and got["model"][k].dtype \
            == v.dtype
    # into a target: its structure and dtypes
    target = {"model": {k: torch.zeros_like(v, dtype=torch.float32)
                        for k, v in net.items()}, "epoch": 0,
              "optimizer": {"state": {0: {"step": torch.tensor(0.0)}},
                            "param_groups": [{"lr": 0.0, "params": [0]}]}}
    got = restore_checkpoint_distributed(path, target)
    assert got is target and got["epoch"] == 7
    assert got["optimizer"]["state"][0]["step"] == 3.0
    for k, v in net.items():
        assert got["model"][k].dtype == torch.float32
        assert torch.equal(got["model"][k], v.float())


def test_checkpoint_round_trip_two_ranks(inputs, two_ranks):
    for r in two_ranks:
        got = r["restored"]
        assert got["epoch"] == 3 and got["rank_lr"] == [1e-3]
        for k, v in inputs["net"].items():
            assert torch.equal(got["model"][k], v)


def test_dryrun_prints_four_lines(capsys):
    lines = dryrun.run(2)
    assert len(lines) == 4
    assert all(ln.startswith("dryrun_multichip(2): ") for ln in lines)
    assert "sequence-parallel attention ok (1, 16, 16)" in lines[1]
    assert "devices=2" in lines[2] and "devices=2" in lines[3]
    assert capsys.readouterr().out.splitlines()[-4:] == lines


def test_mesh_of_one_process(monkeypatch):
    """No launcher world: no process group, a mesh of None, every helper
    the identity on one rank."""
    from pbml_mantle_convection_tpu_torch.parallel import mesh
    for name in ("WORLD_SIZE", "SLURM_NTASKS"):
        monkeypatch.delenv(name, raising=False)
    assert mesh.maybe_initialize_distributed("cpu") is False
    assert mesh.make_mesh() is None
    assert mesh.mesh_size(None) == 1 and mesh.mesh_rank(None) == 0
    with pytest.raises(ValueError, match="a mesh of 2 devices in a world "
                                         "of 1"):
        mesh.make_mesh(2)
    x = torch.arange(6.0).reshape(3, 2)
    assert torch.equal(mesh.shard_batch(None, {"x": x})["x"], x)
    assert mesh.shard_host_local_batch(None, x) is x
    assert mesh.gather_rows(None, x) is x
    assert mesh.batch_sharding()[0].dim == 0
    assert mesh.replicated_sharding()[0].is_replicate()
    # the caller's card, its index kept (--device cuda:1 runs on cuda:1)
    assert mesh.local_device("cuda:1") == torch.device("cuda", 1)
    assert mesh.local_device("cuda") == torch.device("cuda")
    assert mesh.local_device("cpu") == torch.device("cpu")


def test_local_device_under_a_launchers_world(monkeypatch):
    """Under torchrun's (or SLURM's) world each rank binds the card of its
    LOCAL_RANK, whatever index the caller named; the CPU stays the CPU."""
    from pbml_mantle_convection_tpu_torch.parallel import mesh
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert mesh.local_device("cuda") == torch.device("cuda", 1)
    assert mesh.local_device("cuda:0") == torch.device("cuda", 1)
    assert mesh.local_device("cpu") == torch.device("cpu")
    monkeypatch.delenv("WORLD_SIZE")
    monkeypatch.delenv("LOCAL_RANK")
    monkeypatch.setenv("SLURM_NTASKS", "4")
    monkeypatch.setenv("SLURM_LOCALID", "3")
    assert mesh.local_device("cuda:1") == torch.device("cuda", 3)


def test_coupled_engine_refuses_the_pt_modes(inputs):
    """GAIA and ML_PRE check their PT solve's residual per rank: over a
    process group they would part from the single-process batch."""
    from pbml_mantle_convection_tpu_torch.sim.engine import SimEngine
    stepper = worker.flagship_engine(inputs).stepper
    for mode in ("GAIA", "ML_PRE"):
        with pytest.raises(ValueError, match="PT solve"):
            SimEngine(stepper, mode=mode, stokes_fn=lambda *a: None,
                      process_group=object())
