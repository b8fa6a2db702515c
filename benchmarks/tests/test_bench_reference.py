"""The plain reference against the program's plain path (its modules and
the CPU versions of its kernels) at a tiny size, in float64 on the CPU."""

import numpy as np
import pytest
import torch

from benchmarks.harness.weights import make_weights
from benchmarks.models import newfluidnet, transolver
from benchmarks.reference import fluidnet as ref_net
from benchmarks.reference import physics as ref
from benchmarks.reference import train as ref_train
from benchmarks.reference import transolver as ref_tr

F64 = torch.float64
SMALL = dict(network="newfluidnet", levels=3, c_h=16, repeats=2, kernel=5,
             r_p="learned", act_fn="gelu", loss_type="curl", p_pred=False,
             a_bound=10.0, factor=2)
H, W = 32, 40
ASPECT = (W - 2) / (H - 2)
PARAMS = (3.0, 1e8, 10.0)


def flagship(seed=3):
    from pbml_mantle_convection_tpu_torch.models.registry import (
        ModelConfig, build_model)
    model = build_model(ModelConfig(**SMALL, H=H, W=W, dtype=F64),
                        device="cpu")
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    w = make_weights(shapes, newfluidnet.weight_rule, seed, "cpu", F64)
    model.load_state_dict(w, strict=False)
    return model, w


def field(seed=0):
    xc, yc = ref.grid_coords(H, W, ASPECT)
    rng = np.random.default_rng(seed)
    T = np.clip(1 - yc + 0.05 * np.sin(6.28 * xc + rng.uniform(0, 6))
                + 0.01 * rng.standard_normal((H, W)), 0, 1)
    return torch.as_tensor(T[None], dtype=F64), xc, yc


def close(a, b, tol=1e-10):
    a, b = torch.as_tensor(a, dtype=F64), torch.as_tensor(b, dtype=F64)
    assert float((a - b).abs().max()) <= tol * max(1.0, float(b.abs().max()))


def test_input_assembly_and_viscosity():
    from pbml_mantle_convection_tpu_torch.constants import SimParams
    from pbml_mantle_convection_tpu_torch.sim.grid import Grid
    from pbml_mantle_convection_tpu_torch.sim.stepper import (
        assemble_fluidnet_input, make_static_fields)
    T, xc, yc = field()
    static = make_static_fields(Grid(H, W, ASPECT), SimParams(*PARAMS), F64,
                                "cpu")
    x_p, V_p = assemble_fluidnet_input(T, static, SimParams(*PARAMS))
    x_r, V_r = ref.fluidnet_input(T, torch.as_tensor(xc),
                                  torch.as_tensor(yc), *PARAMS)
    close(x_p, x_r)
    close(V_p, V_r)
    from pbml_mantle_convection_tpu_torch.constants import velocity_scaler
    assert ref.velocity_scaler(*PARAMS) == pytest.approx(
        float(velocity_scaler(*PARAMS)), rel=1e-14)


def test_newfluidnet_forward():
    model, w = flagship()
    T, xc, yc = field(1)
    x, _ = ref.fluidnet_input(T, torch.as_tensor(xc), torch.as_tensor(yc),
                              *PARAMS)
    with torch.no_grad():
        u_p, v_p, _ = model(x)
    u_r, v_r = ref_net.forward(x, w, SMALL)
    close(u_p, u_r)
    close(v_p, v_r)


def test_energy_step():
    from pbml_mantle_convection_tpu_torch.ops.advect_kernel import \
        advect_diffuse_step_plain
    from pbml_mantle_convection_tpu_torch.ops.stencils import \
        stamp_temperature_bc
    from pbml_mantle_convection_tpu_torch.physics.advection import \
        grid_metrics
    T, xc, yc = field(2)
    g = torch.Generator().manual_seed(0)
    u = 300 * torch.randn(1, H, W, generator=g, dtype=F64)
    v = 300 * torch.randn(1, H, W, generator=g, dtype=F64)
    xt, yt = torch.as_tensor(xc), torch.as_tensor(yc)
    T_p, dt_p = advect_diffuse_step_plain(
        u, v, T, 3.0, grid_metrics(xt, yt, ASPECT), cn_max=0.99)
    T_p = torch.clamp(stamp_temperature_bc(T_p), 0, 2)
    T_r, dt_r = ref.energy_step(u, v, T, 3.0, ref.metrics(xt, yt, ASPECT),
                                0.99)
    close(T_p, T_r)
    close(dt_p, dt_r)


def test_pt_solve():
    from pbml_mantle_convection_tpu_torch.physics.stokes import \
        PTStokesSolver
    T, xc, yc = field(3)
    V = ref.fk_viscosity(1e8, 10.0, 1.0 - torch.as_tensor(yc), T)
    g = torch.Generator().manual_seed(1)
    u0, v0, p0 = (torch.randn(1, H, W, generator=g, dtype=F64)
                  for _ in range(3))
    solver = PTStokesSolver(ny=H - 2, nx=W - 2, dy=1 / (H - 2),
                            dx=ASPECT / (W - 2), raq=3.0, ptol=0.0)
    r = solver.solve(T[..., 1:-1, 1:-1], V[..., 1:-1, 1:-1],
                     u0=u0[..., 1:-1, 1:-1], v0=v0[..., 1:-1, 1:-1],
                     p0=p0[..., 1:-1, 1:-1], n_iter=30)
    u, v, p = ref.pt_stokes(T, V, u0, v0, p0, 3.0, 1 / (H - 2),
                            ASPECT / (W - 2), 30)
    for a, b in ((r.u, u), (r.v, v), (r.p, p)):
        close(a, b)


def test_transolver_forward():
    from pbml_mantle_convection_tpu_torch.models.registry import (
        ModelConfig, build_model)
    cfg = {"model": dict(network="transolver_structured", n_layers=2,
                         n_hidden=32, n_head=4, slice_num=8, mlp_ratio=1,
                         loss_type="curl", p_pred=False, a_bound=10.0),
           "grid": {"H": 12, "W": 14}}
    model = build_model(ModelConfig(**cfg["model"], H=12, W=14, dtype=F64),
                        device="cpu")
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    w = make_weights(shapes, transolver.weight_rule, 5, "cpu", F64)
    model.load_state_dict(w, strict=False)
    x = torch.rand(2, 12 * 14, 7, dtype=F64,
                   generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        u_p, v_p, _ = model(x)
    u_r, v_r = ref_tr.forward(x, w, transolver.dims(cfg))
    close(u_p, u_r)
    close(v_p, v_r)


def test_batch_loss_and_adam():
    """Two train steps of the program (dataset assembly, curl loss,
    autograd, Adam) against the reference's, from the same weights."""
    from pbml_mantle_convection_tpu_torch.data.dataset import (
        SnapshotDataset, SnapshotStore)
    from pbml_mantle_convection_tpu_torch.train.train_step import (
        TrainStepConfig, make_train_step)
    from pbml_mantle_convection_tpu_torch.train.trainer import adam_l2
    from benchmarks.drivers.train import make_store_rows
    model, w = flagship(4)
    r = make_store_rows(2, 4, H, W, 9)
    ds = SnapshotDataset(SnapshotStore(
        T=r["T"], u=r["u"], v=r["v"], p=None, paras=r["paras"],
        step_index=r["steps"], sim_id=r["sims"], times=r["times"],
        xc=r["xc"], yc=r["yc"]), dtype=F64, device="cpu",
        host_resident=False)
    step = make_train_step(model, adam_l2(model.parameters(), 1e-3),
                           TrainStepConfig(loss_derivative=True))
    xc, yc = (torch.as_tensor(r[k], dtype=F64) for k in ("xc", "yc"))
    rows = [np.array([0, 5, 2]), np.array([7, 1, 4])]
    losses_p, batches = [], []
    for idx in rows:
        b = ds._assemble(idx, 0)
        raw = {k: torch.as_tensor(r[k][idx], dtype=F64)
               for k in ("T", "u", "v")}
        raw["paras"] = r["paras"][idx]
        x, y = ref_train.batch(raw, xc, yc)
        close(b["x"], x)
        close(b["y"], y)
        batches.append((x, y))
        losses_p.append(float(step(b).total))
    losses_r, _, after = ref_train.train(w, batches, SMALL, 1e-3, F64)
    assert losses_p == pytest.approx(losses_r, rel=1e-10)
    for k, p in model.named_parameters():
        close(p.detach(), after[k], 1e-9)
