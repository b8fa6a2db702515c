"""The port's PT Stokes solver against the JAX package's
``physics/stokes.py`` (which tests/test_sim_aux.py holds against the
native C++ engine at rtol 1e-9): cold with a fixed count, warm-started,
with the ptol early stop, and batched through ``make_stokes_fn`` (each
simulation stopping on its own, as under ``jax.vmap``). Float64, inputs
from numpy."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from pbml_mantle_convection_tpu.physics.stokes import (  # noqa: E402
    PTStokesSolver as JSolver, make_stokes_fn as j_make_stokes_fn)
from pbml_mantle_convection_tpu.sim.grid import Grid as JGrid  # noqa: E402

from pbml_mantle_convection_tpu_torch.physics.stokes import (  # noqa: E402
    PTStokesSolver, make_stokes_fn)
from pbml_mantle_convection_tpu_torch.sim.grid import Grid  # noqa: E402

# tests/test_sim_aux.py::test_native_momentum_matches_jax_pt_solver
H, W, RAQ = 18, 34, 5.0
DY, DX = 1.0 / 16, 2.0 / (W - 2)


def _blob(amp=0.2, x0=0.75, fkt=1e4, fkp=3.0):
    """Smooth temperature blob on the 18×34, aspect-2 grid and its FK
    viscosity (interior fields)."""
    g = Grid(H=H, W=W, aspect=2.0)
    x, y = g.xc, g.yc
    T = (1.0 - y) + amp * np.exp(-((x - x0) ** 2 + (y - 0.4) ** 2) / 0.05)
    T[0], T[-1] = 1.0, 0.0
    V = np.exp(np.log(fkt) * (0 - T) + np.log(fkp) * (1 - y))
    return T, V


def _close(res, ref, rtol=1e-9, atol=1e-12):
    for name in ("u", "v", "p"):
        np.testing.assert_allclose(getattr(res, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=rtol, atol=atol)
    # the residual norms: relative to their scale, down to roundoff
    for name in ("err_mom", "err_div"):
        np.testing.assert_allclose(float(getattr(res, name)),
                                   float(getattr(ref, name)), rtol=1e-6,
                                   atol=1e-12)


def _solvers(**kw):
    return (PTStokesSolver(ny=H - 2, nx=W - 2, dy=DY, dx=DX, raq=RAQ, **kw),
            JSolver(ny=H - 2, nx=W - 2, dy=DY, dx=DX, raq=RAQ, **kw))


def test_cold_fixed_count_matches_jax():
    """1500 PT iterations from rest at 16×32 interior, ptol = 0, rtol 1e-9
    (the native-vs-JAX standard of tests/test_sim_aux.py)."""
    T, V = _blob()
    ts, js = _solvers(n_iter=1500, ptol=0.0)
    ref = js.solve(jnp.asarray(T[1:-1, 1:-1]), jnp.asarray(V[1:-1, 1:-1]))
    res = ts.solve(torch.as_tensor(T[1:-1, 1:-1]),
                   torch.as_tensor(V[1:-1, 1:-1]))
    assert res.u.shape == (H, W) and int(res.n_done) == 1500
    _close(res, ref)


def test_warm_start_matches_jax():
    """The ML_PRE refinement: a warm start from perturbed cell-centred
    fields, 300 fixed iterations."""
    T, V = _blob(amp=0.3)
    rng = np.random.default_rng(0)
    u0, v0, p0 = (rng.normal(size=(H - 2, W - 2)) * s for s in (5, 5, 50))
    ts, js = _solvers(n_iter=2000, ptol=0.0)
    ref = js.solve(jnp.asarray(T[1:-1, 1:-1]), jnp.asarray(V[1:-1, 1:-1]),
                   u0=jnp.asarray(u0), v0=jnp.asarray(v0),
                   p0=jnp.asarray(p0), n_iter=300)
    res = ts.solve(torch.as_tensor(T[1:-1, 1:-1]),
                   torch.as_tensor(V[1:-1, 1:-1]), u0=torch.as_tensor(u0),
                   v0=torch.as_tensor(v0), p0=torch.as_tensor(p0), n_iter=300)
    assert int(res.n_done) == 300
    _close(res, ref)


@pytest.mark.parametrize("ptol,n_iter", [(1e-5, 4000), (1e-9, 600)])
def test_ptol_early_stop_matches_jax(ptol, n_iter):
    """Converge-or-budget in chunks of check_every: the same n_done as the
    JAX while_loop (stopped by ptol, or by the budget, which a chunk may
    overshoot), and the same fields."""
    T, V = _blob()
    ts, js = _solvers(n_iter=n_iter, ptol=ptol)
    ref = js.solve(jnp.asarray(T[1:-1, 1:-1]), jnp.asarray(V[1:-1, 1:-1]))
    res = ts.solve(torch.as_tensor(T[1:-1, 1:-1]),
                   torch.as_tensor(V[1:-1, 1:-1]))
    assert int(res.n_done) == int(ref.n_done)
    assert int(res.n_done) % 250 == 0
    _close(res, ref)
    if ptol == 1e-5:
        assert int(res.n_done) < n_iter
        assert max(float(res.err_mom), float(res.err_div)) < ptol


def test_batched_make_stokes_fn_matches_jax_vmap():
    """make_stokes_fn on B=2 simulations, cold and warm, vs the JAX
    vmapped solver: the members converge after different numbers of
    chunks, and the one that stops first is frozen."""
    g, jg = Grid(H=H, W=W, aspect=2.0), JGrid(H=H, W=W, aspect=2.0)
    (T1, V1), (T2, V2) = _blob(), _blob(amp=0.5, x0=1.4, fkt=3e5)
    T, V = np.stack([T1, T2]), np.stack([V1, V2])
    fn = make_stokes_fn(g, raq=RAQ, n_iter=3000, pre_iter=400)
    jfn = j_make_stokes_fn(jg, raq=RAQ, n_iter=3000, pre_iter=400)
    out = fn(torch.as_tensor(T), torch.as_tensor(V))
    ref = jfn(jnp.asarray(T), jnp.asarray(V))
    n_done = fn.n_done.tolist()
    assert n_done[0] != n_done[1]
    for b in range(2):     # each member as it would run alone
        alone = fn.solver.solve(torch.as_tensor(T[b, 1:-1, 1:-1]),
                                torch.as_tensor(V[b, 1:-1, 1:-1]))
        assert int(alone.n_done) == n_done[b]
    for a, r in zip(out, ref):
        assert a.shape == (2, H, W)
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-9,
                                   atol=1e-12)

    rng = np.random.default_rng(1)
    uvp0 = [rng.normal(size=(2, H, W)) * s for s in (5, 5, 50)]
    out = fn(torch.as_tensor(T), torch.as_tensor(V),
             tuple(torch.as_tensor(a) for a in uvp0))
    ref = jfn(jnp.asarray(T), jnp.asarray(V),
              tuple(jnp.asarray(a) for a in uvp0))
    # pre_iter = 400 in chunks of 250: the budget check overshoots to 500
    assert fn.n_done.tolist() == [500, 500]
    for a, r in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-9,
                                   atol=1e-12)
