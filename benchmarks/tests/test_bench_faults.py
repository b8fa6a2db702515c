"""Each cell's check against faults planted under the timed path: the
whole run (set-up, window, check) but the look for a card, at a tiny
size on the CPU, with the cell's own limits. A sound run comes out
correct; a step that returns its state unchanged, half of the batch left
out (the mean taken over the rest), or an answer altered where it is
produced comes out not correct, for each cell that can have the fault.
The staged cells (``benchmarks/staged/``) are held to the same."""

import pytest
import torch

from benchmarks import run

CPU = torch.device("cpu")
SMALL_FLAGSHIP = {"model": {"levels": 3, "repeats": 2},
                  "grid": {"H": 32, "W": 40}}
SIZES = {
    "flagship-rollout-b1": dict(
        config=SMALL_FLAGSHIP,
        traffic={"chunk_steps": 20, "keep_share": 0.5, "check_pairs": 2}),
    "flagship-rollout-mlpre": dict(
        config=SMALL_FLAGSHIP,
        traffic={"chunk_steps": 10, "pre_iter": 20, "check_pairs": 1}),
    "transolver-serve-b1": dict(
        config={"grid": {"H": 16, "W": 20}},
        traffic={"check_forwards": 4, "warm_forwards": 1}),
    "flagship-train-b8": dict(
        config=SMALL_FLAGSHIP,
        traffic={"batch": 4, "sims": 2, "snapshots": 8, "warm_steps": 1}),
}


def overrides(cell):
    """The cell's files with the tiny sizes (nested groups merged)."""
    _, cfg, _, _ = run.cell_of(run.load_manifest(staged=True), cell)
    o = SIZES[cell]
    config = {k: ({**cfg[k], **v} if isinstance(v, dict) else v)
              for k, v in o["config"].items()}
    return {"config": config, "traffic": o["traffic"]}


def one_run(cell, seed=2 ** 31 + 17):
    return run.run(cell, seed, 0.5, False, CPU, overrides(cell), staged=True)


def stale_step(monkeypatch):
    from pbml_mantle_convection_tpu_torch.sim.engine import SimEngine
    monkeypatch.setattr(SimEngine, "_step", lambda self, state, n: state)


def altered_rollout_answer(monkeypatch):
    from pbml_mantle_convection_tpu_torch.physics.stokes import StokesFn
    from pbml_mantle_convection_tpu_torch.sim import engine
    epi = engine.curl_advect_epilogue

    def epilogue(*a):
        u, v, T, dt = epi(*a)
        return u * 1.01, v, T, dt

    call = StokesFn.__call__

    def stokes(self, *a):
        u, v, p = call(self, *a)
        return u * 1.01, v, p

    monkeypatch.setattr(engine, "curl_advect_epilogue", epilogue)
    monkeypatch.setattr(StokesFn, "__call__", stokes)


def altered_serve_answer(monkeypatch):
    from pbml_mantle_convection_tpu_torch.models import transolver
    head = transolver.curl_head_valid

    def curl(a):
        u, v = head(a)
        return u * 1.1, v

    monkeypatch.setattr(transolver, "curl_head_valid", curl)


def frozen_weights(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, *a, **k: None)


def _loss_with(change):
    def plant(monkeypatch):
        from pbml_mantle_convection_tpu_torch.train import train_step
        loss = train_step.fluidnet_loss

        def planted(u, v, p, y, **kw):
            return change(loss, u, v, p, y, **kw)

        monkeypatch.setattr(train_step, "fluidnet_loss", planted)
    plant.__name__ = f"loss{change.__name__}"
    return plant


def _half(loss, u, v, p, y, **kw):
    b = u.shape[0] // 2
    return loss(u[:b], v[:b], p, y[:b], **kw)


def _scaled(loss, *a, **kw):
    br = loss(*a, **kw)
    return br._replace(total=br.total * 1.01)


FAULTS = {
    "flagship-rollout-b1": [stale_step, altered_rollout_answer],
    "flagship-rollout-mlpre": [stale_step, altered_rollout_answer],
    "transolver-serve-b1": [altered_serve_answer],
    "flagship-train-b8": [frozen_weights, _loss_with(_half),
                          _loss_with(_scaled)],
}
CASES = [(c, f) for c, fs in FAULTS.items() for f in fs]


@pytest.mark.parametrize("cell", sorted(SIZES))
def test_sound_run_is_correct(cell):
    r = one_run(cell)
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("cell,fault", CASES,
                         ids=[f"{c}-{f.__name__}" for c, f in CASES])
def test_fault_is_caught(cell, fault, monkeypatch):
    fault(monkeypatch)
    r = one_run(cell)
    assert not r["correct"], r["checks"]


def test_a_traffic_key_the_driver_does_not_read_is_refused():
    o = overrides("flagship-rollout-b1")
    o["traffic"] = {**o["traffic"], "batch": 8}
    with pytest.raises(ValueError, match="batch"):
        run.run("flagship-rollout-b1", 2 ** 31 + 17, 0.5, False, CPU, o)
