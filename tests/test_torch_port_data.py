"""The port's data layer (data/) against the JAX package's, in float64 on
the CPU, from the same numpy seeds.

The batches are the JAX package's bit for bit in every channel computed
by arithmetic (coordinates, parameter planes, T, u/s, v/s, p, dt), in
both residency modes, with the same numpy draws (the next draw after an
epoch is the same). Two quantities pass through exp, log or pow, whose
CPU implementations differ between XLA and PyTorch by an ulp: the
viscosity channel and ``t_weight`` are held to 1e-15. The noise is drawn
from a torch generator (JAX: ``jax.random``), so it is held to its
bounds, not to JAX's values.
"""

import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from pbml_mantle_convection_tpu.constants import SimParams as JParams  # noqa: E402
from pbml_mantle_convection_tpu.data import dataset as jd  # noqa: E402
from pbml_mantle_convection_tpu.data import preprocess as jpre  # noqa: E402
from pbml_mantle_convection_tpu.data import synthetic as jsyn  # noqa: E402
from pbml_mantle_convection_tpu.data import torch_io as jio  # noqa: E402
from pbml_mantle_convection_tpu.data.prefetch import (  # noqa: E402
    prefetch_iter as j_prefetch_iter)
from pbml_mantle_convection_tpu.sim.grid import Grid as JGrid  # noqa: E402

from pbml_mantle_convection_tpu_torch.constants import SimParams  # noqa: E402
from pbml_mantle_convection_tpu_torch.data import dataset as td  # noqa: E402
from pbml_mantle_convection_tpu_torch.data import preprocess as tpre  # noqa: E402
from pbml_mantle_convection_tpu_torch.data import synthetic as tsyn  # noqa: E402
from pbml_mantle_convection_tpu_torch.data import torch_io as tio  # noqa: E402
from pbml_mantle_convection_tpu_torch.data.prefetch import prefetch_iter  # noqa: E402
from pbml_mantle_convection_tpu_torch.sim.grid import Grid  # noqa: E402

PARAMS = ((3.0, 1e8, 10.0), (1.0, 1e7, 3.0))
STORE_FIELDS = ("T", "u", "v", "p", "paras", "step_index", "sim_id",
                "times", "xc", "yc")


def _stores(n=10, with_p=True, seed=0):
    """The same synthetic store from both packages."""
    j = jsyn.synthetic_store(params_list=[JParams(*p) for p in PARAMS],
                             n_snapshots=n, with_p=with_p, seed=seed)
    t = tsyn.synthetic_store(params_list=[SimParams(*p) for p in PARAMS],
                             n_snapshots=n, with_p=with_p, seed=seed)
    return j, t


def _same_store(t, j):
    for k in STORE_FIELDS:
        a, b = getattr(t, k), getattr(j, k)
        if b is None:
            assert a is None, k
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=k)


def _same_batch(t, j, transcendental=()):
    """Port batch ``t`` against JAX batch ``j``: bitwise but for the
    ``(key, channel)`` pairs in ``transcendental`` (≤ 1e-15)."""
    assert set(t) == set(j)
    for k in j:
        a, b = t[k].numpy(), np.asarray(j[k])
        assert a.shape == b.shape and a.dtype == b.dtype, k
        exact = np.ones(a.shape, bool)
        for key, chan in transcendental:
            if key == k:
                sel = (..., chan) if chan is not None else ...
                np.testing.assert_allclose(a[sel], b[sel], rtol=1e-15,
                                           atol=1e-15, err_msg=k)
                exact[sel] = False
        np.testing.assert_array_equal(a[exact], b[exact], err_msg=k)


SNAPSHOT_T = (("x", 2), ("t_weight", None))
TIMEPAIR_T = (("x", 6),)


def test_synthetic_store_is_jaxs():
    _same_store(*_stores()[::-1])
    j, t = _stores(n=4, with_p=False, seed=3)
    _same_store(t, j)


def test_synthetic_memmap_store_is_jaxs(tmp_path):
    args = dict(n_snapshots_per_sim=9, chunk=4)
    j = jsyn.synthetic_store_memmap(
        str(tmp_path / "j"), grid=JGrid(H=12, W=20),
        params_list=[JParams(*p) for p in PARAMS], **args)
    t = tsyn.synthetic_store_memmap(
        str(tmp_path / "t"), grid=Grid(H=12, W=20),
        params_list=[SimParams(*p) for p in PARAMS], **args)
    assert isinstance(t.T, np.memmap) and len(t) == 18
    _same_store(t, j)
    again = tsyn.synthetic_store_memmap(
        str(tmp_path / "t"), grid=Grid(H=12, W=20),
        params_list=[SimParams(*p) for p in PARAMS], **args)
    np.testing.assert_array_equal(np.asarray(again.T), np.asarray(t.T))


@pytest.mark.parametrize("host_resident", [False, True])
@pytest.mark.parametrize("p_pred,scale", [(True, True), (False, False)])
def test_snapshot_epoch_matches_jax(host_resident, p_pred, scale):
    j, t = _stores()
    kw = dict(p_pred=p_pred, scale=scale, host_resident=host_resident)
    jds = jd.SnapshotDataset(j, dtype=jnp.float64, **kw)
    tds = td.SnapshotDataset(t, dtype=torch.float64, device="cpu", **kw)
    assert tds.host_resident == host_resident and len(tds) == len(jds)
    jr, tr = np.random.default_rng(3), np.random.default_rng(3)
    jb, tb = list(jds.epoch_batches(jr, 3)), list(tds.epoch_batches(tr, 3))
    assert len(tb) == len(jb) == len(tds) // 3
    for a, b in zip(tb, jb):
        _same_batch(a, b, SNAPSHOT_T)
    assert tr.integers(0, 2**31) == jr.integers(0, 2**31)
    a, b = tds.batch(tr, 4), jds.batch(jr, 4)
    _same_batch(a, b, SNAPSHOT_T)


@pytest.mark.parametrize("host_resident", [False, True])
def test_unstructured_epoch_matches_jax(host_resident):
    j, t = _stores()
    jds = jd.UnstructuredDataset(j, dtype=jnp.float64,
                                 host_resident=host_resident)
    tds = td.UnstructuredDataset(t, dtype=torch.float64, device="cpu",
                                 host_resident=host_resident)
    for a, b in zip(tds.epoch_batches(np.random.default_rng(5), 4),
                    jds.epoch_batches(np.random.default_rng(5), 4)):
        assert a["x"].shape == (4, 32 * 68, 7)
        _same_batch(a, b, SNAPSHOT_T)


def test_convae_batches_match_jax():
    j, t = _stores()
    jds = jd.ConvAEDataset(j, dtype=jnp.float64)
    tds = td.ConvAEDataset(t, dtype=torch.float64, device="cpu")
    _same_batch(tds.batch(np.random.default_rng(6), 3),
                jds.batch(np.random.default_rng(6), 3))


@pytest.mark.parametrize("host_resident", [False, True])
@pytest.mark.parametrize("roll_forward,p_pred", [(1, False), (2, True)])
def test_time_pair_epoch_matches_jax(host_resident, roll_forward, p_pred):
    """Includes the every-8th init-pair remap (datasetio.py:233-236):
    the 20-snapshot simulations have pairs at store indices 0, 8, 16,
    ... which are remapped with draws from the same generator."""
    j, t = _stores(n=20)
    kw = dict(roll_forward=roll_forward, p_pred=p_pred,
              host_resident=host_resident)
    jds = jd.TimePairDataset(j, dtype=jnp.float64, **kw)
    tds = td.TimePairDataset(t, dtype=torch.float64, device="cpu", **kw)
    np.testing.assert_array_equal(tds.pairs, jds.pairs)
    np.testing.assert_array_equal(tds.init_pairs, jds.init_pairs)
    assert (tds.pairs[:, 0] % 8 == 0).sum() >= 3
    jr, tr = np.random.default_rng(7), np.random.default_rng(7)
    jb, tb = list(jds.epoch_batches(jr, 4)), list(tds.epoch_batches(tr, 4))
    assert len(tb) == len(jb) == len(tds) // 4
    for a, b in zip(tb, jb):
        _same_batch(a, b, TIMEPAIR_T)
    assert tr.integers(0, 2**31) == jr.integers(0, 2**31)
    _same_batch(tds.batch(tr, 5), jds.batch(jr, 5), TIMEPAIR_T)


def test_init_remap_matches_jax():
    j, t = _stores(n=20)
    jds, tds = jd.TimePairDataset(j), td.TimePairDataset(t, device="cpu")
    idx = np.arange(len(tds))
    got = tds._remap_init(idx, np.random.default_rng(8))
    np.testing.assert_array_equal(
        got, jds._remap_init(idx, np.random.default_rng(8)))
    mask = tds.pairs[:, 0] % 8 == 0
    for row in got[mask]:
        assert (row == tds.init_pairs).all(axis=1).any()
    np.testing.assert_array_equal(got[~mask], tds.pairs[~mask])


def test_host_and_device_batches_are_bitwise_equal_with_noise():
    _, t = _stores()
    dev = td.SnapshotDataset(t, p_pred=True, noise=1e-5, device="cpu",
                             host_resident=False)
    host = td.SnapshotDataset(t, p_pred=True, noise=1e-5, device="cpu",
                              host_resident=True)
    for a, b in zip(dev.epoch_batches(np.random.default_rng(3), 4),
                    host.epoch_batches(np.random.default_rng(3), 4)):
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_noise_bounds():
    """uniform(-1e-5, 1e-5) on the [2:-2, 2:-2] interior, clipped to
    [0, 1.35]; the ring is untouched; a seed gives the same noise."""
    _, t = _stores(n=6)
    ds = td.SnapshotDataset(t, noise=1e-5, dtype=torch.float64, device="cpu")
    clean = td.SnapshotDataset(t, dtype=torch.float64, device="cpu")
    idx = np.arange(6)
    T = ds._assemble(idx, 11)["x"][..., 6]
    T0 = clean._assemble(idx, 11)["x"][..., 6]
    d = (T - T0)[:, 2:-2, 2:-2]
    assert float(d.abs().max()) <= 1e-5 and float(d.abs().max()) > 0
    assert float(T.max()) <= 1.35 and float(T.min()) >= 0.0
    ring = torch.ones(T.shape[1:], dtype=torch.bool)
    ring[2:-2, 2:-2] = False
    assert torch.equal(T[:, ring], T0[:, ring])
    assert torch.equal(T, ds._assemble(idx, 11)["x"][..., 6])
    assert not torch.equal(T, ds._assemble(idx, 12)["x"][..., 6])


def test_epoch_batches_cover_the_dataset():
    _, t = _stores()
    ds = td.SnapshotDataset(t, dtype=torch.float64, device="cpu")
    seen = np.concatenate([b["x"][:, 1, 1, 6].numpy() for b in
                           ds.epoch_batches(np.random.default_rng(4), 3)])
    assert len(seen) == (len(ds) // 3) * 3
    assert len(np.unique(seen)) == len(seen)
    n = sum(b["x"].shape[0] for b in ds.epoch_batches(
        np.random.default_rng(4), 3, drop_last=False))
    assert n == len(ds)


def test_select_snapshot_indices_match_jax():
    for n_times, is_init in ((100, False), (100, True), (900, False),
                             (900, True), (300, False)):
        a = td.select_snapshot_indices(n_times, np.random.default_rng(9),
                                       is_init)
        b = jd.select_snapshot_indices(n_times, np.random.default_rng(9),
                                       is_init)
        np.testing.assert_array_equal(a, b)
    assert list(td.select_snapshot_indices(
        100, np.random.default_rng(0), True)) == [1, 2, 3, 4, 5]


def test_residency_threshold(monkeypatch):
    _, t = _stores(n=4, with_p=False)
    assert not td.SnapshotDataset(t, device="cpu").host_resident
    assert td._DEVICE_STORE_BYTES_DEFAULT == 32 << 30
    monkeypatch.setenv("PMC_DEVICE_STORE_BYTES", str(t.field_nbytes(4) - 1))
    assert td.SnapshotDataset(t, device="cpu").host_resident
    assert td.TimePairDataset(t, device="cpu").host_resident
    assert not td.SnapshotDataset(t, device="cpu",
                                  host_resident=False).host_resident


def test_memmap_store_feeds_the_host_resident_mode(tmp_path):
    store = tsyn.synthetic_store_memmap(
        str(tmp_path / "s"), grid=Grid(H=16, W=32),
        params_list=[SimParams(*p) for p in PARAMS], n_snapshots_per_sim=25,
        chunk=7)
    ds = td.SnapshotDataset(store, host_resident=True, device="cpu")
    batches = list(ds.epoch_batches(np.random.default_rng(0), 8))
    assert len(batches) == 6 and batches[0]["x"].shape == (8, 16, 32, 7)
    assert batches[0]["x"].dtype == torch.float32
    assert all(bool(torch.isfinite(b["x"]).all()) for b in batches)


def test_prefetch_iter_order_and_depth_zero():
    import threading
    for fn in (prefetch_iter, j_prefetch_iter):
        assert list(fn(lambda i: i * i, 7, depth=2)) == [i * i
                                                         for i in range(7)]
    assert list(prefetch_iter(lambda i: i, 3, depth=0)) == [0, 1, 2]
    assert list(prefetch_iter(lambda i: i, 0)) == []
    main = threading.get_ident()
    assert all(t != main for t in prefetch_iter(
        lambda i: threading.get_ident(), 4))
    assert all(t == main for t in prefetch_iter(
        lambda i: threading.get_ident(), 4, depth=0))


def test_preprocess_matches_jax(tmp_path):
    j, t = _stores(n=12)
    a = tpre.split_select_init(t, np.random.default_rng(2))
    b = jpre.split_select_init(j, np.random.default_rng(2))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    mt = tpre.write_selected(t, str(tmp_path / "t"),
                             np.random.default_rng(3))
    mj = jpre.write_selected(j, str(tmp_path / "j"),
                             np.random.default_rng(3))
    assert mt == mj
    for sim in mt:
        for name in ("e1_select.npz", "e1_select_init.npz"):
            with np.load(tmp_path / "t" / f"sim_{sim}" / name) as x, \
                    np.load(tmp_path / "j" / f"sim_{sim}" / name) as y:
                assert sorted(x) == sorted(y)
                for k in x:
                    np.testing.assert_array_equal(x[k], y[k])
    times = [t.times[t.sim_id == s] for s in np.unique(t.sim_id)]
    assert tpre.scan_dt_range(times) == jpre.scan_dt_range(times)


# ---------------------------------------------------------------------------
# the reference's on-disk .pt layout (as tests/test_torch_io_end_to_end.py
# fabricates it)
# ---------------------------------------------------------------------------

H, W, N_SNAPS, N_INIT = 12, 20, 6, 5


@pytest.fixture(scope="module")
def pt_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("pt_tree")
    rng = np.random.default_rng(7)
    xc, yc = np.meshgrid(np.linspace(0.0, 4.0, W), np.linspace(0.0, 1.0, H))
    times = np.cumsum(0.01 + 0.001 * rng.random(N_SNAPS + 4))
    sims = [[0, "train", 3.217, 8.64e7, 3.016, H, 4, "/fake/sim0"],
            [1, "train", 6.271, 4.94e6, 42.76, H, 4, "/fake/sim1"],
            [2, "cv", 4.215, 2.1e7, 10.12, H, 4, "/fake/sim2"]]
    torch.save(sims, os.path.join(root, "sims.pt"))

    def fields(n):
        return [torch.tensor(rng.normal(size=(n, 1, H, W)))
                for _ in range(4)]

    for sid, split, *_ in sims:
        d = os.path.join(root, split, f"sim_{sid}")
        os.makedirs(d)
        for suffix, n in (("_select_snaps", N_SNAPS),
                          ("_select_init", N_INIT)):
            for name, f in zip(("uprev", "vprev", "pprev", "Tprev"),
                               fields(n)):
                torch.save(f, os.path.join(d, f"e1_{name}_data{suffix}.pt"))
        torch.save(list(range(1, N_INIT + 1)),
                   os.path.join(d, "e1_i_vec_select_init.pt"))
        for name, a in (("times", times), ("xc", xc), ("yc", yc)):
            torch.save(torch.tensor(a), os.path.join(d, f"{name}.pt"))
    return str(root)


@pytest.mark.parametrize("an,is_init,p_pred", [("train", False, False),
                                               ("train", True, True),
                                               ("cv", False, True)])
def test_torch_io_store_matches_jax(pt_tree, an, is_init, p_pred):
    t = tio.load_store(pt_tree, an, is_init=is_init, p_pred=p_pred)
    j = jio.load_store(pt_tree, an, is_init=is_init, p_pred=p_pred)
    _same_store(t, j)
    assert t.xc[0, 0] == 0.0 and t.xc[0, -1] == 4.0
    for fn in ("get_indices", "get_indices_time"):
        a = getattr(tio, fn)(pt_tree, an, is_init=is_init)
        b = getattr(jio, fn)(pt_tree, an, is_init=is_init)
        for x, y in zip(a, b):
            assert len(x) == len(y) > 0
            np.testing.assert_array_equal(np.asarray(x, float),
                                          np.asarray(y, float))


def test_torch_io_batches_match_jax(pt_tree):
    t = tio.load_store(pt_tree, "train")
    j = jio.load_store(pt_tree, "train")
    tds = td.SnapshotDataset(t, dtype=torch.float64, device="cpu")
    jds = jd.SnapshotDataset(j, dtype=jnp.float64)
    for a, b in zip(tds.epoch_batches(np.random.default_rng(1), 4),
                    jds.epoch_batches(np.random.default_rng(1), 4)):
        _same_batch(a, b, SNAPSHOT_T)
    with pytest.raises(FileNotFoundError):
        tio.load_store(pt_tree, "test")
