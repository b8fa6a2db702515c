"""The port's train and eval steps (train/train_step.py) against the JAX
package's, in float64 on the CPU, with the Flax weights carried across by
``from_jax_params``: a small NewFluidNet (levels 2, c_h 4, repeats 2,
k 5, learned padding; 32×68) and a small TransolverStructured2D.

- gradients against ``jax.grad`` ≤ 1e-10 of the tensor's max |grad|;
- parameters after 3 Adam steps (with and without L2) against optax's,
  ≤ 1e-9 of the tensor's max |value|;
- the eval step's 6-column breakdown ≤ 1e-12;
- ``remat`` (torch.utils.checkpoint) equal to no remat.

A parameter the loss does not depend on gets a gradient of rounding
noise on both sides: the bias of NewFluidNet's last conv, whose output
loses its spatial mean before the curl head, and the Transolver's last
LayerNorm bias and Dense bias, which add a constant to the stream
function that the curl head differentiates away. Adam normalises that
noise to steps of ±lr whose sign neither side controls, so such a
parameter is held to its gradient being noise on both sides, and the two
models' outputs after the steps are held together instead. For the same
reason the Transolver's mass column (its VALID curl head is
divergence-free) is rounding noise, ~1e-18: the breakdowns are compared
with an absolute floor of 1e-12 of the total.
"""

import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from pbml_mantle_convection_tpu.models import NewFluidNet as JNewFluidNet  # noqa: E402
from pbml_mantle_convection_tpu.models import transolver as jt  # noqa: E402
from pbml_mantle_convection_tpu.train import train_step as jts  # noqa: E402

from pbml_mantle_convection_tpu_torch.models import transolver as tt  # noqa: E402
from pbml_mantle_convection_tpu_torch.models.fluidnet import NewFluidNet  # noqa: E402
from pbml_mantle_convection_tpu_torch.train import train_step as tts  # noqa: E402
from pbml_mantle_convection_tpu_torch.train.trainer import adam_l2  # noqa: E402
from pbml_mantle_convection_tpu_torch.utils.flax_convert import (  # noqa: E402
    from_jax_params)

F64 = torch.float64
NFN = dict(levels=2, c_i=7, c_h=4, c_o=1, act_fn="gelu", r_p="learned",
           loss_type="curl", repeats=2, f=5, p_pred=False)
TSV = dict(H=10, W=12, n_layers=2, n_hidden=16, n_head=2, slice_num=4,
           mlp_ratio=1)
STEP = dict(loss_scale=True, loss_derivative=True, loss_type="curl")
# a gradient below this share of the model's largest is rounding noise
NOISE = 1e-12


@pytest.fixture(scope="module", params=["newfluidnet", "transolver"])
def case(request):
    """The JAX side of one network, computed once: weights, batch, the
    loss breakdown and gradients at them, and the compiled
    value_and_grad."""
    rng = np.random.default_rng(0)
    if request.param == "newfluidnet":
        H, W = 32, 68
        x = rng.normal(size=(4, H, W, 7))
        jm = JNewFluidNet(**NFN)
        net = "newfluidnet"
    else:
        H, W = TSV["H"], TSV["W"]
        x = rng.normal(size=(3, H * W, 7))
        jm = jt.TransolverStructured2D(**TSV)
        net = "transolver_structured"
    y = rng.normal(size=(x.shape[0], 2, H, W))
    p = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    noise = np.random.default_rng(1)
    p = jax.tree.map(lambda a: np.asarray(a, np.float64)
                     + 0.02 * noise.normal(size=np.shape(a)), p)
    cfg = jts.TrainStepConfig(net=net, **STEP)
    batch = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    grad = jax.jit(jax.value_and_grad(jts.make_loss_fn(jm.apply, cfg),
                                      has_aux=True))
    (_, br), g = grad(p, batch)
    return dict(net=net, p=p, x=x, y=y, br=br, grad=grad, batch=batch,
                grads=from_jax_params(jax.tree.map(np.asarray, g)))


def _port_model(case, **kw):
    if case["net"] == "newfluidnet":
        m = NewFluidNet(device="cpu", dtype=F64, **NFN)
    else:
        m = tt.TransolverStructured2D(device="cpu", dtype=F64, **TSV)
    m.load_state_dict(from_jax_params(case["p"]))
    return m


def _batch(case):
    return {"x": torch.as_tensor(case["x"]), "y": torch.as_tensor(case["y"])}


def _cfg(case, **kw):
    return tts.TrainStepConfig(net=case["net"], **STEP, **kw)


def _close_breakdown(br, jbr, rtol):
    ref = np.asarray(jbr)
    np.testing.assert_allclose(br.stack().numpy(), ref, rtol=rtol,
                               atol=1e-12 * abs(ref[0]))


def _noise_params(grads):
    top = max(float(g.abs().max()) for g in grads.values())
    return {n for n, g in grads.items() if float(g.abs().max()) <= NOISE * top}


def test_gradients_match_jax(case):
    m = _port_model(case)
    step = tts.make_train_step(m, adam_l2(m.parameters(), 0.0), _cfg(case))
    br = step(_batch(case))
    _close_breakdown(br, case["br"], rtol=1e-12)
    grads = case["grads"]
    names = [n for n, _ in m.named_parameters()]
    assert sorted(names) == sorted(grads)
    noise = _noise_params(grads)
    assert noise == ({"conv_3.learnable_bias"}
                     if case["net"] == "newfluidnet"
                     else {"blocks_1.ln_3.bias", "blocks_1.mlp2.bias"})
    top = max(float(g.abs().max()) for g in grads.values())
    for n, q in m.named_parameters():
        g = grads[n]
        if n in noise:
            assert float(q.grad.abs().max()) <= NOISE * top, n
            continue
        err = float((q.grad - g).abs().max()) / float(g.abs().max())
        assert err <= 1e-10, (n, err)


@pytest.mark.parametrize("l2_reg", [0.0, 1e-2])
def test_three_adam_steps_match_optax(case, l2_reg):
    m = _port_model(case)
    step = tts.make_train_step(m, adam_l2(m.parameters(), 1e-3, l2_reg),
                               _cfg(case))
    # the JAX train step (jts.make_train_step) is value_and_grad, then
    # optimizer.update and apply_updates: the same three calls, here on
    # the value_and_grad compiled once by the fixture
    opt = optax.chain(optax.add_decayed_weights(l2_reg), optax.adam(1e-3))
    q = case["p"]
    state = opt.init(q)
    for _ in range(3):
        br = step(_batch(case))
        (_, jbr), g = case["grad"](q, case["batch"])
        updates, state = opt.update(g, state, q)
        q = optax.apply_updates(q, updates)
    _close_breakdown(br, jbr, rtol=1e-9)
    ref = from_jax_params(jax.tree.map(np.asarray, q))
    noise = _noise_params(case["grads"])
    for n, w in m.named_parameters():
        if n not in noise:
            err = float((w.detach() - ref[n]).abs().max())
            assert err <= 1e-9 * float(ref[n].abs().max()), (n, err)
    # the parameters the loss does not see leave the loss alone
    (_, jbr), _ = case["grad"](q, case["batch"])
    br = tts.make_eval_step(m, _cfg(case))(_batch(case))
    _close_breakdown(br, jbr, rtol=1e-9)


def test_eval_step_matches_jax(case):
    m = _port_model(case)
    br = tts.make_eval_step(m, _cfg(case))(_batch(case))
    assert isinstance(br, tts.LossBreakdown)
    assert not br.total.requires_grad
    _close_breakdown(br, case["br"], rtol=1e-12)
    assert all(q.grad is None for q in m.parameters())


def test_remat_equals_no_remat(case):
    models = [_port_model(case) for _ in range(2)]
    brs = []
    for m, remat in zip(models, (False, True)):
        step = tts.make_train_step(m, adam_l2(m.parameters(), 1e-3),
                                   _cfg(case, remat=remat))
        brs.append([step(_batch(case)).stack() for _ in range(2)])
    for a, b in zip(*brs):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=0)
    for (n, a), b in zip(models[0].named_parameters(),
                         models[1].parameters()):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=0, msg=n)
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-12, atol=1e-300,
                                   msg=n)


# ---------------------------------------------------------------------------
# the U-Net and ConvAE branches of make_loss_fn, through stand-in networks
# (on the real networks: tests/test_torch_port_unet.py)
# ---------------------------------------------------------------------------


def _standin(xp, w, n_out):
    """A pointwise linear map of the channels to ``n_out`` outputs, in
    numpy-like ``xp`` (jnp or torch), returned as a tuple of fields."""
    def apply(x):
        y = xp.tanh(x @ w)
        return tuple(y[..., i] for i in range(n_out))
    return apply


@pytest.mark.parametrize("roll_forward,p_pred", [(1, False), (3, False),
                                                 (2, True)])
def test_unet_loss_branch_matches_jax(roll_forward, p_pred):
    rng = np.random.default_rng(3)
    B, H, W, c_i = 2, 10, 12, 11 if p_pred else 10
    x = rng.uniform(0.1, 0.9, size=(B, H, W, c_i))
    y = rng.normal(size=(B, 4 if p_pred else 3, H, W))
    paras = np.tile([[3.0, 1e8, 10.0]], (B, 1))
    yc = np.broadcast_to(np.linspace(0, 1, H)[:, None], (B, H, W)).copy()
    w = rng.normal(size=(c_i, 4)) * 0.3
    batch = dict(x=x, y=y, paras=paras, yc=yc)
    kw = dict(net="unet", p_pred=p_pred, roll_forward=roll_forward, **STEP)
    jloss = jts.make_loss_fn(
        lambda params, xx: _standin(jnp, jnp.asarray(params), 4)(xx),
        jts.TrainStepConfig(**kw))
    (jtotal, jbr), jg = jax.value_and_grad(
        lambda q: jloss(q, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(jnp.asarray(w))
    tw = torch.tensor(w, requires_grad=True)
    tloss = tts.make_loss_fn(_standin(torch, tw, 4),
                             tts.TrainStepConfig(**kw))
    br = tloss({k: torch.as_tensor(v) for k, v in batch.items()})
    br.total.backward()
    np.testing.assert_allclose(br.stack().detach().numpy(), np.asarray(jbr),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jg), rtol=1e-10,
                               atol=1e-12)


def test_unet_reassemble_matches_jax():
    rng = np.random.default_rng(4)
    B, H, W = 2, 8, 9
    x = rng.uniform(0.1, 0.9, size=(B, H, W, 11))
    T, u, v, p = rng.uniform(size=(4, B, H, W))
    paras = np.asarray([[3.0, 1e8, 10.0], [1.0, 1e7, 3.0]])
    yc = np.broadcast_to(np.linspace(0, 1, H)[:, None], (B, H, W))
    for pp in (None, p):
        j = jts._unet_reassemble(*map(jnp.asarray, (x, T, u, v, paras, yc)),
                                 3, p=None if pp is None else jnp.asarray(pp))
        t = tts._unet_reassemble(*map(torch.as_tensor, (x, T, u, v, paras,
                                                        yc.copy())),
                                 3, p=None if pp is None
                                 else torch.as_tensor(pp))
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-14,
                                   atol=1e-15)


@pytest.mark.parametrize("p_pred,crop", [(False, False), (True, True)])
def test_convae_loss_branch_matches_jax(p_pred, crop):
    rng = np.random.default_rng(5)
    B, H, W = 2, 10, 12
    x = rng.normal(size=(B, H, W, 3))
    y = rng.normal(size=(B, 3, H + 2 * crop, W + 2 * crop))
    w = rng.normal(size=(3, 4)) * 0.3
    kw = dict(net="convae", p_pred=p_pred, **STEP)
    jloss = jts.make_loss_fn(
        lambda params, xx: jnp.tanh(xx @ params), jts.TrainStepConfig(**kw))
    _, jbr = jloss(jnp.asarray(w), {"x": jnp.asarray(x), "y": jnp.asarray(y)})
    tw = torch.as_tensor(w)
    br = tts.make_loss_fn(lambda xx: torch.tanh(xx @ tw),
                          tts.TrainStepConfig(**kw))(
        {"x": torch.as_tensor(x), "y": torch.as_tensor(y)})
    np.testing.assert_allclose(br.stack().numpy(), np.asarray(jbr),
                               rtol=1e-12, atol=1e-12)


def test_dropout_train_step_runs_from_its_generator():
    """With ``drop_rate`` > 0 the train step needs a generator and draws
    every mask from it: two steps from the same weights and the same seed
    give the same gradients and parameters, another seed others; the
    recomputing step (``remat``) draws the forward's masks again, so its
    gradients are the plain step's; the eval step runs deterministic, as
    the JAX eval step does (its breakdown is the model without dropout's).
    The masks are the port's own, so JAX's dropout step is not the
    reference here; its gradients with dropout off are
    (test_gradients_match_jax, tests/test_torch_port_train_item6.py)."""
    cfg = tts.TrainStepConfig(drop_rate=0.1, **STEP)
    rng = np.random.default_rng(3)
    batch = {"x": torch.as_tensor(rng.normal(size=(2, 16, 24, 7))),
             "y": torch.as_tensor(rng.normal(size=(2, 2, 16, 24)))}
    m = NewFluidNet(device="cpu", dtype=F64, **{**NFN, "drop_rate": 0.1})
    with pytest.raises(ValueError, match="torch.Generator"):
        tts.make_train_step(m, adam_l2(m.parameters(), 1e-3), cfg)

    def step(seed, remat=False):
        net = NewFluidNet(device="cpu", dtype=F64,
                          **{**NFN, "drop_rate": 0.1})
        net.load_state_dict(m.state_dict())
        g = torch.Generator().manual_seed(seed)
        br = tts.make_train_step(
            net, adam_l2(net.parameters(), 1e-3),
            tts.TrainStepConfig(drop_rate=0.1, remat=remat, **STEP),
            generator=g)(batch)
        return br, {n: q.grad.clone() for n, q in net.named_parameters()}, \
            {n: q.detach().clone() for n, q in net.named_parameters()}

    a, b, c, r = step(7), step(7), step(8), step(7, remat=True)
    assert torch.equal(a[0].stack(), b[0].stack())
    assert all(torch.equal(a[1][n], b[1][n]) and torch.equal(a[2][n],
                                                             b[2][n])
               for n in a[1])
    assert not torch.equal(a[0].stack(), c[0].stack())
    for n in a[1]:
        torch.testing.assert_close(r[1][n], a[1][n], rtol=1e-12, atol=1e-14)
    # the eval step runs deterministic, as the JAX eval step does
    plain = NewFluidNet(device="cpu", dtype=F64, **NFN)
    plain.load_state_dict(m.state_dict())
    ev = tts.make_eval_step(m, cfg)(batch).stack()
    assert torch.equal(ev, tts.make_eval_step(
        plain, tts.TrainStepConfig(**STEP))(batch).stack())


def test_donate_is_a_no_op(capsys):
    """``--donate`` (the JAX CLI's flag) changes nothing: the same metric
    name and the same loss as without it."""
    from pbml_mantle_convection_tpu_torch.cli import benchmark
    recs = []
    for extra in ([], ["--donate"]):
        benchmark.main(["--what", "train", "-l", "2", "-f", "4", "-r", "1",
                        "--H", "20", "--W", "28", "--batch", "2", "--iters",
                        "1", "--dtype", "float64", "--device", "cpu",
                        *extra])
        recs.append(json.loads(capsys.readouterr().out.splitlines()[-1]))
    assert recs[0]["metric"] == recs[1]["metric"] \
        == "train_step_newfluidnet_20x28_B2"
    assert recs[0]["loss"] == recs[1]["loss"]


# ---------------------------------------------------------------------------
# the Transolver under autograd
# ---------------------------------------------------------------------------


def _tsv_batch():
    x = torch.as_tensor(np.random.default_rng(2).normal(size=(2, 120, 7)))
    y = torch.as_tensor(np.random.default_rng(3).normal(size=(2, 2, 10, 12)))
    return {"x": x, "y": y}


def _count_routes(monkeypatch):
    """Record which formulation each Physics-Attention call runs."""
    from pbml_mantle_convection_tpu_torch.ops import slice_attention as sa
    calls = []
    fused, plain = sa.slice_attention_fused, sa.slice_attention_plain
    monkeypatch.setattr(sa, "slice_attention_fused",
                        lambda *a: calls.append("fused") or fused(*a))
    monkeypatch.setattr(sa, "slice_attention_plain",
                        lambda *a: calls.append("plain") or plain(*a))
    return calls


def test_transolver_trains_on_the_einsum_path(monkeypatch):
    """The train and eval steps run the Physics-Attention on the einsum
    formulation (every parameter gets a gradient); without grad, and
    with grad outside the steps, the model calls the fused path (the
    kernels on the card), as serving does."""
    m = tt.TransolverStructured2D(device="cpu", dtype=F64, **TSV)
    calls = _count_routes(monkeypatch)
    batch = _tsv_batch()
    cfg = tts.TrainStepConfig(net="transolver_structured", **STEP)
    step = tts.make_train_step(m, adam_l2(m.parameters(), 1e-3), cfg)
    step(batch)
    assert calls == ["plain"] * TSV["n_layers"]
    # the attention's own weights (the kernels would leave them without
    # a gradient) among every parameter; the last block's two biases that
    # the curl head differentiates away get rounding noise
    attn = [n for n, _ in m.named_parameters() if ".Attn." in n]
    assert len(attn) == 2 * 12
    for n, q in m.named_parameters():
        assert q.grad is not None, n
        if n not in ("blocks_1.ln_3.bias", "blocks_1.mlp2.bias"):
            assert float(q.grad.abs().max()) > 1e-14, n
    calls.clear()
    tts.make_eval_step(m, cfg)(batch)
    assert calls == ["plain"] * TSV["n_layers"]
    calls.clear()
    with torch.no_grad():
        m(batch["x"])
    assert calls == ["fused"] * TSV["n_layers"]
    calls.clear()
    m(batch["x"])[0].sum().backward()
    # the forward through the fused path, the backward recomputing the
    # einsum formulation (last block first)
    assert calls == ["fused"] * TSV["n_layers"] + ["plain"] * TSV["n_layers"]


@pytest.mark.parametrize("remat", [False, True])
def test_transolver_gradients_outside_the_step_equal_the_steps(remat):
    """A forward and backward outside the train step (the fused forward,
    its backward through the einsum formulation recomputed) gives the
    train step's gradients (the einsum path throughout); with ``remat``
    the checkpoint's recompute stays on the einsum path."""
    batch = _tsv_batch()
    grads = []
    for inside in (True, False):
        m = tt.TransolverStructured2D(device="cpu", dtype=F64, **TSV)
        cfg = tts.TrainStepConfig(net="transolver_structured", remat=remat,
                                  **STEP)
        if inside:
            tts.make_train_step(m, adam_l2(m.parameters(), 0.0),
                                cfg)(batch)
        else:
            from pbml_mantle_convection_tpu_torch.train.losses import (
                fluidnet_loss)
            u, v, p = m(batch["x"])
            fluidnet_loss(u, v, p, batch["y"][..., 1:-1, 1:-1], p_pred=False,
                          **STEP).total.backward()
        grads.append({n: q.grad for n, q in m.named_parameters()})
    for n, g in grads[0].items():
        torch.testing.assert_close(grads[1][n], g, rtol=0,
                                   atol=1e-12 * float(g.abs().max()) + 1e-300)


def test_slice_attention_backward_is_the_einsum_formulations():
    """``slice_attention`` under autograd: the fused forward, and every
    input's gradient that of ``slice_attention_plain``
    (``torch.autograd.gradcheck`` in float64, and the two side by side)."""
    from pbml_mantle_convection_tpu_torch.ops import slice_attention as sa
    rng = np.random.default_rng(9)
    B, H, N, D, G = 2, 2, 7, 4, 3

    def t(*shape):
        return torch.as_tensor(rng.normal(size=shape)).requires_grad_(True)

    args = (t(B, H, N, D), t(B, H, N, D), t(D, G), t(G),
            torch.as_tensor(rng.uniform(0.5, 1.5, size=(1, H, 1, 1)))
            .requires_grad_(True), t(D, D), t(D, D), t(D, D))
    assert torch.autograd.gradcheck(sa.slice_attention, args)
    gout = torch.as_tensor(rng.normal(size=(B, H, N, D)))
    got = torch.autograd.grad(sa.slice_attention(*args), args, gout)
    want = torch.autograd.grad(sa.slice_attention_plain(*args), args, gout)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-13)


def test_slice_kernels_refuse_autograd():
    from pbml_mantle_convection_tpu_torch.ops import slice_attention as sa
    rng = np.random.default_rng(4)
    fx, xm = (torch.as_tensor(rng.normal(size=(2, 9, 4))) for _ in range(2))
    ws = torch.as_tensor(rng.normal(size=(4, 3)), dtype=F64)
    bs, temp = torch.zeros(3, dtype=F64), torch.full((2,), 0.5, dtype=F64)
    tok = torch.as_tensor(rng.normal(size=(2, 3, 4)))
    sa.slice_pool(fx, xm, ws, bs, temp)
    sa.slice_deslice(xm, tok, ws, bs, temp)
    ws.requires_grad_(True)
    with pytest.raises(RuntimeError, match="has no backward"):
        sa.slice_pool(fx, xm, ws, bs, temp)
    with pytest.raises(RuntimeError, match="has no backward"):
        sa.slice_deslice(xm, tok, ws, bs, temp)
    with torch.no_grad():
        sa.slice_pool(fx, xm, ws, bs, temp)


def test_irregular_transolver_trains_through_the_point_head():
    """The irregular Transolver's point outputs are the stream function on
    the target's grid (``_point_head``): the same u, v as the structured
    curl head on that field; every weight but the unused placeholder
    gets a gradient."""
    from pbml_mantle_convection_tpu_torch.ops.curl import curl_head_valid
    psi = torch.as_tensor(np.random.default_rng(5).normal(size=(2, 6, 8)))
    u, v, p = tts._point_head(psi.reshape(2, 48, 1), 6, 8)
    ur, vr = curl_head_valid(psi)
    assert p is None and torch.equal(u, ur) and torch.equal(v, vr)
    _, _, p = tts._point_head(torch.stack([psi.reshape(2, 48)] * 2, -1), 6, 8)
    assert torch.equal(p, psi[:, 1:-1, 1:-1])

    m = tt.TransolverIrregular(space_dim=2, fun_dim=5, n_layers=2,
                               n_hidden=16, n_head=2, slice_num=4,
                               device="cpu", dtype=F64)
    rng = np.random.default_rng(6)
    batch = {"x": torch.as_tensor(rng.normal(size=(2, 48, 7))),
             "y": torch.as_tensor(rng.normal(size=(2, 2, 6, 8)))}
    step = tts.make_train_step(m, adam_l2(m.parameters(), 1e-3),
                               tts.TrainStepConfig(net="transolver", **STEP))
    first = float(step(batch).total)
    for _ in range(5):
        last = float(step(batch).total)
    assert np.isfinite(last) and last < first
    for n, q in m.named_parameters():
        assert (float(q.grad.abs().max()) > 0) == (n != "placeholder"), n
