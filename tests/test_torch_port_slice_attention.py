"""The port's slice attention against the JAX package on the CPU.

- ``slice_attention_plain`` and ``slice_attention_fused`` (on the CPU: the
  two kernel wrappers' plain versions) against the JAX Pallas kernel in
  interpret mode, at the JAX test's cases, float32: rtol 2e-5, atol 2e-6
  (the tolerance of tests/test_slice_attention.py);
- the same at D = G = 128 (the kernels' widest) against the Pallas kernel,
  float32, within 1e-5 of max |ref|: 128-term float32 logits and sums in
  another order (elementwise up to 3e-5 where |ref| is 11.6);
- the same against the JAX model's einsum formulation
  (``models/transolver.py::_slice_attention``) in float64: ≤ 1e-12, also
  at (D, G) = (96, 128) and (128, 128), and past the tensor-core kernels'
  128 at (160, 136) and (136, 160) (where the card runs the SIMT kernels),
  also against the Pallas kernel in float32;
- ``slice_attention_fused`` on the layouts the projections give (a
  channels-last conv's heads, Dense heads, 3-D convs) against the same
  values made contiguous, float64 ≤ 1e-12; its result is the view of
  (B, N, heads·D) rows, so that the output projection reads it with no
  copy; ``kernel_view`` passes a view with adjacent channels through and
  copies any other;
- bfloat16 inputs against the JAX model's bfloat16 einsum within 3e-2 of
  max |ref| (each side rounds logits, weights and sums to 8 bits at other
  places: ~1.1e-2 apart), and no further than 1.25 x JAX's own bfloat16
  error from the float64 result on the same bfloat16 values;
- the plain versions of the two kernels against direct einsums, float64.
The CUDA kernels are held against these plain versions on the card by
tests/test_torch_port_cuda.py.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from pbml_mantle_convection_tpu.models.transolver import (  # noqa: E402
    _slice_attention as j_slice_attention)
from pbml_mantle_convection_tpu.ops.slice_attention import (  # noqa: E402
    slice_attention_fused as j_slice_attention_fused)

from pbml_mantle_convection_tpu_torch.ops.slice_attention import (  # noqa: E402
    kernel_view, slice_attention_fused, slice_attention_plain, slice_deslice,
    slice_deslice_plain, slice_pool, slice_pool_plain, token_attention)

PORT = {"plain": slice_attention_plain, "fused": slice_attention_fused}


def _inputs(B, H, N, D, G, seed=0):
    """The JAX test's inputs (tests/test_slice_attention.py:31-40)."""
    rng = np.random.default_rng(seed)
    fx = rng.normal(size=(B, H, N, D))
    xm = rng.normal(size=(B, H, N, D))
    ws = rng.normal(size=(D, G)) * 0.3
    bs = rng.normal(size=(G,)) * 0.1
    temp = 0.4 + 0.2 * rng.random((1, H, 1, 1))
    wq, wk, wv = (rng.normal(size=(D, D)) * 0.3 for _ in range(3))
    return fx, xm, ws, bs, temp, wq, wk, wv


@pytest.mark.parametrize("port", sorted(PORT))
@pytest.mark.parametrize("N,block_n", [(256, 64), (200, 64), (64, 64)])
def test_port_matches_pallas_interpret_f32(port, N, block_n):
    args = [a.astype(np.float32) for a in _inputs(2, 3, N, 8, 16)]
    ref = j_slice_attention_fused(*map(jnp.asarray, args), block_n=block_n)
    out = PORT[port](*map(torch.as_tensor, args))
    assert out.dtype == torch.float32 and out.shape == (2, 3, N, 8)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-6)


@pytest.mark.parametrize("port", sorted(PORT))
@pytest.mark.parametrize("N,block_n", [(64, 64), (100, 64)])
def test_port_matches_pallas_interpret_f32_wide(port, N, block_n):
    args = [a.astype(np.float32) for a in _inputs(1, 2, N, 128, 128)]
    ref = np.asarray(j_slice_attention_fused(*map(jnp.asarray, args),
                                             block_n=block_n))
    out = PORT[port](*map(torch.as_tensor, args))
    assert out.dtype == torch.float32 and out.shape == (1, 2, N, 128)
    assert np.abs(out.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("port", sorted(PORT))
@pytest.mark.parametrize("D,G", [(160, 136), (136, 160)])
def test_port_matches_pallas_interpret_f32_past_128(port, D, G):
    """D or G past the tensor-core kernels' 128 (the card's SIMT route),
    float32, against the float64 result on the same float32 values: within
    1e-5 of max |ref| and no further than the Pallas kernel in float32.
    At these widths float32 logits alone leave two float32 formulations
    1.4e-5 and 2.2e-5 apart (the Pallas kernel's own distance from
    float64; the port's reads 8.9e-6 and 5.1e-6)."""
    args = [a.astype(np.float32) for a in _inputs(1, 2, 100, D, G)]
    truth = _j_einsum(*(jnp.asarray(a, jnp.float64) for a in args))
    scale = np.abs(truth).max()
    pallas = np.asarray(j_slice_attention_fused(*map(jnp.asarray, args),
                                                block_n=64))
    out = PORT[port](*map(torch.as_tensor, args))
    assert out.dtype == torch.float32 and out.shape == (1, 2, 100, D)
    err = np.abs(out.numpy() - truth).max() / scale
    assert err <= 1e-5 and err <= np.abs(pallas - truth).max() / scale


def _j_einsum(fx, xm, ws, bs, temp, wq, wk, wv):
    return np.asarray(j_slice_attention(
        fx, xm, lambda x: x @ ws + bs, temp, lambda t: t @ wq,
        lambda t: t @ wk, lambda t: t @ wv, fx.shape[-1] ** -0.5
    ).astype(jnp.float64))


@pytest.mark.parametrize("port", sorted(PORT))
@pytest.mark.parametrize("shape", [(2, 3, 200, 8, 16), (1, 2, 97, 16, 32)])
def test_port_bf16_matches_einsum_model_bf16(port, shape):
    jb = [jnp.asarray(a, jnp.bfloat16) for a in _inputs(*shape, seed=2)]
    ref = _j_einsum(*jb)
    out = PORT[port](*(torch.as_tensor(np.asarray(a, np.float32)).bfloat16()
                       for a in jb))
    assert out.dtype == torch.bfloat16 and out.shape == shape[:4]
    assert (np.abs(out.double().numpy() - ref).max()
            <= 3e-2 * np.abs(ref).max())


@pytest.mark.parametrize("port", sorted(PORT))
@pytest.mark.parametrize("shape", [(1, 2, 97, 16, 32), (1, 2, 64, 128, 128)])
def test_port_bf16_as_close_to_f64_as_jax_bf16(port, shape):
    jb = [jnp.asarray(a, jnp.bfloat16) for a in _inputs(*shape, seed=2)]
    exact = [np.asarray(a, np.float64) for a in jb]   # the bfloat16 values
    truth = _j_einsum(*map(jnp.asarray, exact))
    scale = np.abs(truth).max()
    j_err = np.abs(_j_einsum(*jb) - truth).max() / scale
    out = PORT[port](*(torch.as_tensor(a).bfloat16() for a in exact))
    assert np.abs(out.double().numpy() - truth).max() / scale <= 1.25 * j_err


@pytest.mark.parametrize("port", sorted(PORT))
@pytest.mark.parametrize("shape", [(2, 3, 200, 8, 16), (1, 2, 97, 16, 32),
                                   (1, 1, 50, 4, 4), (1, 2, 40, 96, 128),
                                   (1, 1, 30, 128, 128), (1, 2, 30, 160, 136),
                                   (1, 1, 30, 136, 160)])
def test_port_matches_einsum_model_f64(port, shape):
    fx, xm, ws, bs, temp, wq, wk, wv = _inputs(*shape, seed=1)
    D = shape[3]
    ref = j_slice_attention(
        jnp.asarray(fx), jnp.asarray(xm), lambda x: x @ ws + bs,
        jnp.asarray(temp), lambda t: t @ wq, lambda t: t @ wk,
        lambda t: t @ wv, D ** -0.5)
    out = PORT[port](*map(torch.as_tensor, (fx, xm, ws, bs, temp, wq, wk,
                                            wv)))
    assert out.dtype == torch.float64
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=1e-12)


def test_kernel_plain_versions_f64():
    """num, den and the broadcast of the two kernels' plain versions (what
    the CPU wrappers run) against einsums written out here."""
    fx, xm, ws, bs, temp, *_ = _inputs(2, 3, 77, 8, 16, seed=2)
    BH = 6
    fx, xm = fx.reshape(BH, 77, 8), xm.reshape(BH, 77, 8)
    t = np.broadcast_to(temp.reshape(1, 3), (2, 3)).reshape(BH)
    logits = (xm @ ws + bs) / t[:, None, None]
    w = np.exp(logits - logits.max(-1, keepdims=True))
    w /= w.sum(-1, keepdims=True)
    tok = np.random.default_rng(3).normal(size=(BH, 16, 8))
    T = [torch.as_tensor(a) for a in (fx, xm, ws, bs, t, tok)]
    for pool in (slice_pool, slice_pool_plain):
        num, den = pool(*T[:5])
        np.testing.assert_allclose(num.numpy(),
                                   np.einsum("bng,bnd->bgd", w, fx),
                                   rtol=1e-12, atol=1e-13)
        np.testing.assert_allclose(den.numpy(), w.sum(1), rtol=1e-12)
    for deslice in (slice_deslice, slice_deslice_plain):
        out = deslice(T[1], T[5], *T[2:5])
        np.testing.assert_allclose(out.numpy(), w @ tok, rtol=1e-12,
                                   atol=1e-13)


def test_token_attention_is_softmax_attention():
    rng = np.random.default_rng(4)
    tok = rng.normal(size=(3, 5, 4))
    wq, wk, wv = (rng.normal(size=(4, 4)) for _ in range(3))
    q, k, v = tok @ wq, tok @ wk, tok @ wv
    d = q @ k.transpose(0, 2, 1) / 2.0
    a = np.exp(d - d.max(-1, keepdims=True))
    a /= a.sum(-1, keepdims=True)
    out = token_attention(*map(torch.as_tensor, (tok, wq, wk, wv)))
    np.testing.assert_allclose(out.numpy(), a @ v, rtol=1e-12, atol=1e-13)


def _layout(kind, x):
    """(B, H, N, D) values ``x`` in the layout a projection gives them."""
    B, H, N, D = x.shape
    if kind == "dense_heads":          # Dense (B, N, H·D) → heads
        rows = x.permute(0, 2, 1, 3).reshape(B, N, H * D).clone()
        return rows.view(B, N, H, D).transpose(1, 2)
    if kind == "conv2d_channels_last":  # (B, H·D, 5, N/5), channels-last
        img = x.transpose(2, 3).reshape(B, H * D, 5, N // 5)
        img = img.contiguous(memory_format=torch.channels_last)
        return img.reshape(B, H, D, N).transpose(2, 3)
    vol = x.transpose(2, 3).reshape(B, H * D, 5, 2, N // 10)
    if kind == "conv3d_channels_last":
        vol = vol.contiguous(memory_format=torch.channels_last_3d)
    else:                               # channel-first: a copy is made
        vol = vol.contiguous()
    return vol.reshape(B, H, D, N).transpose(2, 3)


@pytest.mark.parametrize("kind", ["dense_heads", "conv2d_channels_last",
                                  "conv3d_channels_last",
                                  "conv3d_channel_first"])
def test_fused_on_projection_layouts_matches_contiguous(kind):
    fx, xm, ws, bs, temp, wq, wk, wv = map(
        torch.as_tensor, _inputs(2, 3, 60, 8, 16, seed=5))
    views = _layout(kind, fx), _layout(kind, xm)
    for v, x in zip(views, (fx, xm)):
        assert torch.equal(v, x)
        assert (v.stride(-1) == 1) == (kind != "conv3d_channel_first")
    ref = slice_attention_fused(fx, xm, ws, bs, temp, wq, wk, wv)
    out = slice_attention_fused(*views, ws.t().contiguous().t(), bs, temp,
                                wq, wk, wv)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_fused_result_reads_as_rows_without_copy(dtype):
    """The result is the (B, H, N, D) view of (B, N, H·D) rows: the
    output projection's input ``out.transpose(1, 2).reshape(B, N, -1)`` is
    a view of the same memory."""
    args = [torch.as_tensor(a).to(dtype) for a in _inputs(2, 3, 40, 8, 16)]
    out = slice_attention_fused(*args)
    flat = out.transpose(1, 2).reshape(2, 40, -1)
    assert out.shape == (2, 3, 40, 8) and flat.is_contiguous()
    assert flat.data_ptr() == out.data_ptr()
    assert out.stride() == (40 * 24, 8, 24, 1)
    np.testing.assert_array_equal(
        flat.numpy(), slice_attention_plain(*args).transpose(1, 2)
        .reshape(2, 40, -1).numpy())


def test_kernel_view_passes_adjacent_channels_and_copies_others():
    x = torch.arange(2 * 3 * 10 * 4, dtype=torch.float64)
    heads = x.view(2, 10, 3, 4).transpose(1, 2)            # stride(-1) 1
    assert kernel_view(heads) is heads
    first = x.view(2, 3, 4, 10).transpose(2, 3)            # stride(-1) 10
    copied = kernel_view(first)
    assert copied.is_contiguous() and torch.equal(copied, first)
    assert copied.data_ptr() != first.data_ptr()
    one = x[:20].view(1, 1, 20, 1)
    assert kernel_view(one) is one
