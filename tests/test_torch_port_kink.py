"""chip_smoke.py's loss-kink gate on the CPU: ``locate_kink`` accepts a
float32 train-step gradient above its bound only where abs() arguments of
the loss within rounding of 0 change sign and account for the whole
difference of the output gradient, and refuses a float32 fault confined
to a few pixels of the last conv's output, in its forward or in its
backward.

A small NewFluidNet (levels 2, repeats 1, 16×24, B = 2) from the same
seeds as phase 11 (e). A kink is planted by setting the target's u to the
float64 network's own u (rounded to float32) at 16 pixels: there the
boundary L1 term's argument is within an ulp of 0, and float32's
prediction falls on either side of it.
"""

import copy
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))

import chip_smoke  # noqa: E402

H, W = 16, 24
FIELDS = dict(network="newfluidnet", levels=2, repeats=1)
# FluidNet's cropped curl head leaves a mass residual that is 0 in exact
# arithmetic: rounding alone signs its abs() arguments, in either
# precision, and their flips do not reach the output gradient
FLUIDNET = dict(network="fluidnet", levels=2, repeats=1)
PIXELS = [(n % 2, 3 + n % 9, 4 + (5 * n) % 15) for n in range(16)]


def _net(fields=FIELDS):
    return chip_smoke.other_model(fields, "cpu", 0, H, W)


def _batch():
    g = torch.Generator().manual_seed(21)
    return (torch.rand(2, H, W, 7, generator=g),
            torch.randn(2, 2, H, W, generator=g))


def _planted(net, x, y):
    """``y`` with u set to the float64 network's u at :data:`PIXELS`."""
    with torch.no_grad():
        u = copy.deepcopy(net).double()(x.double())[0]
    y = y.clone()
    for b, i, j in PIXELS:
        y[b, 0, i, j] = u[b, i, j]
    return y


def _locate(net, x, y, name="newfluidnet"):
    return chip_smoke.locate_kink(net, x, y, name, "conv_3")


@pytest.mark.parametrize("fields", [FIELDS, FLUIDNET],
                         ids=["newfluidnet", "fluidnet"])
def test_rounding_crossed_kink_is_explained(fields):
    net = _net(fields)
    x, y = _batch()
    k = _locate(net, x, _planted(net, x, y), fields["network"])
    assert k["step_rel"] > chip_smoke.TOL_TRAIN_GRAD
    assert 0 < k["n_flips"] <= len(PIXELS)
    assert (k["n_flips_unreached"] > 0) == (fields is FLUIDNET)
    assert k["flip_arg_rel"] <= 1e-6
    assert k["unexplained_rel"] <= chip_smoke.KINK_ELSEWHERE
    assert k["verdict"] == "kink"


def test_no_flip_is_no_kink():
    x, y = _batch()
    k = _locate(_net(), x, y)
    assert k["step_rel"] <= chip_smoke.TOL_TRAIN_GRAD
    assert k["n_flips"] == 0 and k["verdict"] != "kink"


def _fault(net, forward: bool):
    """A float32 fault confined to 3 pixels of ``conv_3``'s output: a
    large error in its value (forward) or in its gradient (backward);
    float64 copies of ``net`` are left as they are."""
    pix = (1, 0, 7, slice(10, 13))

    def bump(t, size):
        b = torch.zeros_like(t)
        b[pix] = size * float(t.detach().abs().max())
        return b

    def hook(mod, inp, out):
        if out.dtype != torch.float32:
            return None
        if forward:
            return out + bump(out, 10.0)
        out.register_hook(lambda g: g + bump(g, 0.2))
        return None
    net.conv_3.register_forward_hook(hook)
    return net


@pytest.mark.parametrize("forward", [True, False],
                         ids=["forward", "backward"])
def test_float32_fault_at_few_pixels_is_no_kink(forward):
    x, y = _batch()
    net = _net()
    y = _planted(net, x, y)
    k = _locate(_fault(net, forward), x, y)
    assert k["step_rel"] > chip_smoke.TOL_TRAIN_GRAD
    assert k["verdict"] != "kink"
    # the gate this one replaced (the backward given float32's output
    # gradient, that gradient's jumps confined) took the backward fault
    if not forward:
        assert k["fed_vs_f32_rel"] <= chip_smoke.TOL_TRAIN_GRAD
        assert k["n_jumps"] <= chip_smoke.KINK_PIXELS


def test_phase_option():
    with pytest.raises(SystemExit):
        chip_smoke.main(["--phase", "3"])
    if not torch.cuda.is_available():
        assert chip_smoke.main(["--phase", "11"]) == 1
