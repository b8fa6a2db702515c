"""Operations and bytes of the NewFluidNet forward, counted from the
model's own shapes (pytorch_networks_convae.py:1068-1386), never from
how a kernel runs them.

A k×k conv of c_in → c_out channels over an h × w field is 2·h·w·c_in·
c_out·k² operations (a multiply and an add per tap); the learned-boundary
conv applies one k×k kernel at every output point, so it counts the
same. The bicubic resize of a coarse level is separable, 4 taps along
each axis. GroupNorm, the activation and the pooling are left out (a few
operations per value, under 0.2% of the convs). Bytes count every input,
weight and output of a call once, in float32.
"""

from __future__ import annotations

F32 = 4


def out_channels(m: dict) -> int:
    """Merge 3's channels: u, v, p less one for the curl head (the stream
    function) and one without the pressure output (multigpu.py:1072)."""
    return 3 - (m["loss_type"] == "curl") - (not m["p_pred"])


def _levels(m: dict, H: int, W: int):
    return [(H // 2 ** l, W // 2 ** l) for l in range(m["levels"])]


def _conv_flops(h, w, c_in, c_out, k):
    return 2 * h * w * c_in * c_out * k * k


def _conv_weights(c_in, c_out, k, learned=True):
    """Values of one layer's conv and norm: 9 kernels under learned
    padding (1 otherwise), its bias, the GroupNorm's scale and shift."""
    return (9 if learned else 1) * c_in * c_out * k * k + 3 * c_out


def layer_stack(m: dict, H: int, W: int) -> tuple:
    """(operations, bytes) of one step's four ``layer_stack`` calls: the
    stem (with the pooled pyramid it emits), the branches of every level,
    merge 2 and merge 3."""
    c_i, c_h, c_o, k = 7, m["c_h"], out_channels(m), m["kernel"]
    lv = _levels(m, H, W)
    px0 = H * W
    px_all = sum(h * w for h, w in lv)
    flops = _conv_flops(H, W, c_i, c_h, k)
    flops += sum(m["repeats"] * _conv_flops(h, w, c_h, c_h, k)
                 for h, w in lv)
    flops += _conv_flops(H, W, c_h, c_h, k) + _conv_flops(H, W, c_h, c_o, k)
    vals = (c_i * px0 + c_h * px_all + _conv_weights(c_i, c_h, k)   # stem
            + 2 * c_h * px_all                                      # branches
            + len(lv) * m["repeats"] * _conv_weights(c_h, c_h, k)
            + 2 * c_h * px0 + _conv_weights(c_h, c_h, k)            # merge 2
            + (c_h + c_o) * px0 + _conv_weights(c_h, c_o, k))       # merge 3
    return flops, vals * F32


def trunk(m: dict, H: int, W: int) -> tuple:
    """(operations, bytes) of one ``trunk`` call: the coarse levels'
    bicubic upsampling, the concat with level 0 and the input, merge 1
    and its GroupNorm and activation."""
    c_i, c_h, k = 7, m["c_h"], m["kernel"]
    lv = _levels(m, H, W)
    c_cat = c_h * len(lv) + c_i
    flops = _conv_flops(H, W, c_cat, c_h, k)
    flops += sum(2 * 4 * c_h * (H * w + H * W) for _, w in lv[1:])
    vals = (c_h * sum(h * w for h, w in lv) + c_i * H * W
            + _conv_weights(c_cat, c_h, k) + c_h * H * W)
    return flops, vals * F32


def forward_flops(m: dict, H: int, W: int) -> int:
    """Operations of one sample's forward."""
    return layer_stack(m, H, W)[0] + trunk(m, H, W)[0]


def train_step_flops(m: dict, H: int, W: int, batch: int) -> int:
    """Operations of one train step: the forward and a backward of twice
    its operations (gradients of the inputs and of the weights)."""
    return 3 * batch * forward_flops(m, H, W)
