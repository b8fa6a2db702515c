"""The count functions against counts made by hand from the published
shapes."""

from benchmarks.counts import newfluidnet as nfn
from benchmarks.counts import transolver as tr

FLAG = dict(levels=5, c_h=16, repeats=6, kernel=5, loss_type="curl",
            p_pred=False)
TRANS = dict(H=128, W=506, n_hidden=128, n_head=8, slice_num=32,
             mlp_ratio=1, n_layers=5, kernel_proj=3, space_dim=2,
             fun_dim=5, out_dim=1)
N = 128 * 506


def test_one_blocks_projections():
    assert tr.projections_flops(TRANS) == 2 * 2 * 9 * 128 * 128 * N


def test_slice_kernels_bytes():
    BH, D, G = 8, 16, 32
    pool = 2 * BH * N * D + D * G + G + 8 + BH * G * (D + 1)
    deslice = BH * N * D + BH * G * D + D * G + G + 8 + BH * N * D
    assert tr.slice_pool(TRANS)[1] == 4 * pool
    assert tr.slice_deslice(TRANS)[1] == 4 * deslice
    assert tr.slice_pool(TRANS)[0] == 4 * BH * N * D * G


def test_flagship_layer_stack_and_trunk():
    px = [128 * 506, 64 * 253, 32 * 126, 16 * 63, 8 * 31]
    mac = (px[0] * 7 * 16 * 25 + 6 * sum(px) * 16 * 16 * 25
           + px[0] * 16 * 16 * 25 + px[0] * 16 * 1 * 25)
    assert nfn.layer_stack(FLAG, 128, 506)[0] == 2 * mac
    merge1 = px[0] * (16 * 5 + 7) * 16 * 25
    resize = sum(4 * 16 * (128 * w + 128 * 506)
                 for w in (253, 126, 63, 31))
    assert nfn.trunk(FLAG, 128, 506)[0] == 2 * (merge1 + resize)
    total = nfn.forward_flops(FLAG, 128, 506)
    assert 12.3e9 < total < 12.5e9
    assert nfn.train_step_flops(FLAG, 128, 506, 8) == 24 * total


def test_flagship_bytes_read_each_value_once():
    px0, px_all = 128 * 506, 128 * 506 + 64 * 253 + 32 * 126 + 16 * 63 + 8 * 31
    w = lambda ci, co: 9 * ci * co * 25 + 3 * co  # noqa: E731
    vals = (7 * px0 + 16 * px_all + w(7, 16) + 2 * 16 * px_all
            + 30 * w(16, 16) + 2 * 16 * px0 + w(16, 16) + 17 * px0
            + w(16, 1))
    assert nfn.layer_stack(FLAG, 128, 506)[1] == 4 * vals


def test_transolver_forward_total():
    total = tr.forward_flops(TRANS)
    assert 5 * tr.projections_flops(TRANS) / total > 0.8
    assert 2.3e11 < total < 2.45e11
