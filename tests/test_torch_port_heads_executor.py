"""The fused executor of a learned-padding NewFluidNet with the
``mae``/``mass`` heads and ``p_pred`` against JAX's
``FastNewFluidNet(megakernel=True)`` in Pallas interpret mode and the
Flax module, float64, at 1e-9: tests/test_torch_port_heads.py::
check_executor_head, whose module doc has the detail."""

import pytest

pytest.importorskip("jax")

from test_torch_port_heads import HEAD_IDS, HEADS, check_executor_head  # noqa: E402


@pytest.mark.parametrize("loss_type,p_pred", list(HEADS), ids=HEAD_IDS)
def test_executor_heads_match_jax_megakernel_and_module(loss_type, p_pred):
    check_executor_head(loss_type, p_pred, "learned")
