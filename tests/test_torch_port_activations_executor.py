"""The fused executor of a learned-padding NewFluidNet with each of the
seven activations against the JAX package on the CPU, float64: the
port's ``FastNewFluidNet`` (its stages' plain versions) against JAX's
``FastNewFluidNet(megakernel=True)`` in Pallas interpret mode and against
the Flax module, levels=2, c_h=8, repeats=2 at 16×32, and its ``trunk``
against JAX's ``TrunkStack`` on the same branch outputs. The check and
its tolerances (1e-9; 1e-7 for ``sine``) are
tests/test_torch_port_activations.py::check_executor's."""

import pytest

pytest.importorskip("jax")

from test_torch_port_activations import ACTS, check_executor  # noqa: E402


@pytest.mark.parametrize("act", ACTS)
def test_executor_matches_jax_megakernel_and_module(act):
    check_executor(act, "learned")
