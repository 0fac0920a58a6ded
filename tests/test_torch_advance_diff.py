"""One 3-D bubble timestep of the port against varden_tpu's at 16^3 in
float64: the diffusive step (diff_coef 0.05), Crank-Nicolson and backward Euler,
held to 1e-9 of each field's size (test_torch_advance.py says why). A file
of its own, so that --dist loadfile spreads the viscous steps."""
import pytest
from test_torch_advance import VISC_COEFS, viscous_step_matches
from torch_inputs import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("diffusion_type", [1, 2])
@pytest.mark.parametrize("coefs", [VISC_COEFS[1]], ids=["coefs1"])
def test_advance_timestep_viscous_matches(coefs, diffusion_type):
    viscous_step_matches(coefs, diffusion_type)
