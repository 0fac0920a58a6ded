"""Varden.run of the 3-D bubble at 16^3 against varden_tpu's (float64, CPU;
initial projection, one pressure iteration, three steps) with the headline
configuration's viscosity (visc_coef 1e-3, Crank-Nicolson, dense bottoms),
held to 1e-9 of each field's size (test_torch_driver.py says why). A file
of its own, so that --dist loadfile spreads the driver runs."""
import pytest
from test_torch_driver import VISCOUS_RUNS, viscous_run_matches


@pytest.mark.parametrize("extra", [VISCOUS_RUNS["headline"]],
                         ids=["headline"])
def test_viscous_run_matches_three_steps(extra):
    viscous_run_matches(extra)
