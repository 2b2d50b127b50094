"""3 SGD steps of the port's tiny model against the JAX package's
``make_train_step`` under the gfsod gradient contract: the gfsod case of
tests/test_torch_solver_steps.py, split from it so that each file is a
small share of one xdist worker."""

import pytest

from tests.test_torch_solver_steps import check_three_steps


@pytest.mark.parametrize("contract", ["gfsod"])
def test_three_sgd_steps_match_jax_make_train_step(contract):
    check_three_steps(contract)
