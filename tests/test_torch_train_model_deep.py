"""The whole tiny detector's training losses and gradients against the
JAX package's, TRAIN_CASES[2:] of tests/test_torch_train_model.py (the
3x3-stride backbone and depth 26); split from that file so that each
file is a small share of one xdist worker."""

import pytest

from tests.test_torch_train_model import TRAIN_CASES, check_train_case


@pytest.mark.parametrize("depth,stride_in_1x1,padded", TRAIN_CASES[2:])
def test_train_losses_and_gradients_match_jax(depth, stride_in_1x1, padded):
    check_train_case(depth, stride_in_1x1, padded)
