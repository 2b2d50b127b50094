"""The port's text-family heads trained against the JAX package's:
test_text_heads_train_like_jax on TRAIN_CASES[5:7] of
tests/test_torch_text_heads.py (every loss and gradient; split so that
each file is a small share of one xdist worker)."""

import pytest

from tests.test_torch_text_heads import TRAIN_CASES, check_train_case


@pytest.mark.parametrize("head,cosine", TRAIN_CASES[5:7])
def test_text_heads_train_like_jax(head, cosine):
    check_train_case(head, cosine)
