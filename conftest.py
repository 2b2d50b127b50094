"""Repository-wide pytest hooks.

The `gate` tests (held-out generalization gates, 25-60 minutes each) are
deselected by ``pyproject.toml``'s ``addopts = "-m 'not gate'"``, but a
command-line ``-m`` replaces that default. So every `gate` item is also
marked `slow`: ``-m 'not slow'`` then leaves the gates out as well, and
``-m gate`` still selects them.
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running test, deselected by -m 'not slow'"
    )
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA card with the CUDA toolkit; skips without one",
    )


@pytest.hookimpl(tryfirst=True)
def pytest_collection_modifyitems(config, items):
    for item in items:
        if item.get_closest_marker("gate") is not None:
            item.add_marker(pytest.mark.slow)
