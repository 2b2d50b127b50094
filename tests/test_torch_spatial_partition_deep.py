"""TPU.SPATIAL_PARTITION's banded res4 against the whole backbone's at
depth 26 with the 1x1-stride blocks: the depth-26 cases of
tests/test_torch_spatial_partition.py's grid, split from it so that each
file is a small share of one xdist worker."""

import pytest

from tests.test_torch_spatial_partition import BANDS, HW, check_banded


@pytest.mark.parametrize(**HW)
@pytest.mark.parametrize("stride_in_1x1", [True], ids=["stride1x1"])
@pytest.mark.parametrize("depth", [26])
@pytest.mark.parametrize(**BANDS)
def test_banded_res4_equals_unsplit(bands, depth, stride_in_1x1, hw):
    check_banded(bands, depth, stride_in_1x1, hw)
