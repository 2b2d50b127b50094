"""The multi-device dry run (``…_torch/tools/dryrun_multidevice.py``) at 2
and 4 CPU ranks; split from tests/test_torch_multiprocess_cli.py so that
each file is a small share of one xdist worker."""

import pytest

from fewshotobjectdetection_imporove_via_text_feature_torch.tools import (
    dryrun_multidevice,
)


@pytest.mark.parametrize("ranks", [2, 4])
def test_dryrun_multidevice(tmp_path, capsys, ranks):
    assert dryrun_multidevice.main(["--ranks", str(ranks), "--workdir",
                                    str(tmp_path)]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1] == "dryrun_multidevice: ok"
    assert any(f"mesh ({ranks // 2}, 2)" in ln for ln in lines)
