"""The port's own config copy loads every YAML of ``configs/`` to the same
values as the JAX package's config, and refuses files of another VERSION."""

import glob
import os

import pytest

from fewshotobjectdetection_imporove_via_text_feature_torch.config import (
    get_cfg,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.config import (
    get_cfg as jax_get_cfg,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(
    os.path.relpath(p, ROOT)
    for p in glob.glob(os.path.join(ROOT, "configs", "**", "*.yaml"),
                       recursive=True)
)


def test_defaults_equal_jax_but_run_on_the_card():
    port, ref = get_cfg(), jax_get_cfg()
    assert port.MODEL.DEVICE == "cuda"
    port.MODEL.DEVICE = ref.MODEL.DEVICE
    assert port.dump() == ref.dump()


@pytest.mark.parametrize("path", CONFIGS)
def test_every_config_file_loads_as_in_jax(path):
    port, ref = get_cfg(), jax_get_cfg()
    port.merge_from_file(os.path.join(ROOT, path))
    ref.merge_from_file(os.path.join(ROOT, path))
    port.MODEL.DEVICE = ref.MODEL.DEVICE
    assert port.dump() == ref.dump()


def test_other_config_versions_and_unknown_keys_raise(tmp_path):
    base = os.path.join(ROOT, "configs", "Base-RCNN.yaml")
    v1 = tmp_path / "v1.yaml"
    v1.write_text(f"_BASE_: {base}\nVERSION: 1\n")
    with pytest.raises(ValueError, match="VERSION 1"):
        get_cfg().merge_from_file(str(v1))
    typo = tmp_path / "typo.yaml"
    typo.write_text(f"_BASE_: {base}\nMODEL:\n  RPN:\n    NMS_THRES: 0.5\n")
    with pytest.raises(KeyError, match="NMS_THRES"):
        get_cfg().merge_from_file(str(typo))
