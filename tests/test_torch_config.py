"""The port's own config copy loads every YAML of ``configs/`` to the same
values as the JAX package's config, converts detectron2 VERSION 0/1 files
as the JAX package's ``config/compat.py`` does, and refuses a VERSION above
the latest and unknown keys."""

import copy
import glob
import os

import pytest

from fewshotobjectdetection_imporove_via_text_feature_torch.config import (
    compat,
    get_cfg,
)
from fewshotobjectdetection_imporove_via_text_feature_tpu.config import (
    compat as jax_compat,
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


def _both_load(path):
    """The file merged into both packages' defaults, the port's device set
    to the JAX package's: (port dump, JAX dump)."""
    port, ref = get_cfg(), jax_get_cfg()
    port.merge_from_file(str(path))
    ref.merge_from_file(str(path))
    port.MODEL.DEVICE = ref.MODEL.DEVICE
    return port, ref


# the V0 and V1 YAMLs of tests/test_events_compat.py, and a dump of an
# older run carrying a removed key
OLD_FILES = {
    "v0": ("VERSION: 0\n"
           "MODEL:\n"
           "  RPN_HEAD:\n"
           "    NAME: StandardRPNHead\n"
           "  RPN:\n"
           "    RPN_STRADDLE_THRESH: 0\n"),
    "v1_guessed": ("MODEL:\n"
                   "  WEIGHT: ''\n"
                   "  ROI_HEADS:\n"
                   "    SCORE_THRESH: 0.11\n"
                   "TEST:\n"
                   "  AUG_ON: false\n"
                   "  DETECTIONS_PER_IMG: 55\n"),
    "v2_removed_key": ("VERSION: 2\n"
                       "TPU:\n"
                       "  MESH_DATA_AXIS: data\n"
                       "  ROI_CHUNK: 128\n"),
}


@pytest.mark.parametrize("name", sorted(OLD_FILES))
def test_old_config_files_load_as_in_jax(tmp_path, name):
    path = tmp_path / f"{name}.yaml"
    path.write_text(OLD_FILES[name])
    port, ref = _both_load(path)
    assert port.dump() == ref.dump()
    assert port.VERSION == 2
    if name == "v0":
        assert port.MODEL.RPN.HEAD_NAME == "StandardRPNHead"
        assert port.MODEL.RPN.BOUNDARY_THRESH == 0
    elif name == "v1_guessed":
        assert port.MODEL.ROI_HEADS.SCORE_THRESH_TEST == 0.11
        assert port.TEST.DETECTIONS_PER_IMAGE == 55
    else:
        assert port.TPU.ROI_CHUNK == 128
        assert "MESH_DATA_AXIS" not in port.TPU


# the dicts of tests/test_events_compat.py: a V0 file with the straddle
# alias, the full ConverterV2 table at V1, and a V2 file with a removed key
CONVERT_DICTS = {
    "v0": {"VERSION": 0,
           "MODEL": {"RPN_HEAD": {"NAME": "StandardRPNHead"},
                     "RPN": {"RPN_STRADDLE_THRESH": 0}}},
    "v1": {"VERSION": 1,
           "MODEL": {"META_ARCHITECTURE": "GeneralizedRCNN",
                     "WEIGHT": "x.pkl",
                     "ROI_HEADS": {"SCORE_THRESH": 0.07, "NMS": 0.6},
                     "RPN": {"ANCHOR_SIZES": [[64, 128]],
                             "ANCHOR_ASPECT_RATIOS": [[0.5, 1.0]]}},
           "TEST": {"DETECTIONS_PER_IMG": 77, "AUG_ON": True,
                    "AUG_MIN_SIZES": [400, 500], "AUG_MAX_SIZE": 4000,
                    "AUG_FLIP": False}},
    "v1_retinanet": {"VERSION": 1,
                     "MODEL": {"META_ARCHITECTURE": "RetinaNet",
                               "RETINANET": {"ANCHOR_SIZES": [[32]],
                                             "ANCHOR_STRIDES": [8]},
                               "RPN": {"ANCHOR_SIZES": [[64]]}}},
    "v2": {"VERSION": 2,
           "MODEL": {"RPN": {"NMS_THRESH": 0.7,
                             "RPN_STRADDLE_THRESH": -1}},
           "TPU": {"MESH_DATA_AXIS": "data"}},
}


@pytest.mark.parametrize("name", sorted(CONVERT_DICTS))
def test_upgrade_and_downgrade_equal_jax(name):
    d = CONVERT_DICTS[name]
    up = compat.upgrade_config(copy.deepcopy(d))
    assert up == jax_compat.upgrade_config(copy.deepcopy(d))
    assert up["VERSION"] == compat.LATEST_VERSION == jax_compat.LATEST_VERSION
    assert "TPU" not in up  # the removed key and its emptied parent
    for to in range(up["VERSION"], -1, -1):
        down = compat.downgrade_config(copy.deepcopy(up), to_version=to)
        assert down == jax_compat.downgrade_config(copy.deepcopy(up),
                                                   to_version=to)
        assert down["VERSION"] == to


@pytest.mark.parametrize("old_version", [0, 1, 2])
def test_upgrade_of_downgraded_defaults_is_the_defaults(old_version):
    full = copy.deepcopy(dict(get_cfg()))
    down = compat.downgrade_config(copy.deepcopy(full),
                                   to_version=old_version)
    jax_down = jax_compat.downgrade_config(copy.deepcopy(full),
                                           to_version=old_version)
    assert down == jax_down
    if old_version <= 1:
        assert down["MODEL"]["WEIGHT"] == full["MODEL"]["WEIGHTS"]
        assert "WEIGHTS" not in down["MODEL"]
    assert compat.upgrade_config(down) == full


def test_guess_version_and_pruning_equal_jax():
    for d in ({"MODEL": {"WEIGHT": "x"}}, {"TEST": {"AUG_ON": True}},
              {"MODEL": {"WEIGHTS": "x"}}, {}):
        assert compat.guess_version(d) == jax_compat.guess_version(d)
    assert compat.guess_version({"MODEL": {"WEIGHT": "x"}}) == 1
    d = {"TPU": {"MESH_DATA_AXIS": "data", "ROI_CHUNK": 64},
         "MODEL": {"RPN": {"RPN_STRADDLE_THRESH": 0}}}
    got = compat.prune_removed_keys(copy.deepcopy(d))
    assert got == jax_compat.prune_removed_keys(copy.deepcopy(d))
    assert got == {"TPU": {"ROI_CHUNK": 64},
                   "MODEL": {"RPN": {"BOUNDARY_THRESH": 0}}}


@pytest.mark.parametrize("case", ["version_1", "version_3", "unknown_key"])
def test_other_config_versions_and_unknown_keys_raise(tmp_path, case):
    """A VERSION 1 file converts to the JAX package's values; a VERSION
    above the latest raises ValueError and an unknown key KeyError, in
    both packages."""
    base = os.path.join(ROOT, "configs", "Base-RCNN.yaml")
    path = tmp_path / f"{case}.yaml"
    if case == "version_1":
        # the base chain is VERSION 2; the file's own VERSION 1 and a V1
        # spelling win over it
        path.write_text(f"_BASE_: {base}\nVERSION: 1\n"
                        "MODEL:\n  ROI_HEADS:\n    NMS: 0.4\n")
        port, ref = _both_load(path)
        assert port.dump() == ref.dump()
        assert port.MODEL.ROI_HEADS.NMS_THRESH_TEST == 0.4
        return
    if case == "version_3":
        path.write_text(f"_BASE_: {base}\nVERSION: 3\n")
        err, match = ValueError, "v2 to v3"
    else:
        path.write_text(f"_BASE_: {base}\nMODEL:\n  RPN:\n"
                        "    NMS_THRES: 0.5\n")
        err, match = KeyError, "NMS_THRES"
    with pytest.raises(err, match=match):
        get_cfg().merge_from_file(str(path))
    with pytest.raises(err, match=match):
        jax_get_cfg().merge_from_file(str(path))
