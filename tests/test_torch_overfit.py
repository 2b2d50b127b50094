"""The port's learning checks against the JAX package's tools, on the CPU:
the overfit set's maker and recall, the generalization VOC maker, the
checks' configs key by key, PCB's window rule, and plumbing runs of
``overfit_map_check`` and ``overfit_distill_check`` at a handful of
iterations (``soak_test --tiny``'s is in ``test_torch_overfit_soak.py``).

The full tiny checks (500 and 600 + 700 iterations) take minutes on the
CPU: they are `gate` tests, left out of Tier-1's ``-m 'not slow'``.
"""

import importlib
import json
import os
import pathlib
import sys

import numpy as np
import pytest
from PIL import Image

from fewshotobjectdetection_imporove_via_text_feature_torch.tools import (
    make_generalization_voc as port_gen_voc,
    overfit_distill_check as port_distill,
    overfit_map_check as port_map,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent


class _Stop(Exception):
    """Raised by the stand-in Trainer once the JAX tool's config is built."""


@pytest.fixture
def jax_tools(monkeypatch):
    """The repository's ``tools/`` modules, importable as the JAX tools
    import each other, with no persistent compilation cache."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "")
    monkeypatch.syspath_prepend(str(ROOT))
    monkeypatch.syspath_prepend(str(ROOT / "tools"))

    def load(name):
        return importlib.import_module(name)

    return load


def _files(root):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*")
                  if p.is_file())


def _same_tree(a, b):
    """Every file under ``a`` and ``b``: the same names, text files equal,
    JPEGs decoding to equal pixels."""
    assert _files(a) == _files(b)
    assert _files(a)
    for rel in _files(a):
        if rel.endswith(".jpg"):
            pa = np.asarray(Image.open(a / rel))
            pb = np.asarray(Image.open(b / rel))
            np.testing.assert_array_equal(pa, pb, err_msg=rel)
        else:
            assert (a / rel).read_bytes() == (b / rel).read_bytes(), rel


def test_make_visual_voc_writes_the_jax_tool_s_files(tmp_path, jax_tools):
    jax_map = jax_tools("overfit_map_check")
    jax_map.make_visual_voc(str(tmp_path / "jax"))
    port_map.make_visual_voc(str(tmp_path / "port"))
    _same_tree(tmp_path / "jax", tmp_path / "port")
    assert len(list((tmp_path / "port" / "VOC2007" / "Annotations")
                    .glob("*.xml"))) == 6


def test_make_generalization_voc_writes_the_jax_tool_s_files(
        tmp_path, jax_tools, monkeypatch):
    """The soak's sizes (16 + 8 train, 4 held out), the 1-shot files of
    two seeds."""
    jax_gen = jax_tools("_make_generalization_voc")
    argv = ["--train-2007", "16", "--train-2012", "8", "--val", "4",
            "--shots", "1", "--seed", "0", "1"]
    monkeypatch.setattr(sys, "argv", ["x", "--root", str(tmp_path / "jax"),
                                      *argv])
    jax_gen.main()
    port_gen_voc.main(["--root", str(tmp_path / "port"), *argv])
    _same_tree(tmp_path / "jax", tmp_path / "port")
    with pytest.raises(ValueError, match="too few train images"):
        port_gen_voc.make_generalization_voc(
            str(tmp_path / "short"), train_2007=4, train_2012=0, val=1)


def _det(fid, cid, box, score=0.9):
    x1, y1, x2, y2 = box
    return {"image_id": fid, "category_id": cid,
            "bbox": [x1, y1, x2 - x1, y2 - y1], "score": score}


def test_memorized_set_recall_equals_the_jax_tool_s(tmp_path, jax_tools):
    """Hand-made detections over the overfit set: exact hits, a
    wrong-class hit, a box that misses, and an image with no detection,
    whose objects count as misses."""
    import xml.etree.ElementTree as ET

    jax_map = jax_tools("overfit_map_check")
    d = port_map.make_visual_voc(str(tmp_path))
    anno = os.path.join(d, "Annotations")
    name_to_id = {"dog": 11, "cat": 7, "bird": 2}
    gts = {}
    for fn in sorted(os.listdir(anno)):
        for obj in ET.parse(os.path.join(anno, fn)).findall("object"):
            bb = obj.find("bndbox")
            box = [float(bb.find(t).text) for t in
                   ("xmin", "ymin", "xmax", "ymax")]
            box[0] -= 1
            box[1] -= 1
            gts.setdefault(fn[:-4], []).append((obj.find("name").text, box))
    dets = []
    for fid, objs in gts.items():
        if fid == "000005":
            continue  # no detection on this image: 3 misses
        for name, box in objs:
            if fid == "000001" and name == "cat":
                # the cat's box under the dog's id: a wrong-class hit
                dets.append(_det(fid, name_to_id["dog"], box))
            elif fid == "000002" and name == "bird":
                # shifted by most of its width: IoU below 0.5
                w = box[2] - box[0]
                dets.append(_det(fid, name_to_id[name],
                                 [box[0] + 0.7 * w, box[1],
                                  box[2] + 0.7 * w, box[3]]))
            else:
                dets.append(_det(fid, name_to_id[name], box))
    got = port_map.memorized_set_recall(dets, anno, name_to_id)
    assert got == jax_map.memorized_set_recall(dets, anno, name_to_id)
    assert got == (18 - 3 - 1 - 1, 18)
    assert port_map.memorized_set_recall([], anno, name_to_id) == (0, 18)


def _flat(node, prefix=""):
    out = {}
    for k, v in node.items():
        if hasattr(v, "items"):
            out.update(_flat(v, prefix + k + "."))
        else:
            out[prefix + k] = v
    return out


def _assert_same_config(jax_cfg, port_cfg):
    """Every key of the two configs equal but MODEL.DEVICE; MODEL.WEIGHTS
    up to its extension (the JAX package's checkpoints are ``.ckpt``, this
    package's ``.pth``)."""
    a, b = _flat(jax_cfg), _flat(port_cfg)
    assert set(a) == set(b)
    for cfg in (a, b):
        cfg.pop("MODEL.DEVICE")
        cfg["MODEL.WEIGHTS"] = os.path.splitext(cfg["MODEL.WEIGHTS"])[0]
    diff = {k: (a[k], b[k]) for k in a if a[k] != b[k]}
    assert not diff


def _capture_jax_configs(monkeypatch, tmp_path, run, stop_at):
    """The configs the JAX tool hands to its Trainers, up to the
    ``stop_at``-th: a stand-in Trainer records each and writes
    ``model_final.ckpt`` when trained; every temporary root is
    ``tmp_path``."""
    import tempfile

    from fewshotobjectdetection_imporove_via_text_feature_tpu import engine
    from fewshotobjectdetection_imporove_via_text_feature_tpu.data import (
        DatasetCatalog,
    )

    seen = []

    class Recording:
        def __init__(self, cfg):
            seen.append(cfg.clone())
            self.cfg = cfg
            if len(seen) == stop_at:
                raise _Stop

        def train(self):
            os.makedirs(self.cfg.OUTPUT_DIR, exist_ok=True)
            pathlib.Path(self.cfg.OUTPUT_DIR, "model_final.ckpt").touch()

    monkeypatch.setattr(engine, "Trainer", Recording)
    monkeypatch.setattr(DatasetCatalog, "_registry",
                        dict(DatasetCatalog._registry))
    monkeypatch.setattr(tempfile, "mkdtemp", lambda: str(tmp_path))
    with pytest.raises(_Stop):
        run()
    return seen


@pytest.mark.parametrize("production,head", [
    (False, None), (True, None), (False, "SematicRes5ROIHeads"),
    (True, "TextRes5ROIHeads")])
def test_overfit_map_check_configs_equal_the_jax_tool_s(
        tmp_path, jax_tools, monkeypatch, production, head):
    jax_map = jax_tools("overfit_map_check")
    (jax_cfg,) = _capture_jax_configs(
        monkeypatch, tmp_path,
        lambda: jax_map.main(production=production, head=head), 1)
    port_cfg = port_map.overfit_cfg(str(tmp_path), production, head)
    assert port_cfg.MODEL.DEVICE == "cuda"
    _assert_same_config(jax_cfg, port_cfg)


@pytest.mark.parametrize("production", [False, True])
def test_overfit_distill_check_configs_equal_the_jax_tool_s(
        tmp_path, jax_tools, monkeypatch, production):
    jax_distill = jax_tools("overfit_distill_check")
    monkeypatch.setenv("FSODTF_OVERFIT_SEED", "17")
    jax1, jax2 = _capture_jax_configs(
        monkeypatch, tmp_path,
        lambda: jax_distill.main(production=production), 2)
    root = str(tmp_path)
    port1 = port_distill.stage1_cfg(root, production)
    weights = os.path.join(port1.OUTPUT_DIR, "model_final.pth")
    port2 = port_distill.stage2_cfg(root, production, weights)
    assert port1.SEED == port2.SEED == 17
    _assert_same_config(jax1, port1)
    _assert_same_config(jax2, port2)


def test_pcb_window_check_accepts_in_window_rescoring_only():
    lower, upper = 0.05, 1.0
    base = [_det("a", 1, (0, 0, 10, 10), 0.5),
            _det("a", 2, (5, 5, 20, 20), 0.01),  # below the window
            _det("b", 1, (1, 1, 9, 9), 0.97)]
    rescored = [dict(base[0], score=0.61), dict(base[1]),
                dict(base[2], score=0.9)]
    assert port_map.pcb_window_check(base, rescored, lower, upper) == (2, 2)
    # an out-of-window score that moved
    moved = [dict(rescored[0]), dict(base[1], score=0.02),
             dict(rescored[2])]
    with pytest.raises(AssertionError, match="outside its window"):
        port_map.pcb_window_check(base, moved, lower, upper)
    # a detection set that changed
    with pytest.raises(AssertionError, match="detection set"):
        port_map.pcb_window_check(base, rescored[:2], lower, upper)
    # nothing rescored
    with pytest.raises(AssertionError, match="altered no in-window"):
        port_map.pcb_window_check(base, [dict(d) for d in base], lower,
                                  upper)


def _json_line(text):
    return json.loads([ln for ln in text.splitlines()
                       if ln.startswith("{")][-1])


def test_overfit_map_check_fails_an_untrained_detector(capsys):
    """Plumbing on the CPU: 3 steps of the tiny check train, evaluate,
    print the JSON line and fail the recall assert."""
    with pytest.raises(AssertionError, match="overfit recall too low"):
        port_map.main(["--device", "cpu", "--opts", "SOLVER.MAX_ITER", "3"])
    out = _json_line(capsys.readouterr().out)
    assert out["device"] == "cpu" and out["total"] == 18
    assert out["recall"] < port_map.RECALL_MIN
    assert np.isfinite([out["ap50"], out["wall_s"], out["step_ms_median"]
                        ]).all()


@pytest.mark.gate
def test_tiny_overfit_map_check_passes_with_pcb():
    out = port_map.main(["--device", "cpu", "--pcb"])
    assert out["recall"] >= port_map.RECALL_MIN and out["ap50"] > 12.0
    assert out["pcb_rescored"] > 0


@pytest.mark.gate
def test_tiny_overfit_distill_check_passes():
    out = port_distill.main(["--device", "cpu"])
    assert out["recall"] >= port_map.RECALL_MIN and out["ap50"] > 12.0
