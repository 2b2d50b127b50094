"""The repository's entry points on the PyTorch port, held against the JAX
package's originals on the same inputs (CPU, no card):

- every root ``run_*.sh`` and ``tools/run_real_*.sh``: the port's copy
  under ``…_torch/tools/`` issues the same sequence of calls, traced by
  running both scripts with ``python`` and ``rm`` replaced by shell
  functions that record their arguments. The only differences allowed:
  ``main.py`` and the root tools become ``python -m`` of the port,
  ``.ckpt`` becomes ``.pth`` and every CLI call ends in ``MODEL.DEVICE
  ${DEVICE}``; the ``--opts`` pairs, parsed as
  ``tests/test_run_script_combos.py`` parses them, are the same and merge
  into the port's config;
- ``generate_class_embeddings``: byte-identical trees, synthetic and
  ``--from-npz``;
- the preflights: the same report, item by item, and exit code, on
  ``tests/test_preflight.py``'s blob names, synthetic VOC and COCO trees
  and tiny seeded weight files. The port's R-101 check also holds each
  blob's shape to the port's R-101 detector (its importer skips a tensor
  of another shape), so the files it accepts hold R-101's shapes; the
  blobs carry no bytes (a dtype of no fields), since only names and
  shapes are read. On test_preflight's own 1x1 blobs, which the JAX
  package accepts, the port refuses: that one difference is asserted;
- the visualizers: equal images and an equal similarity figure from the
  same predictions on synthetic VOC;
- ``bash -n`` of every new script; what ``validate_all.sh`` names.

A plumbing run of ``run_text_train_teacher.sh`` then ``run_visualize.sh``
is in tests/test_torch_entry_points_plumbing.py.
"""

import json
import os
import pathlib
import pickle
import re
import runpy
import shlex
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = "fewshotobjectdetection_imporove_via_text_feature_torch"
TOOLS = ROOT / PORT / "tools"

# root script -> its port copy
SCRIPTS = {p.name: p.name for p in sorted(ROOT.glob("run_*.sh"))}
SCRIPTS.update({f"tools/{n}": n for n in ("run_real_voc.sh",
                                          "run_real_coco.sh")})
# the root tools a JAX-package script calls, and the port module that
# takes each one's place
PORTED_TOOLS = {
    "main.py": f"{PORT}.cli",
    "tools/model_surgery.py": f"{PORT}.tools.model_surgery",
    "tools/preflight_real_voc.py": f"{PORT}.tools.preflight_real_voc",
    "tools/preflight_real_coco.py": f"{PORT}.tools.preflight_real_coco",
    "visualize_json_results.py": f"{PORT}.tools.visualize_json_results",
}
# an argument per script: the defaults, then other names, splits, shots
# and seeds
ARGS = {"tools/run_real_voc.sh": ["2", "5", "1", "3"],
        "tools/run_real_coco.sh": ["30", "2", "4"]}
WEIGHT_ENV = {"IMAGENET_PRETRAIN": "w/a.pkl", "PCB_PRETRAIN": "w/b.pth",
              "PCB_PATH": "w/c.pth", "TEACHER_WEIGHTS": "w/t.pth"}

_STUBS = r"""
python() { printf '%q ' python "$@" >> "$CALLS"; printf '\n' >> "$CALLS"; }
rm() { printf '%q ' rm "$@" >> "$CALLS"; printf '\n' >> "$CALLS"; }
export -f python rm
"""


def _trace(script, args, cwd, env):
    """The calls ``script`` makes, each an argv list, with ``python`` and
    ``rm`` recorded instead of run."""
    calls = cwd / "calls.txt"
    calls.write_text("")
    run = subprocess.run(
        ["bash", "-c", _STUBS + 'bash "$@"', "trace", str(script), *args],
        cwd=str(cwd), env=dict(os.environ, CALLS=str(calls), **env),
        capture_output=True, text=True, timeout=60)
    assert run.returncode == 0, (script, run.stderr[-2000:])
    return [shlex.split(ln) for ln in calls.read_text().splitlines()]


def _as_port(call, device):
    """A JAX-package script's call as the port's copy must make it."""
    call = [a.replace(".ckpt", ".pth") for a in call]
    if call[0] == "python" and call[1] in PORTED_TOOLS:
        module = PORTED_TOOLS[call[1]]
        call = ["python", "-m", module, *call[2:]]
        if module == f"{PORT}.cli":
            call += ["MODEL.DEVICE", device]
    return call


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_port_script_makes_the_same_calls(script, tmp_path):
    pkg, port = ROOT / script, TOOLS / SCRIPTS[script]
    cases = [([], {}, "cuda"),
             (ARGS.get(script, ["myexp", "2"]), WEIGHT_ENV, "cuda"),
             ([], {"DEVICE": "cpu"}, "cpu")]
    for args, env, device in cases:
        env = {**env, "SAVE_DIR": str(tmp_path / "save")}
        want = [_as_port(c, device)
                for c in _trace(pkg, args, tmp_path, env)]
        got = _trace(port, args, tmp_path, env)
        assert got == want, (script, args, env)
        clis = [c for c in got if c[:3] == ["python", "-m", f"{PORT}.cli"]]
        assert clis and all(c[-2:] == ["MODEL.DEVICE", device]
                            for c in clis)
    if "run_real" in script:
        # a base checkpoint in place: both skip the base training
        base = tmp_path / "save" / ("defrcn_det_r101_base" + (
            "1" if "voc" in script else ""))
        base.mkdir(parents=True)
        (base / "model_final.ckpt").touch()
        (base / "model_final.pth").touch()
        env = {"SAVE_DIR": str(tmp_path / "save")}
        want = [_as_port(c, "cuda") for c in _trace(pkg, [], tmp_path, env)]
        assert _trace(port, [], tmp_path, env) == want
        assert not [c for c in want if c[:3] == ["python", "-m",
                                                 f"{PORT}.cli"]
                    and "base" in c[4]]

    # the --opts pairs as test_run_script_combos reads them, and the
    # port's config takes every one
    from test_run_script_combos import parse_script_pairs_from_text

    def pairs(path):
        lines = [ln.split("#", 1)[0] for ln in path.read_text().splitlines()]
        text = re.sub(r"\$\{[^}]*\}", "dummy", " ".join(lines))
        return parse_script_pairs_from_text(text.replace(".ckpt", ".pth"))

    device = ("MODEL.DEVICE", "dummy")
    got = pairs(port)
    assert device in got
    assert [p for p in got if p != device] == pairs(pkg)
    from fewshotobjectdetection_imporove_via_text_feature_torch.config import (
        get_cfg,
    )

    get_cfg().merge_from_list([x for kv in got if kv != device for x in kv])


# ------------------------------------------------------------ embeddings
def _tree(root):
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _run_root_tool(path, argv):
    saved = sys.argv
    sys.argv = [str(path), *argv]
    try:
        runpy.run_path(str(path), run_name="__main__")
    finally:
        sys.argv = saved


@pytest.mark.parametrize("model", ["glove", "clip"])
def test_generate_class_embeddings_writes_the_same_files(model, tmp_path):
    from fewshotobjectdetection_imporove_via_text_feature_torch.tools import (
        generate_class_embeddings,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.utils.class_embedding import (
        SEMANTIC_DIMS,
    )

    rng = np.random.RandomState(17)
    npz = tmp_path / "vectors.npz"
    np.savez(npz, **{name: rng.randn(SEMANTIC_DIMS[model])
                     for name in ("dog", "person", "background", "zebra")})
    for extra in ([], ["--from-npz", str(npz)]):
        tag = "npz" if extra else "synthetic"
        pkg_root, port_root = tmp_path / f"pkg_{tag}", tmp_path / f"port_{tag}"
        _run_root_tool(ROOT / "tools" / "generate_class_embeddings.py",
                       ["--root", str(pkg_root), "--model", model, *extra])
        generate_class_embeddings.main(
            ["--root", str(port_root), "--model", model, *extra])
        want, got = _tree(pkg_root), _tree(port_root)
        assert len(want) == 87 and got == want, tag
    assert (np.loadtxt(port_root / model / "dog.txt")
            == np.load(npz)["dog"]).all()


# ------------------------------------------------------------ preflights
def _pkg_preflight(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"pkg_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    saved = list(sys.path)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = saved
    return mod


def _reports(capsys, name, argv):
    """(exit code, stdout) of the JAX package's preflight and the port's
    on the same arguments; the port's report names its own script."""
    import importlib

    pkg = _pkg_preflight(name)
    port = importlib.import_module(f"{PORT}.tools.{name}")
    saved = sys.argv
    sys.argv = [name, *argv]
    try:
        rc_pkg = pkg.main()
    finally:
        sys.argv = saved
    out_pkg = capsys.readouterr().out
    rc_port = port.main(argv)
    out_port = capsys.readouterr().out.replace(f"{PORT}/tools/", "tools/")
    return (rc_pkg, out_pkg), (rc_port, out_port)


def _shaped_blobs(extra=None, drop=""):
    """test_preflight's blob names, each with the shape of the tensor of
    the port's R-101 detector it names, and no bytes."""
    from test_preflight import _fake_r101_blobs

    from fewshotobjectdetection_imporove_via_text_feature_torch.checkpoint.torch_import import (
        c2_to_d2,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.tools.preflight_real_voc import (
        r101_tensor_shapes,
    )

    shapes = r101_tensor_shapes()
    blobs = {}
    for name, blob in _fake_r101_blobs().items():
        shape = shapes.get(c2_to_d2(name), blob.shape)
        blobs[name] = np.zeros(shape, np.dtype([]))
    blobs["conv1_w"] = np.random.RandomState(3).randn(
        64, 3, 7, 7).astype(np.float32)
    blobs.update(extra or {})
    return {k: v for k, v in blobs.items() if not drop or drop not in k}


def _pkl(path, blobs):
    with open(path, "wb") as f:
        pickle.dump({"blobs": blobs}, f)
    return str(path)


def _tv_pth(path, drop=(), conv1=(64, 3, 7, 7)):
    import torch

    from fewshotobjectdetection_imporove_via_text_feature_torch.evaluation.archs import (
        torchvision_r101_manifest,
    )

    gen = torch.Generator().manual_seed(5)
    state = {k: torch.randn(2, generator=gen)
             for k in torchvision_r101_manifest() if k not in drop}
    if conv1:
        state["conv1.weight"] = torch.randn(*conv1, generator=gen)
    torch.save(state, str(path))
    return str(path)


@pytest.fixture(scope="module")
def synthetic_trees(tmp_path_factory):
    from fewshotobjectdetection_imporove_via_text_feature_torch.tools.make_synthetic_coco import (
        make_coco,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.tools.make_synthetic_voc import (
        make_voc,
    )

    root = tmp_path_factory.mktemp("trees")
    make_voc(str(root / "voc"), images=4, shots=(1, 10))
    make_coco(str(root / "coco"), train_images=32, test_images=4,
              image_size=(64, 48))
    return root


def test_voc_preflight_gives_the_same_report(capsys, tmp_path,
                                             synthetic_trees):
    good = _pkl(tmp_path / "R-101.pkl", _shaped_blobs())
    alien = _pkl(tmp_path / "alien.pkl", _shaped_blobs(
        {"mystery_layer_w": np.zeros(3, np.float32)}))
    r50 = _pkl(tmp_path / "R-50.pkl", _shaped_blobs(drop="res4_22"))
    pth = _tv_pth(tmp_path / "tv.pth")
    short = _tv_pth(tmp_path / "short.pth", drop=("fc.weight", "bn1.bias"))
    bent = _tv_pth(tmp_path / "bent.pth", conv1=(64, 3, 3, 3))
    voc = str(synthetic_trees / "voc")
    seen = {}
    for label, argv in {
        "synthetic": ["--root", voc, "--shot", "1", "--r101", good,
                      "--pcb", pth],
        "no_shots": ["--root", voc, "--shot", "10", "--seeds", "0", "1",
                     "--r101", alien, "--pcb", short],
        "r50": ["--root", voc, "--shot", "5", "--r101", r50, "--pcb", bent],
        "nothing": ["--root", str(tmp_path / "none"), "--r101",
                    str(tmp_path / "no.pkl"), "--pcb",
                    str(tmp_path / "no.pth")],
    }.items():
        (rc_pkg, out_pkg), (rc_port, out_port) = _reports(
            capsys, "preflight_real_voc", argv)
        assert (rc_port, out_port) == (rc_pkg, out_pkg), label
        assert rc_port == 1 and "Nothing was started." in out_port
        seen[label] = out_port
    assert "this looks like synthetic smoke data" in seen["synthetic"]
    assert "[\x1b[32mOK\x1b[0m] R-101.pkl import coverage" in \
        seen["synthetic"]
    assert "[\x1b[32mOK\x1b[0m] vocsplit 1-shot" in seen["synthetic"]
    assert "1 blobs do not translate (e.g. ['mystery_layer_w'])" in \
        seen["no_shots"]
    assert "2/522 manifest keys missing" in seen["no_shots"]
    assert "not a ResNet-101 file" in seen["r50"]
    assert "conv1.weight shape wrong" in seen["r50"]

    # test_preflight's own file: 1x1 blobs under R-101's names. The JAX
    # package checks names only; the port's importer would skip every
    # tensor of another shape, so its gate refuses them
    from test_preflight import _fake_r101_blobs

    from fewshotobjectdetection_imporove_via_text_feature_torch.tools import (
        preflight_real_voc,
    )

    names_only = _pkl(tmp_path / "names.pkl", _fake_r101_blobs())
    assert _pkg_preflight("preflight_real_voc").check_r101_pkl(
        names_only) == []
    problems = preflight_real_voc.check_r101_pkl(names_only)
    assert len(problems) == 1 and "blobs do not translate" in problems[0]


def test_coco_preflight_gives_the_same_report(capsys, tmp_path,
                                              synthetic_trees):
    good = _pkl(tmp_path / "R-101.pkl", _shaped_blobs())
    pth = _tv_pth(tmp_path / "tv.pth")
    coco = str(synthetic_trees / "coco")
    for argv in (["--root", coco, "--shot", "1", "--r101", good,
                  "--pcb", pth],
                 ["--root", coco, "--shot", "10", "--seeds", "0", "3",
                  "--r101", str(tmp_path / "no.pkl"), "--pcb", pth]):
        (rc_pkg, out_pkg), (rc_port, out_port) = _reports(
            capsys, "preflight_real_coco", argv)
        assert (rc_port, out_port) == (rc_pkg, out_pkg), argv
        assert rc_port == 1
    assert "this looks like synthetic smoke data" in out_port
    assert "truncated or synthetic" in out_port
    assert "80/80 classes" in out_port


@pytest.mark.parametrize("name,argv", [
    ("run_real_voc.sh", ["1", "10", "0"]), ("run_real_coco.sh", ["10", "0"])])
def test_real_run_stops_at_the_gate(name, argv, tmp_path):
    (tmp_path / "data").mkdir()
    save = tmp_path / "outputs"
    env = dict(os.environ, DATA_ROOT=str(tmp_path / "data"),
               IMAGENET_PRETRAIN=str(tmp_path / "no-R-101.pkl"),
               PCB_PRETRAIN=str(tmp_path / "no-pcb.pth"), SAVE_DIR=str(save))
    runs = [subprocess.run(["bash", str(script), *argv], cwd=str(tmp_path),
                           env=env, capture_output=True, text=True,
                           timeout=120)
            for script in (ROOT / "tools" / name, TOOLS / name)]
    items = [[ln for ln in r.stdout.splitlines() if ln.startswith(("[", " "))]
             for r in runs]
    assert runs[1].returncode == runs[0].returncode == 1
    assert items[1] == items[0] and items[0]
    assert "Preflight FAILED" in runs[1].stdout
    assert "Nothing was started." in runs[1].stdout
    assert "Base Pre-train" not in runs[1].stdout
    assert not save.exists()


# ----------------------------------------------------------- visualizers
def _pixels(path):
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))


def test_visualizers_draw_the_same_images(tmp_path, monkeypatch):
    from fewshotobjectdetection_imporove_via_text_feature_torch.data import (
        get_detection_dataset_dicts,
        register_all,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.tools import (
        visualize_confusion_matrix,
        visualize_json_results,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.tools.make_synthetic_voc import (
        make_voc,
    )

    make_voc(str(tmp_path / "datasets"), images=5)
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("FSODTF_DATASETS", raising=False)
    register_all("datasets")
    rng = np.random.RandomState(11)
    preds = []
    for rec in get_detection_dataset_dicts(["voc_2007_test_all1"], False)[:4]:
        for _ in range(6):
            x, y = rng.uniform(0, 150, 2)
            preds.append({"image_id": rec["image_id"], "score":
                          float(rng.uniform(0.2, 1.0)),
                          "category_id": int(rng.randint(20)), "bbox":
                          [float(x), float(y), *map(float,
                                                    rng.uniform(10, 90, 2))]})
    (tmp_path / "preds.json").write_text(json.dumps(preds))
    args = ["--input", "preds.json", "--dataset", "voc_2007_test_all1"]
    env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu")
    env.pop("FSODTF_DATASETS", None)
    subprocess.run([sys.executable, str(ROOT / "visualize_json_results.py"),
                    *args, "--output", "pkg_vis"], cwd=str(tmp_path),
                   env=env, check=True, capture_output=True, timeout=120)
    assert visualize_json_results.main([*args, "--output", "port_vis"]) == 4
    want = sorted(p.name for p in (tmp_path / "pkg_vis").iterdir())
    got = sorted(p.name for p in (tmp_path / "port_vis").iterdir())
    assert got == want and len(got) == 4
    for name in got:
        a, b = _pixels(tmp_path / "pkg_vis" / name), _pixels(
            tmp_path / "port_vis" / name)
        assert a.shape == b.shape and (a == b).all(), name

    # the similarity figure of split 1's embeddings (synthetic vectors)
    _run_root_tool(ROOT / "visualize_confusion_matrix.py",
                   ["--root", "datasets", "--output", "pkg_sim.png"])
    out = visualize_confusion_matrix.main(["--root", "datasets",
                                           "--output", "port_sim.png"])
    want = out.replace("port_sim", "pkg_sim")
    if out.endswith(".png"):
        assert (_pixels(out) == _pixels(want)).all()
    else:
        assert open(out).read() == open(want).read()


def test_new_scripts_parse_and_validate_all_names_only_port_files():
    new = ["run_real_voc", "run_real_coco", "smoke_workflow_coco",
           "validate_all", *(pathlib.Path(s).stem for s in SCRIPTS)]
    for stem in sorted(set(new)):
        path = TOOLS / f"{stem}.sh"
        r = subprocess.run(["bash", "-n", str(path)], capture_output=True,
                           text=True, timeout=30)
        assert r.returncode == 0, (stem, r.stderr)
    text = (TOOLS / "validate_all.sh").read_text()
    body = "\n".join(ln.split("#", 1)[0] for ln in text.splitlines())
    for name in ("bench.py", "main.py", "__graft_entry__", "tpu_kernel_parity",
                 "profile_step", "production_step_smoke", "train_ab",
                 "has_tpu", "_tpu"):
        assert name not in body, name
    named = set(re.findall(r"\$\{TOOLS\}/(\S+\.sh)", body))
    assert named == {"smoke_workflow.sh", "smoke_workflow_coco.sh",
                     "check_generalization.sh",
                     "check_generalization_coco.sh"}
    assert all((TOOLS / n).is_file() for n in named)
    modules = set(re.findall(r"-m \$\{PORT\}\.tools\.(\w+)", body))
    assert modules == {"dryrun_multidevice"}
    assert all((TOOLS / f"{m}.py").is_file() for m in modules)
    assert (ROOT / "chip_smoke.py").is_file() and "python3 chip_smoke.py" in body
    assert not re.search(r"\bpython3? (tools/|\S*_tpu)", body)
