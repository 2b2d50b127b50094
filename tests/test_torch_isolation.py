"""The PyTorch port stands alone: importing it loads neither JAX nor any
module of the JAX package, no file of it (nor chip_smoke.py) imports them,
and its entry points run on CUDA unless the caller asks for the CPU."""

import ast
import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = "fewshotobjectdetection_imporove_via_text_feature_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax",
             "fewshotobjectdetection_imporove_via_text_feature_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, json, pkgutil, sys\n"
        f"import {PORT} as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=300, check=True)
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    assert {f"{PORT}.engine.predictor", f"{PORT}.models.attention",
            f"{PORT}.models.text_heads", f"{PORT}.utils.class_embedding",
            f"{PORT}.utils.class_name", f"{PORT}.engine.export",
            f"{PORT}.engine.server", f"{PORT}.models.box_head",
            f"{PORT}.models.modules_zoo", f"{PORT}.utils.kdloss",
            f"{PORT}.data.device_preprocess",
            f"{PORT}.ops.custom_ops", f"{PORT}.parallel.mesh",
            f"{PORT}.parallel.gather", f"{PORT}.parallel.collectives",
            f"{PORT}.parallel.spatial", f"{PORT}.engine.launch"} <= set(mods)
    assert not [m for m in mods if _forbidden(m)]


def test_importing_the_cli_tools_and_data_loads_no_jax_and_no_pil():
    """The CLI, the tools (a namespace package, which walk_packages does
    not enter) and the data, evaluation and utils modules import neither
    JAX nor the JAX package; PIL is imported only where an image is read,
    so the port imports on a machine without it."""
    tools = sorted(p.stem for p in (ROOT / PORT / "tools").glob("*.py"))
    assert {"make_synthetic_voc", "model_surgery", "serve",
            "export_serving", "dryrun_multidevice",
            "make_generalization_voc", "make_generalization_coco",
            "train_pcb_extractor", "generate_class_embeddings",
            "preflight_real_voc", "preflight_real_coco",
            "visualize_json_results", "visualize_confusion_matrix",
            "overfit_check"} <= set(tools)
    names = [f"{PORT}.cli", f"{PORT}.dataloader", f"{PORT}.data.native_io",
             f"{PORT}.data.loader", f"{PORT}.evaluation.voc_eval",
             f"{PORT}.utils.events", f"{PORT}.engine.hooks",
             *(f"{PORT}.tools.{t}" for t in tools)]
    code = (
        "import importlib, json, sys\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         env=env, capture_output=True, text=True,
                         timeout=300, check=True)
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(names) <= set(mods)
    assert not [m for m in mods if _forbidden(m)]
    assert not [m for m in mods if m == "PIL" or m.startswith("PIL.")]


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_file_of_the_port_imports_jax():
    files = sorted((ROOT / PORT).rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    bad = {str(f.relative_to(ROOT)): m for f in files for m in _imports(f)
           if _forbidden(m)}
    assert not bad


def test_port_scripts_run_the_port_and_two_root_tools_only():
    """The port's shell scripts drive ``python -m`` of the port; of the
    repository's root scripts they call only ``tools/create_config.py`` and
    ``tools/extract_results.py``, which import neither JAX nor the JAX
    package. They default to CUDA."""
    import re

    scripts = sorted((ROOT / PORT / "tools").glob("*.sh"))
    assert {"smoke_workflow", "check_generalization",
            "check_generalization_coco", "run_stats_protocol",
            "smoke_workflow_coco", "validate_all", "run_real_voc",
            "run_real_coco", "run_voc", "run_coco",
            "run_text_train_teacher", "run_text_train_student",
            "run_text_train_teacher_novel", "run_textdomination_teacher",
            "run_textdomination_teacher_VKV", "run_novel_pure_attention",
            "run_voc_distillation", "run_voc_distillate_rpn",
            "run_visualize"} <= {p.stem for p in scripts}
    allowed = {"tools/create_config.py", "tools/extract_results.py"}
    for path in scripts:
        text = path.read_text()
        root_tools = set(re.findall(r"\bpython3? (tools/\S+\.py)", text))
        assert root_tools <= allowed, (path.name, root_tools - allowed)
        assert "main.py" not in text, path.name
        assert not re.search(r"\bpython3? -m (?!\$\{PORT\}\.)", text), \
            path.name
        for tool in allowed:
            assert not [m for m in _imports(ROOT / tool) if _forbidden(m)]
        assert "DEVICE=${DEVICE:-cuda}" in text, path.name


def test_predictor_refuses_to_leave_cuda_quietly():
    import torch

    from fewshotobjectdetection_imporove_via_text_feature_torch.config import (
        get_cfg,
    )
    from fewshotobjectdetection_imporove_via_text_feature_torch.engine import (
        DefaultPredictor,
    )

    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is usable")
    cfg = get_cfg()
    assert cfg.MODEL.DEVICE == "cuda"
    cfg.MODEL.WEIGHTS = ""
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DefaultPredictor(cfg)
    # spatial partitioning asks for no other device either: on CUDA its
    # bands need the cards, on the CPU every band runs on the CPU
    from fewshotobjectdetection_imporove_via_text_feature_torch.engine.predictor import (
        spatial_devices,
    )

    cfg.TPU.SPATIAL_PARTITION = 2
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DefaultPredictor(cfg)
    assert spatial_devices(cfg, torch.device("cpu")) == [
        torch.device("cpu")] * 2
    cfg.TPU.SPATIAL_PARTITION = 10_000
    with pytest.raises(ValueError, match="TPU.SPATIAL_PARTITION"):
        DefaultPredictor(cfg, device="cpu")


def test_chip_smoke_fails_without_cuda_or_without_the_repo(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("CUDA is present: chip_smoke.py would run for real")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    here = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          cwd=str(ROOT), env=env, capture_output=True,
                          text=True, timeout=300)
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    alone = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                           env=env, capture_output=True, text=True,
                           timeout=300)
    for run in (here, alone):
        assert run.returncode != 0
        assert '"ok"' not in run.stdout
