"""Nothing under ``benchmark/`` imports JAX or the JAX package, and nothing
under ``benchmark/reference/`` imports the measured program: each imported
module's top-level name (the part before the first dot) is compared whole,
since the program's name begins with the JAX package's."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
import types
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
JAX = {"jax", "jaxlib", "flax",
       "fewshotobjectdetection_imporove_via_text_feature_tpu"}
PORT = "fewshotobjectdetection_imporove_via_text_feature_torch"


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def _sources(root: Path):
    return sorted(root.rglob("*.py"))


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    bad = {str(p): _imports(p) & JAX for p in _sources(BENCH)
           if _imports(p) & JAX}
    assert not bad, bad


def test_the_reference_imports_nothing_of_the_program():
    files = _sources(BENCH / "reference")
    assert files
    bad = {str(p): _imports(p) & (JAX | {PORT}) for p in files
           if _imports(p) & (JAX | {PORT})}
    assert not bad, bad


def test_loading_the_reference_loads_neither_the_program_nor_jax():
    code = ("import json, sys\n"
            f"sys.path[:0] = [{str(BENCH)!r}]\n"
            "import reference.detector, reference.student\n"
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True,
                         env=dict(os.environ, PYTHONPATH=""))
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not tops & (JAX | {PORT}), tops & (JAX | {PORT})


def test_the_top_level_names_are_compared_whole(monkeypatch):
    from harness import core

    tpu = "fewshotobjectdetection_imporove_via_text_feature_tpu"
    monkeypatch.setattr(core, "sys", types.SimpleNamespace(modules={
        PORT: None, PORT + ".models": None, "jaxtyping": None}))
    assert core.forbidden_modules() == []
    monkeypatch.setattr(core, "sys", types.SimpleNamespace(modules={
        PORT: None, "jax.numpy": None, tpu + ".cli": None}))
    assert core.forbidden_modules() == [tpu, "jax"]
