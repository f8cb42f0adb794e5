"""Nothing the harness runs loads JAX or the JAX package; the reference
imports nothing of the program."""

import ast
import json
import os
import subprocess
import sys

from perfbench import harness, spec

FORBIDDEN = {"jax", "jaxlib", "flax", "semcode_tpu"}


def imported(path):
    """Top-level names a file imports (absolute imports only)."""
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_reference_imports_nothing_of_the_program():
    names = imported(spec.PACKAGE / "reference.py")
    assert "semcode_tpu_torch" not in names
    assert not names & FORBIDDEN


def test_model_references_import_nothing_of_the_program():
    """A model configuration's plain reference (``models/*_reference.py``)
    imports neither JAX nor the port, its kernels included, nor the
    harness."""
    paths = list((spec.PACKAGE / "models").glob("*_reference.py"))
    assert paths
    for path in paths:
        names = imported(path)
        assert not names & (FORBIDDEN | {"semcode_tpu_torch", "perfbench"}), path
        assert not any(isinstance(n, ast.ImportFrom) and n.level > 0
                       for n in ast.walk(ast.parse(path.read_text()))), path


def test_no_harness_file_imports_jax_or_the_jax_package():
    for path in spec.PACKAGE.rglob("*.py"):
        assert not imported(path) & FORBIDDEN, path


def test_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "semcode_tpu_torch_probe", sys)
    assert "semcode_tpu" not in harness.forbidden_modules()


def test_a_fresh_process_running_a_tiny_cell_loads_none(tmp_path):
    code = (
        "import json, sys, time\n"
        "t0 = time.perf_counter()\n"
        "import torch\n"
        "from pathlib import Path\n"
        "from perfbench import harness, spec\n"
        "from perfbench.tests.tiny import make_root\n"
        f"root = make_root(Path({str(tmp_path)!r}))\n"
        "cell = spec.load('tiny-serve8', root)\n"
        "r = harness.run_cell(cell, 7, 0.3, False, torch.device('cpu'), t0)\n"
        "print(json.dumps({'correct': r['correct'],"
        " 'found': sorted({m.split('.')[0] for m in sys.modules})}))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(spec.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=str(tmp_path), timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last["correct"] is True
    assert "semcode_tpu_torch" in last["found"]
    assert not set(last["found"]) & FORBIDDEN
