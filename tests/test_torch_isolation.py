"""The PyTorch engine stands alone: no JAX, no flax, nothing of semcode_tpu.

- an AST scan of every module of ``semcode_tpu_torch`` and of
  ``chip_smoke.py`` finds no such import;
- a fresh process that ingests and queries through the engine's CLI ends
  with no ``jax``/``flax``/``semcode_tpu`` module loaded, and so does one
  that imports the API server, serves a query and runs ``cli eval``;
- without a CUDA card the default device raises instead of running on the
  CPU, and ``SEMCODE_TORCH_DEVICE=cpu`` opts in to the CPU.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "semcode_tpu")


def _sources():
    files = sorted((ROOT / "semcode_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_forbidden_imports():
    files = _sources()
    assert len(files) > 30
    names = {str(p.relative_to(ROOT)) for p in files}
    assert {"semcode_tpu_torch/ops/dot_max.py"} | {
        f"semcode_tpu_torch/tools/{m}.py"
        for m in ("_timing", "dot_cuda", "dot_rate", "scan_ab", "scan_profile",
                  "scan_tune", "bench_api", "frozen_misses", "smoke")
    } | {
        f"semcode_tpu_torch/api/{m}.py"
        for m in ("dependencies", "telemetry", "jobs", "batcher", "main")
    } | {"semcode_tpu_torch/frontend/webui.py", "semcode_tpu_torch/frontend/cli.py"
         } <= names
    bad = [
        (str(p.relative_to(ROOT)), root)
        for p in files
        for root in _imported_roots(p)
        if root in FORBIDDEN
    ]
    assert bad == []


def _run(code: str, env_extra: dict, tmp_path: Path):
    env = {k: v for k, v in os.environ.items() if not k.startswith("SEMCODE_")}
    env.update(env_extra)
    env["PYTHONPATH"] = str(ROOT)
    return subprocess.run(
        [sys.executable, "-c", code], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )


_CLI_SESSION = """
import json, sys
from semcode_tpu_torch.cli import main
rc = [
    main(["ingest", "-n", "demo", "-I", "src", "-r", sys.argv[1], "-y"]),
    main(["query", "where is parse_config defined", "--json", "-k", "3"]),
    main(["list"]),
    main(["stats"]),
]
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in {roots})
print("RESULT", json.dumps({{"rc": rc, "bad": bad}}))
"""


def test_cli_session_loads_no_jax(tmp_path):
    src = tmp_path / "repo" / "src"
    src.mkdir(parents=True)
    (src / "settings.py").write_text(
        "def parse_config(path):\n    '''Read the TOML config.'''\n"
        "    return open(path).read()\n\n\nclass Store:\n    pass\n"
    )
    code = _CLI_SESSION.format(roots=repr(set(FORBIDDEN))).replace(
        "sys.argv[1]", repr(str(tmp_path / "repo"))
    )
    proc = _run(code, {
        "SEMCODE_TORCH_DEVICE": "cpu",
        "SEMCODE_WORKSPACE_ROOT": str(tmp_path / "ws"),
        "SEMCODE_EMBEDDING_DIMENSION": "64",
        "SEMCODE_INDEX_KIND": "flat",
    }, tmp_path)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = [x for x in proc.stdout.splitlines() if x.startswith("RESULT ")][-1]
    result = json.loads(line[len("RESULT "):])
    assert result == {"rc": [0, 0, 0, 0], "bad": []}
    assert "settings.py" in proc.stdout  # the query's JSON names the hit


_API_EVAL_SCRIPT = """
import asyncio, contextlib, io, json, sys
from semcode_tpu_torch.cli import main
from semcode_tpu_torch.api.main import create_app
from aiohttp.test_utils import TestClient, TestServer
rc = [main(["ingest", "-n", "demo", "-I", "src", "-r", sys.argv[1], "-y"])]
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    rc.append(main(["eval", "--frozen", "--max-per-kind", "5"]))
report = json.loads(buf.getvalue())[0]

async def serve():
    client = TestClient(TestServer(create_app()))
    await client.start_server()
    try:
        r = await client.post("/query", json={{"question": "parse_config"}})
        return r.status, await r.json()
    finally:
        await client.close()

status, body = asyncio.run(serve())
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in {roots})
print("RESULT", json.dumps({{"rc": rc, "bad": bad, "status": status,
                            "paths": [s["path"] for s in body["sources"]],
                            "frozen_n": report["by_kind"]["frozen"]["n"]}}))
"""


def test_api_and_eval_load_no_jax(tmp_path):
    src = tmp_path / "repo" / "src"
    src.mkdir(parents=True)
    (src / "settings.py").write_text(
        "def parse_config(path):\n    '''Read the TOML config.'''\n"
        "    return open(path).read()\n"
    )
    code = _API_EVAL_SCRIPT.format(roots=repr(set(FORBIDDEN))).replace(
        "sys.argv[1]", repr(str(tmp_path / "repo"))
    )
    proc = _run(code, {
        "SEMCODE_TORCH_DEVICE": "cpu",
        "SEMCODE_WORKSPACE_ROOT": str(tmp_path / "ws"),
        "SEMCODE_EMBEDDING_DIMENSION": "64",
        "SEMCODE_INDEX_KIND": "flat",
    }, tmp_path)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = [x for x in proc.stdout.splitlines() if x.startswith("RESULT ")][-1]
    result = json.loads(line[len("RESULT "):])
    assert result == {"rc": [0, 0], "bad": [], "status": 200,
                      "paths": ["src/settings.py"], "frozen_n": 102}


def test_default_device_refuses_cpu_fallback(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    code = (
        "from semcode_tpu_torch.cli import main\n"
        "raise SystemExit(main(['stats']))\n"
    )
    env = {"SEMCODE_WORKSPACE_ROOT": str(tmp_path / "ws")}
    proc = _run(code, env, tmp_path)
    assert proc.returncode != 0
    assert "no CUDA device is available" in proc.stderr
    proc = _run(code, {**env, "SEMCODE_TORCH_DEVICE": "cpu"}, tmp_path)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout)["device"] == "cpu"


def test_resolve_device():
    from semcode_tpu_torch.device import resolve_device, round_up

    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")
    assert round_up(130, 128) == 256 and round_up(128, 128) == 128
