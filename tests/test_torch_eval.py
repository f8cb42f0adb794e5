"""The port's quality entry points against the JAX package's, on the CPU.

- ``eval --frozen`` through both packages' CLIs (fresh processes, one
  workspace ingested by the port): MRR@10 and recall@k equal within 1e-4,
  overall and by query kind;
- ``semcode_tpu_torch.tools.frozen_misses`` against ``tools/frozen_misses.py``
  over ``semcode_tpu/``: MRR@10 and recall@k equal within 1e-4;
- ``semcode_tpu_torch.tools.smoke`` runs to ``SMOKE OK``.
"""

import importlib.util
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FROZEN = ROOT / "tests" / "fixtures" / "frozen_queries.json"


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("SEMCODE_") and k != "XLA_FLAGS"}
    env.update(PYTHONPATH=str(ROOT), SEMCODE_TORCH_DEVICE="cpu", **extra)
    return env


def _run(code, cwd, **env):
    proc = subprocess.run([sys.executable, "-c", code], cwd=cwd, env=_env(**env),
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


_EVAL = """
import contextlib, io, json, sys
{prelude}
from {pkg}.cli import main
{ingest}
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    rc = main(["eval", "--frozen", {frozen!r}, "--max-per-kind", "12"])
assert rc == 0, rc
print("RESULT " + json.dumps(json.loads(buf.getvalue())))
"""


def _eval(pkg, ws, cwd, ingest=""):
    prelude = ("import jax; jax.config.update('jax_platforms', 'cpu')"
               if pkg == "semcode_tpu" else "")
    out = _run(_EVAL.format(prelude=prelude, pkg=pkg, ingest=ingest,
                            frozen=str(FROZEN)),
               cwd, SEMCODE_WORKSPACE_ROOT=str(ws))
    line = [x for x in out.splitlines() if x.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


def _metrics(report):
    keys = ("mrr@10", "recall@1", "recall@5", "recall@10")
    out = {k: report[k] for k in keys}
    for kind, sub in report["by_kind"].items():
        for k in keys:
            if k in sub:
                out[f"{kind}/{k}"] = sub[k]
    return out


def test_cli_eval_frozen_matches_jax(tmp_path):
    ws = tmp_path / "ws"
    ingest = (f"assert main(['ingest', '-n', 'semcode_tpu', '-I', 'semcode_tpu', "
              f"'-r', {str(ROOT)!r}, '-y']) == 0")
    port, = _eval("semcode_tpu_torch", ws, tmp_path, ingest=ingest)
    jax, = _eval("semcode_tpu", ws, tmp_path)
    assert port["n_queries"] == jax["n_queries"] > 102
    assert port["by_kind"]["frozen"]["n"] == 102
    got, want = _metrics(port), _metrics(jax)
    assert got.keys() == want.keys() and len(got) > 8
    for key in want:
        assert got[key] == pytest.approx(want[key], abs=1e-4), key


_LINE = re.compile(r"frozen n=(\d+) mrr@10=([\d.]+) r@1=([\d.]+) "
                   r"r@5=([\d.]+) r@10=([\d.]+)")


def test_frozen_misses_matches_jax(monkeypatch, capsys):
    from semcode_tpu_torch.tools import frozen_misses

    monkeypatch.setenv("SEMCODE_TORCH_DEVICE", "cpu")
    assert frozen_misses.main(["--worst", "2"]) == 0
    port = _LINE.search(capsys.readouterr().out).groups()

    spec = importlib.util.spec_from_file_location(
        "jax_frozen_misses", ROOT / "tools" / "frozen_misses.py")
    jax_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_tool)
    monkeypatch.setattr(sys, "argv", ["frozen_misses.py", "--worst", "2"])
    assert jax_tool.main() == 0
    jax = _LINE.search(capsys.readouterr().out).groups()

    assert port[0] == jax[0] == "102"
    for a, b in zip(port[1:], jax[1:]):
        assert float(a) == pytest.approx(float(b), abs=1e-4)
    assert float(port[4]) == 1.0


def test_smoke_tool_runs_on_the_cpu(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "semcode_tpu_torch.tools.smoke"], cwd=ROOT,
        env=_env(), capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout
    assert out.rstrip().endswith("SMOKE OK")
    assert "0 embedded, 57 reused" in out
    stats = json.loads(out[out.rindex('{\n  "rows"'):out.rindex("}") + 1])
    assert stats["device"] == "cpu" and stats["rows"] == 57
