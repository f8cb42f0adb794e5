"""The kernel-measurement tools (semcode_tpu_torch/tools) on the CPU.

Each tool's ``main`` runs at a tiny size with ``SEMCODE_TORCH_DEVICE=cpu``
(the kernels' plain versions) and must print parseable JSON lines with the
keys of its JAX counterpart under ``tools/``, plus the device it ran on.
Times printed here are the CPU's and are not checked; what is checked is
what the tools compute: maxima equal to the yardstick, recall against the
exact oracle, the routes' top-10 agreement.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from semcode_tpu_torch.tools import (
    bench_api, dot_cuda, dot_rate, scan_ab, scan_profile, scan_tune,
)

ROOT = Path(__file__).resolve().parents[1]
TINY = {"N": "4096", "DIM": "128", "BATCH": "16", "CHUNK_B": "2", "SECS": "0.05"}


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    monkeypatch.setenv("SEMCODE_TORCH_DEVICE", "cpu")


def _lines(capsys):
    out = capsys.readouterr().out
    return [json.loads(line) for line in out.splitlines() if line.strip()]


def test_dot_cuda_lines(capsys):
    assert dot_cuda.main([], TINY) == 0
    lines = _lines(capsys)
    assert [r["mode"] for r in lines] == ["torch_int_mm_s8s8"] + [
        m for _ in (64, 128, 256) for m in ("cuda_s8s8_s32", "cuda_s8s8_bf16cast")
    ]
    assert [r.get("rtile") for r in lines] == [None, 64, 64, 128, 128, 256, 256]
    for r in lines:
        assert {"mode", "ms_per_batch", "tops", "compile_s"} <= set(r)
        assert r["device"] == "cpu" and r["ms_per_batch"] > 0
    assert all(r["max_equal"] is True for r in lines[1:])


def test_dot_cuda_refused_config_prints_error(capsys):
    assert dot_cuda.main(["128"], {**TINY, "DIM": "1152", "N": "300"}) == 0
    lines = _lines(capsys)
    assert lines[1]["mode"] == "cuda_s8s8_s32" and lines[1]["max_equal"] is True
    assert lines[2]["mode"] == "cuda_s8s8_bf16cast" and "exact only" in lines[2]["error"]


def test_int_mm_max_pads_ragged_inputs():
    """The yardstick pads queries to cuBLASLt's >16 rows and ragged row
    chunks with repeats of a row; neither may change a maximum."""
    import torch

    rng = np.random.default_rng(5)
    rows = rng.integers(-128, 128, (1003, 128), dtype=np.int8)
    q = rng.integers(-128, 128, (3, 128), dtype=np.int8)
    want = (q.astype(np.int64) @ rows.astype(np.int64).T).max(axis=1)
    got = dot_cuda.int_mm_max(torch.from_numpy(rows), torch.from_numpy(q))
    np.testing.assert_array_equal(got.numpy(), want)


def test_dot_rate_lines(capsys):
    modes = ["s8s8", "s8s8_raw", "s8s8_t", "bf16", "s8s8_big", "s4s4", "s4s4_cast"]
    assert dot_rate.main(modes, TINY) == 0
    lines = _lines(capsys)
    assert [r["mode"] for r in lines] == modes
    keys = {"mode", "n", "dim", "batch", "chunk_b", "ms_per_batch", "tops",
            "corpus_gbps", "compile_s"}
    for r in lines[:5]:
        assert keys <= set(r) and r["device"] == "cpu", r
    assert lines[4]["batch"] == 32  # s8s8_big doubles the queries
    assert all("int4" in r["error"] for r in lines[5:])


def test_scan_ab_line(capsys):
    # 16384 rows = 128 blocks: no query of this tie-free corpus has three of
    # its true top-10 in one 128-row block, so both routes agree exactly
    assert scan_ab.main(["16384", "128", "16", "2", "0.05"]) == 0
    (line,) = _lines(capsys)
    for impl in ("xla", "pallas"):
        assert {f"{impl}_qps", f"{impl}_ms_per_batch", f"{impl}_compile_s"} <= set(line)
    assert line["top10_agreement"] == 1.0
    assert (line["n"], line["dim"], line["batch"], line["chunk_b"]) == (16384, 128, 16, 2)


def test_scan_profile_lines(capsys):
    assert scan_profile.main([], TINY) == 0
    lines = _lines(capsys)
    assert [r["mode"] for r in lines] == list(scan_profile.DEFAULT_MODES)
    keys = {"mode", "n", "dim", "batch", "chunk_b", "fetch", "rt",
            "ms_per_batch", "qps", "compile_s"}
    for r in lines:
        assert keys <= set(r), r
        assert r["selection"] == "exact" and r["rt"] is None and r["device"] == "cpu"


def test_scan_profile_pallas_route_and_unknown_mode(capsys):
    env = {**TINY, "SCAN_IMPL": "pallas"}
    assert scan_profile.main(["norescore", "dotsel_approx"], env) == 0
    ok, bad = _lines(capsys)
    assert ok["mode"] == "norescore" and ok["scan_impl"] == "pallas"
    assert bad == {"mode": "dotsel_approx", "error": "unknown"}


def test_scan_tune_lines(capsys):
    env = {**TINY, "N_Q": "32"}
    assert scan_tune.main(["f32:128", "residual:64:32", "f32:128:0.95"], env) == 0
    stage, f32, resid, rt = _lines(capsys)
    assert stage == {"stage": "oracle_done"}
    keys = {"mode", "fetch", "rt", "w", "batch", "recall_at_10", "qps",
            "ms_per_batch", "build_s", "compile_s"}
    for r in (f32, resid):
        assert keys <= set(r) and r["selection"] == "exact"
        assert r["recall_at_10"] >= 0.99
    assert (f32["mode"], f32["fetch"], f32["w"]) == ("f32", 128, 0)
    assert (resid["mode"], resid["fetch"], resid["w"]) == ("residual", 64, 32)
    assert rt["config"] == "f32:128:0.95" and "rt" in rt["error"]


@pytest.mark.parametrize("cfg,want", [
    ("f32:128", ("f32", 128, 0)),
    ("residual:96:-1", ("residual", 96, -1)),
])
def test_scan_tune_parse_config(cfg, want):
    assert scan_tune.parse_config(cfg) == want


@pytest.mark.parametrize("cfg", ["f32:128:0.95", "f32:128:0.95:32", "f32", "f32:x"])
def test_scan_tune_rejects_rt_configs(cfg):
    with pytest.raises(ValueError, match="mode:fetch"):
        scan_tune.parse_config(cfg)


def test_tool_runs_as_module_without_jax(tmp_path):
    """``python -m semcode_tpu_torch.tools.dot_cuda`` in a fresh process:
    one line per config, and no JAX or JAX-package module loaded."""
    code = (
        "import atexit, runpy, sys\n"
        "atexit.register(lambda: print('BAD', sorted(m for m in sys.modules"
        " if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'semcode_tpu'))))\n"
        "sys.argv = ['dot_cuda', '128']\n"
        "runpy.run_module('semcode_tpu_torch.tools.dot_cuda', run_name='__main__',"
        " alter_sys=True)\n"
    )
    env = {k: v for k, v in os.environ.items() if not k.startswith("SEMCODE_")}
    env.update(TINY, SEMCODE_TORCH_DEVICE="cpu", PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = proc.stdout.splitlines()
    assert out[-1] == "BAD []"
    modes = [json.loads(line)["mode"] for line in out[:-1]]
    assert modes == ["torch_int_mm_s8s8", "cuda_s8s8_s32", "cuda_s8s8_bf16cast"]


@pytest.mark.parametrize("impl", ["auto", "pallas"])
def test_bench_api_short_cpu_run(impl):
    """The /query SLO harness at a few hundred rows for a second at
    concurrency 4, with an ingest job run beside the timed window: QPS > 0,
    no failed request, every answer with hits, and the job completed."""

    async def ingest_job(client):
        import asyncio

        r = await client.post(
            "/jobs/ingest", headers={"X-API-Key": bench_api.API_KEY},
            json={"name": "index", "root": str(ROOT),
                  "include": ["semcode_tpu/index"]})
        job = await r.json()
        for _ in range(600):
            r = await client.get(f"/jobs/{job['id']}",
                                 headers={"X-API-Key": bench_api.API_KEY})
            job = await r.json()
            if job["status"] in ("completed", "failed"):
                return job
            await asyncio.sleep(0.05)
        return job

    out = bench_api.run_api_bench(rows=300, dim=128, concurrency=4, secs=1.0,
                                  warm_secs=0.3, impl=impl, during=ingest_job)
    assert out["qps"] > 0 and out["requests"] > 0
    assert out["failed"] == 0 and out["empty"] == 0, out["errors"]
    assert out["p50_ms"] > 0 and out["p99_ms"] >= out["p50_ms"]
    assert {"embed", "search"} <= set(out["stage_ms"])
    assert out["during"]["status"] == "completed", out["during"]
    assert out["during"]["result"]["chunk_count"] == 57
    assert (out["rows"], out["impl"], out["device"]) == (300, impl, "cpu")
    assert "profile" not in out  # a profiled window needs the card


def test_bench_api_main_prints_one_line(capsys):
    assert bench_api.main(["--rows", "200", "--dim", "128", "--concurrency", "2",
                           "--secs", "0.3"]) == 0
    (line,) = _lines(capsys)
    assert line["failed"] == 0 and line["qps"] > 0 and line["impl"] == "auto"
