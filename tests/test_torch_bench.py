"""The headline benchmark's port (``python -m semcode_tpu_torch.bench``).

- it runs end to end on the CPU at a tiny size in a fresh process and ends
  with the JAX script's line: every ``extras`` key of ``BENCH_r05.json``
  but the API's, nothing failed or skipped, and its correctness figures;
- the port's ``IVFIndex`` built as the bench builds it (bulk,
  ``expected_rows = N + 6144``, 1% of rows tagged) answers the bench's
  searches with the JAX ``IVFIndex``'s ids, the residual tier included;
- its oracle, ``recall_of`` and CPU-baseline extrapolation are the JAX
  script's recipe;
- a streamed chunk made again has the same bits, and ``_corpus.mixture``
  keeps its output;
- failures show: a section that raises is named and the run exits
  non-zero, no card and no ``SEMCODE_TORCH_DEVICE`` exits non-zero, and
  the reads-under-a-writer check refuses an index that drops writes.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semcode_tpu.index.ivf import IVFIndex as JaxIVF
from semcode_tpu.parallel.mesh import make_mesh
from semcode_tpu_torch import bench
from semcode_tpu_torch.index.ivf import IVFIndex
from semcode_tpu_torch.tools import _corpus
from test_torch_ivf import _same_ids

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import bench as jax_bench  # noqa: E402 - the JAX package's headline script

TINY = {
    "BENCH_N": "20000", "BENCH_DIM": "384", "BENCH_NLIST": "64",
    "BENCH_NPROBE": "8", "BENCH_QUERIES": "64", "BENCH_BATCH": "32",
    "BENCH_SECS": "0.5", "BENCH_HIGHDIM_N": "4096",
    "BENCH_HIGHDIM_MIN_N": "4096", "BENCH_API": "0",
}


def _env(extra):
    """A fresh process's environment: two intra-op threads, so the bench's
    timed windows hold beside the other test workers on a shared CPU."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("SEMCODE_", "BENCH_"))}
    env.update(extra, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2", MKL_NUM_THREADS="2")
    return env


# the bench's timing windows and groups, shortened for the tiny corpus: the
# run's time goes to work, not to seconds a 1M-row card needs for a steady
# rate. under_ingest keeps its own window: the writer must finish in it,
# and beside five busy test processes its 20 adds take several seconds
SHORT_WINDOWS = {
    "BASELINE_ROW_SECS": 0.1, "BASELINE_CENTROID_SECS": 0.05,
    "BATCH8_MIN_SECS": 0.2, "HIGHDIM_EXACT_MIN_SECS": 0.2,
    "FILTERED_SECS": (0.3, 0.3), "SYNC_SECS": 0.1, "CHUNKED_CALLS": 1,
}
SHORT_MAIN = ("from semcode_tpu_torch import bench\n"
              f"for name, value in {SHORT_WINDOWS!r}.items():\n"
              "    setattr(bench, name, value)\n"
              "raise SystemExit(bench.main())\n")


def _lines(stdout):
    return [json.loads(line) for line in stdout.splitlines() if line.startswith("{")]


def test_bench_runs_end_to_end_on_cpu(tmp_path):
    """A fresh process running ``bench.main`` with SHORT_WINDOWS."""
    assert set(SHORT_WINDOWS) <= set(vars(bench))
    proc = subprocess.run(
        [sys.executable, "-c", SHORT_MAIN], cwd=tmp_path,
        env=_env({**TINY, "SEMCODE_TORCH_DEVICE": "cpu"}),
        capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = _lines(proc.stdout)
    assert len(lines) >= 9  # one a section, the first before any device work
    last = lines[-1]
    assert set(last) == {"metric", "value", "unit", "vs_baseline", "extras"}
    ex = last["extras"]
    assert ex["stage"] == "done"
    assert ex["failed"] == {} and ex["skipped"] == {}
    ref = json.loads((ROOT / "BENCH_r05.json").read_text())["parsed"]["extras"]
    want = {key for key in ref if not key.startswith("api_")}
    assert want <= set(ex), sorted(want - set(ex))
    assert last["metric"].startswith("query throughput at recall@10=")
    assert "(N=20000, dim=384, int8 + fused f32 device rescore" in last["metric"]
    assert last["unit"] == "qps" and last["value"] > 0 and last["vs_baseline"] > 0
    # the card's identity: on the CPU no power limit, no kernel launched
    assert ex["device"] == "cpu" and ex["power_limit_w"] is None
    assert ex["kernel_launches"] == {"top2_scan": 0, "ivf_scan": 0}
    assert set(ex["section_launches"]) == {
        "flagship", "probing", "serving", "small_batch", "under_ingest",
        "filtered", "highdim_3072"}
    # the run's own correctness figures
    assert ex["recall_at_10_exact"] >= 0.99 and ex["filtered_recall_at_10"] >= 0.99
    assert ex["recall_at_10_probing"] >= 0.95 and ex["d3072_recall_at_10"] >= 0.99
    assert ex["filtered_hits_all_match"] is True
    assert ex["under_ingest_rows"] == 5120
    assert ex["under_ingest_bad_ids"] == 0 and ex["under_ingest_read_back_misses"] == 0
    assert ex["rescore_tier"] == "f32" and ex["dispatch_chunked"] is True
    # a 4096-row f32 mirror fits the budget; at 1M x 3072 the tier is residual
    assert ex["d3072_rescore_tier"] == "f32"


# -- the index as the bench builds it, against the JAX package -------------------

D, N_ROWS, NLIST, NPROBE = 128, 4000, 32, 8


@pytest.fixture(scope="module")
def mesh1():
    return make_mesh((1,), ("data",), devices=jax.devices()[:1])


def _corpus_rows(seed=0, n=N_ROWS, d=D):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((48, d)).astype(np.float32)
    x = centers[rng.integers(0, 48, n)] + 0.35 * rng.standard_normal((n, d))
    x = (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)
    pick = rng.choice(n, 32, replace=False)
    q = x[pick] + 0.05 * rng.standard_normal((32, d))
    return x, (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


def _bench_built(mesh1, x, **kw):
    """Both packages' indexes built as the bench builds them; the port
    takes the JAX index's centroids (k-means++ cannot reproduce
    ``jax.random``'s bits), so both hold one layout."""
    opts = dict(nlist=NLIST, nprobe=NPROBE, metric="ip", dtype="int8",
                kmeans_iters=10, scan_impl="auto", **kw)
    tags = (np.arange(x.shape[0]) % 100 == 0).astype(np.int32)
    a = JaxIVF(D, mesh=mesh1, **opts)
    with a.bulk(expected_rows=x.shape[0] + bench.GROW_HEADROOM):
        a.add(x, tags=tags)
    b = IVFIndex(D, device="cpu", **opts)
    b.centroids = np.asarray(a.centroids, dtype=np.float32).copy()
    with b.bulk(expected_rows=x.shape[0] + bench.GROW_HEADROOM):
        b.add(torch.from_numpy(x), tags=tags)
    assert b.cmax == a.cmax and b._mirror_cap == a._mirror_cap
    np.testing.assert_array_equal(b._loc[: b._n_rows], a._loc[: a._n_rows])
    return a, b, tags


def _same_search(a, b, q, **kw):
    """The port's device search at K against the reference's at K + 1."""
    sa, ia = a.search_device(jnp.asarray(q), bench.K + 1, **kw)
    sb, ib = b.search_device(torch.from_numpy(q), bench.K, **kw)
    sa, ia = np.asarray(sa), np.asarray(ia)
    sb, ib = sb.numpy(), ib.numpy()
    _same_ids(sa, ia, sb, ib)
    np.testing.assert_allclose(sb, sa[:, : bench.K], rtol=1e-5, atol=1e-5)
    return ib


@pytest.mark.parametrize("rescore_mode", ["auto", "residual"])
def test_bench_built_index_matches_jax(mesh1, rescore_mode):
    x, q = _corpus_rows()
    a, b, tags = _bench_built(mesh1, x, rescore_mode=rescore_mode)
    assert bench.rescore_tier(b) == ("f32" if rescore_mode == "auto" else "residual")
    for mode in ("exact", "ivf"):
        _same_search(a, b, q, mode=mode)
    _same_search(a, b, q, mode="ivf", nprobe=16)
    ids = _same_search(a, b, q, allow_tags=np.asarray([1], dtype=np.int32))
    assert (ids >= 0).all() and (tags[ids.ravel()] == 1).all()
    # chunked dispatch: 4 batches of 8 in one call, both modes
    qs = q.reshape(4, 8, D)
    for mode in ("exact", "probe"):
        sa, ia = a.search_device_batched(jnp.asarray(qs), bench.K + 1, mode=mode,
                                         nprobe=16)
        sb, ib = b.search_device_batched(torch.from_numpy(qs), bench.K, mode=mode,
                                         nprobe=16)
        assert tuple(ib.shape) == (4, 8, bench.K)
        _same_ids(np.asarray(sa).reshape(32, -1), np.asarray(ia).reshape(32, -1),
                  sb.numpy().reshape(32, -1), ib.numpy().reshape(32, -1))
    for n_q, nprobe in ((8, NPROBE), (8, 16), (32, NPROBE)):
        assert b._pick_mode(n_q, nprobe, bench.K) == a._pick_mode(n_q, nprobe, bench.K)


# -- the oracle, recall and the CPU baseline: the JAX script's recipe --------------


def _jax_oracle(x, q, k, sub):
    """bench.py's oracle: HIGHEST-precision dot per slice, ``lax.top_k``,
    then the host merge by argsort."""
    @jax.jit
    def oracle_chunk(xc, qd):
        s = jax.lax.dot_general(
            qd, xc, dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        return jax.lax.top_k(s, k)

    parts_s, parts_i = [], []
    for lo in range(0, x.shape[0], sub):
        s, i = oracle_chunk(jnp.asarray(x[lo:lo + sub]), jnp.asarray(q))
        parts_s.append(np.asarray(s))
        parts_i.append(np.asarray(i) + lo)
    all_s = np.concatenate(parts_s, axis=1)
    all_i = np.concatenate(parts_i, axis=1)
    sel = np.argsort(-all_s, axis=1)[:, :k]
    return np.take_along_axis(all_i, sel, axis=1)


def test_oracle_and_recall_are_the_jax_recipe():
    """The oracle's ids are the JAX recipe's as sets (recall compares
    sets; ``torch.topk`` and ``lax.top_k`` may order ties apart)."""
    x, q = _corpus_rows(seed=1, n=6000, d=64)
    want = np.sort(_jax_oracle(x, q, bench.K, 1000), axis=1)
    xt, qt = torch.from_numpy(x), torch.from_numpy(q)
    got = _corpus.oracle_parts([(0, xt)], qt, bench.K, 1000)
    assert got.shape == (32, bench.K) and got.dtype == np.int64
    np.testing.assert_array_equal(np.sort(got, axis=1), want)
    # the same rows as streamed parts of another size give the same ids
    parts = [(lo, xt[lo:lo + 2500]) for lo in range(0, 6000, 2500)]
    got = _corpus.oracle_parts(parts, qt, bench.K, 700)
    np.testing.assert_array_equal(np.sort(got, axis=1), want)
    whole = _corpus.oracle_topk(xt, qt, bench.K)
    np.testing.assert_array_equal(np.sort(whole.numpy(), axis=1), want)
    rng = np.random.default_rng(2)
    for _ in range(3):
        a = rng.integers(0, 30, (16, bench.K))
        b = rng.integers(0, 30, (16, bench.K))
        assert bench.recall_of(a, b) == jax_bench.recall_of(a, b)


@pytest.mark.parametrize("centroid_s,per_row,nprobe,mean_rows", [
    (2.5e-5, 1.2e-8, 32, 976.5625), (1e-6, 3e-9, 16, 4000.0), (0.0, 1e-8, 1, 1.0)])
def test_cpu_baseline_extrapolation_is_the_jax_formula(centroid_s, per_row, nprobe,
                                                       mean_rows):
    per_query = centroid_s + per_row * nprobe * mean_rows  # bench.py:484-485
    assert bench.baseline_qps(centroid_s, per_row, nprobe, mean_rows) == 1.0 / per_query


def test_cpu_baseline_times_the_sample():
    rng = np.random.default_rng(3)
    sample = rng.standard_normal((512, 32)).astype(np.float32)
    cent = rng.standard_normal((64, 32)).astype(np.float32)
    qps, per_row, spread = bench.cpu_baseline(sample, cent, sample[0], 8, 100.0,
                                              0.02, 0.01)
    assert qps > 0 and per_row > 0 and spread >= 1.0
    assert np.isfinite([qps, per_row, spread]).all()


# -- the corpus ------------------------------------------------------------------


def test_streamed_chunk_made_again_has_the_same_bits():
    c = bench.Corpus(1000, 16, 4, (41, 42), torch.device("cpu"), whole=False)
    assert (c.n_chunks, c.gchunk) == (2, 500)
    first = c.chunk(1)
    assert torch.equal(c.chunk(1), first)
    assert not torch.equal(c.chunk(0), first)
    parts = list(c.chunks())
    assert [base for base, _ in parts] == [0, 500]
    assert torch.equal(parts[1][1], first)
    assert torch.allclose(first.norm(dim=1), torch.ones(500))
    # another Corpus on the same seeds makes the same chunk
    again = bench.Corpus(1000, 16, 4, (41, 42), torch.device("cpu"), whole=False)
    assert torch.equal(again.chunk(1), first)
    with pytest.raises(ValueError, match="chunk index"):
        _corpus.mixture_chunk(42, _corpus.CHUNK_KEYS, c.centers, 4)


def test_mixture_keeps_its_output():
    """``mixture`` as it read before its split into centers and rows."""

    def before(gen, n, d):
        n_centers = max(64, n // 1000)
        centers = torch.randn(n_centers, d, generator=gen, device=gen.device)
        assign = torch.randint(0, n_centers, (n,), generator=gen, device=gen.device)
        x = centers[assign]
        x.add_(0.35 * torch.randn(n, d, generator=gen, device=gen.device))
        return x / torch.clamp(x.norm(dim=1, keepdim=True), min=1e-9)

    for seed, n, d in ((0, 5000, 64), (7, 70001, 16)):
        want = before(torch.Generator().manual_seed(seed), n, d)
        got = _corpus.mixture(torch.Generator().manual_seed(seed), n, d)
        assert torch.equal(got, want)


# -- failures ----------------------------------------------------------------------


def test_a_failing_section_is_named_and_the_run_exits_nonzero(monkeypatch, capsys):
    """In process, streamed (the reconstructed filtered oracle and the
    mirror-sampled baseline): probing raises, the others run or are
    stubbed; the line names the failure and main returns non-zero."""
    for key, value in {"SEMCODE_TORCH_DEVICE": "cpu", "BENCH_N": "3000",
                       "BENCH_DIM": "128", "BENCH_NLIST": "16", "BENCH_NPROBE": "4",
                       "BENCH_QUERIES": "32", "BENCH_BATCH": "16", "BENCH_SECS": "0.1",
                       "BENCH_STREAM": "1", "BENCH_API": "0"}.items():
        monkeypatch.setenv(key, value)

    def boom(run):
        raise RuntimeError("boom")

    monkeypatch.setattr(bench, "sec_probing", boom)
    for name in ("sec_serving", "sec_small_batch", "sec_under_ingest"):
        monkeypatch.setattr(bench, name, lambda run: None)
    monkeypatch.setattr(bench, "BASELINE_ROW_SECS", 0.01)
    monkeypatch.setattr(bench, "BASELINE_CENTROID_SECS", 0.01)
    assert bench.main() == 1
    last = _lines(capsys.readouterr().out)[-1]
    ex = last["extras"]
    assert ex["stage"] == "done" and ex["skipped"] == {}
    assert ex["failed"] == {"probing": "RuntimeError('boom')"}
    assert "recall_at_10_probing" not in ex
    assert ex["filtered_oracle_basis"] == "reconstructed"
    assert ex["filtered_recall_at_10"] >= 0.99 and ex["filtered_hits_all_match"]
    assert ex["recall_at_10_exact"] >= 0.99 and ex["cpu_baseline_qps"] > 0
    assert "highdim_3072" not in ex["section_launches"]  # dim 128: no highdim


def test_no_card_and_no_device_variable_exits_nonzero(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    proc = subprocess.run(
        [sys.executable, "-m", "semcode_tpu_torch.bench"], cwd=tmp_path,
        env=_env(TINY), capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert "no CUDA device is available" in proc.stderr
    ex = _lines(proc.stdout)[-1]["extras"]
    assert "no CUDA device is available" in ex["failed"]["device"]
    assert "build_s" not in ex


class _DroppingIVF(IVFIndex):
    """Acknowledges every write with fresh row ids and stores none."""

    def add(self, x, tags=None):
        self._dropped = getattr(self, "_dropped", 0) + len(x)
        return np.arange(self._n_rows + self._dropped - len(x),
                         self._n_rows + self._dropped)


@pytest.mark.parametrize("cls", [IVFIndex, _DroppingIVF])
def test_under_ingest_reads_back_acknowledged_writes(cls):
    x, q = _corpus_rows(seed=4, n=3000)
    index = cls(D, nlist=16, nprobe=4, metric="ip", dtype="int8", device="cpu")
    with index.bulk(expected_rows=3000 + bench.GROW_HEADROOM):
        IVFIndex.add(index, x)
    out, problems = bench.under_ingest(index, torch.from_numpy(q[:8]), secs=1.0)
    assert out["under_ingest_rows"] == bench.WRITES * bench.WRITE_ROWS
    assert out["under_ingest_bad_ids"] == 0
    if cls is IVFIndex:
        assert problems == [] and out["under_ingest_read_back_misses"] == 0
        assert index.size == 3000 + bench.WRITES * bench.WRITE_ROWS
        return
    assert out["under_ingest_read_back_misses"] == bench.WRITES
    assert problems == [f"{bench.WRITES} of {bench.WRITES} acknowledged batches "
                        "did not read back at top-1"]
