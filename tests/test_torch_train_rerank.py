"""The port's term-reranker training against the JAX package's, on the CPU.

- ``bucketize``, ``build_pairs`` and ``featurize_pairs`` give equal results
  on metas built once (``featurize_pairs``' module groups are ``hash(dir)``,
  salted per process, so both packages run it in this one);
- ``train_term_table`` at 4,096 buckets, dim 16, batch 16, 30 steps, fed
  the same feature dict: the first step's loss within 1e-5, every logged
  loss within 1e-3, the final tables' rows at cosine >= 0.999; the init
  equals ``0.02 * jax.random.normal`` (rtol 1e-5). The dict is made
  independent of the process: the module groups are numbered by directory
  (``featurize_pairs`` hashes the directory with Python's per-process salt,
  which orders the groups and so picks the hard-negative halves) and each
  (path, symbol) has one chunk (a query's positive is the first of a set of
  chunk ids, an order the salt decides too). The comparison of the tables
  is chaotic on some batch sequences: a row whose exact gradient is zero (a
  query term whose best match is itself: the normalization's gradient
  cancels) gets float noise, which Adam scales to about lr, and the two
  libraries' noise differs. Over 30 salts with the salted dict, 6 drifted
  apart from step ~16 on (row cosine down to 0.774, logged losses 1.3e-3
  apart); this dict does not;
- the port's mirror of ``tests/test_term_reranker.py::
  test_training_separates_synonyms``;
- the port's ``save_table`` loads in the JAX package's ``load_table`` with
  equal arrays, and the reverse.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from semcode_tpu.models import term_reranker as jtr
from semcode_tpu_torch.chunking.chunker import CodeChunker
from semcode_tpu_torch.models import term_reranker as ttr

ROOT = Path(__file__).resolve().parents[1]
GEOMETRY = dict(n_buckets=4096, dim=16, steps=30, batch_size=16, log_every=1)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The models here are tiny: torch's intra-op threads would only contend
    with the other test processes (pytest-xdist runs several files at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def metas():
    """Chunks of two module directories (two hard-negative groups), one
    per (path, symbol)."""
    chunker, out, seen = CodeChunker(), [], set()
    for d in ("index", "models"):
        for f in sorted((ROOT / "semcode_tpu" / d).glob("*.py")):
            rel = str(f.relative_to(ROOT))
            for c in chunker.chunk_text(f.read_text(encoding="utf-8"), path=rel,
                                        language="python"):
                if c.symbol and (rel, c.symbol) in seen:
                    continue
                seen.add((rel, c.symbol))
                out.append((f"c{len(out)}", {"text": c.content, "symbol": c.symbol,
                                             "path": rel, "language": "python"}))
    return out


def test_bucketize_matches():
    ids = np.asarray([[-1, 5, 131072 + 7, 2**31 - 1], [3, -1, -1, 4096]])
    for n in (131072, 4096, 7):
        np.testing.assert_array_equal(ttr.bucketize(ids, n), jtr.bucketize(ids, n))
    assert (ttr.DEFAULT_BUCKETS, ttr.DEFAULT_DIM, ttr.DOC_TERMS) == (
        jtr.DEFAULT_BUCKETS, jtr.DEFAULT_DIM, jtr.DOC_TERMS)


def test_pairs_and_features_match(metas):
    want = jtr.build_pairs(metas, max_per_kind=200)
    got = ttr.build_pairs(metas, max_per_kind=200)
    assert len(got) == len(want) > 100
    assert [q for q, _ in got] == [q for q, _ in want]
    assert all(a is b for (_, a), (_, b) in zip(got, want))
    for kwargs in ({}, dict(n_buckets=4096, doc_terms=32)):
        fj = jtr.featurize_pairs(want, **kwargs)
        ft = ttr.featurize_pairs(want, **kwargs)
        assert sorted(ft) == sorted(fj)
        for k in fj:
            assert ft[k].dtype == fj[k].dtype
            np.testing.assert_array_equal(ft[k], fj[k], err_msg=k)


def _record_jax_losses(monkeypatch):
    """Each step's exact loss from inside the JAX package's jitted step."""
    seen = []
    ce = optax.softmax_cross_entropy_with_integer_labels

    def recording(logits, labels):
        out = ce(logits, labels)
        jax.debug.callback(lambda v: seen.append(float(v)), out.mean())
        return out

    monkeypatch.setattr(optax, "softmax_cross_entropy_with_integer_labels", recording)
    return seen


def _record_port_losses(monkeypatch):
    seen = []
    loss_fn = ttr.term_loss

    def recording(*args):
        loss, acc = loss_fn(*args)
        seen.append(loss.item())
        return loss, acc

    monkeypatch.setattr(ttr, "term_loss", recording)
    return seen


def _logged_losses(lines):
    return np.asarray([float(s.split("loss=")[1].split()[0]) for s in lines])


def test_train_term_table_matches_jax(metas, monkeypatch):
    pairs = jtr.build_pairs(metas, max_per_kind=200)
    feats = jtr.featurize_pairs(pairs, n_buckets=4096)
    dirs = sorted({m["path"].rsplit("/", 1)[0] for _, m in pairs})
    assert len(dirs) == 2
    feats["group"] = np.asarray([dirs.index(m["path"].rsplit("/", 1)[0]) for _, m in pairs])
    jlog, tlog = [], []
    jexact = _record_jax_losses(monkeypatch)
    want = jtr.train_term_table(feats, log=jlog.append, **GEOMETRY)
    texact = _record_port_losses(monkeypatch)
    got = ttr.train_term_table(feats, log=tlog.append, device="cpu", **GEOMETRY)
    assert len(jexact) == len(texact) == 30
    assert abs(texact[0] - jexact[0]) <= 1e-5
    assert len(tlog) == len(jlog) == 30
    np.testing.assert_allclose(_logged_losses(tlog), _logged_losses(jlog), rtol=1e-3)
    assert got.shape == want.shape == (4096, 16) and got.dtype == np.float32
    cos = (got * want).sum(1) / np.linalg.norm(got, axis=1) / np.linalg.norm(want, axis=1)
    assert cos.min() >= 0.999


def test_init_table_is_jax_draw():
    want = 0.02 * np.asarray(jax.random.normal(jax.random.PRNGKey(5), (4096, 16), jnp.float32))
    got = ttr.init_table(4096, 16, 5, torch.device("cpu")).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_training_separates_synonyms():
    """Terms that co-occur as (query, positive-doc) must embed closer than
    unrelated terms: train on pairs where query term A always points at
    docs holding term B, and A' at B'."""
    rng = np.random.default_rng(1)
    n, buckets = 400, 512
    A, B_, A2, B2 = 1, 2, 3, 4
    q_ids = np.full((n, 4), -1, np.int32)
    d_ids = np.full((n, 8), -1, np.int32)
    for i in range(n):
        if i % 2 == 0:
            q_ids[i, 0] = A
            d_ids[i, 0] = B_
        else:
            q_ids[i, 0] = A2
            d_ids[i, 0] = B2
        d_ids[i, 1:] = rng.integers(5, buckets, 7)
    table = ttr.train_term_table(
        {"q_ids": q_ids, "d_ids": d_ids},
        n_buckets=buckets, dim=8, steps=120, batch_size=64, log_every=0, device="cpu",
    )
    t = table / np.maximum(np.linalg.norm(table, axis=1, keepdims=True), 1e-9)
    assert t[A] @ t[B_] > t[A] @ t[B2] + 0.2
    assert t[A2] @ t[B2] > t[A2] @ t[B_] + 0.2


def test_tables_cross_load(tmp_path):
    table = np.random.default_rng(0).standard_normal((64, 8)).astype(np.float32) * 3.0
    ttr.save_table(table, tmp_path / "t.npz")
    jtr.save_table(table, tmp_path / "j.npz")
    for path in ("t.npz", "j.npz"):
        np.testing.assert_array_equal(ttr.load_table(tmp_path / path),
                                      jtr.load_table(tmp_path / path))
    np.testing.assert_array_equal(np.load(tmp_path / "t.npz")["table"],
                                  np.load(tmp_path / "j.npz")["table"])
    assert ttr.load_table(tmp_path / "absent.npz") is None
