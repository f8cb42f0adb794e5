"""The port's LM training against the JAX package's, on the CPU.

- ``build_qa_texts`` gives equal strings, and ``WindowBatcher`` equal
  batches bit for bit, with and without the anchored QA mix (0.5);
- ``LMTrainer`` on a small config (hidden 64, 2 layers, 4 heads, MLP 128,
  vocab 512, seq 32, batch 8) from ``init_params(cfg, seed=0)`` in both
  packages: at float32 the loss and accuracy within 1e-5, every gradient
  (mapped back by ``decoder_state_to_jax``) within rtol 1e-4 / atol 1e-6 of
  ``jax.grad``'s (``wpe`` and ``wte`` included: both get their gradient
  through the embeddings, ``wte`` also through the tied head), and five
  full steps' losses within 1e-3 relative; at bfloat16 the first loss within
  2e-2 (found: 1.7e-5);
- checkpoints: ``decoder_state_to_jax`` inverts ``decoder_state_from_jax``;
  after port steps, the port's ``save_lm_params`` loads in the JAX
  package's ``load_lm_params`` with equal arrays, and ``tpu-lm`` answers
  from it through the port's pipeline without the fallback (the mirror of
  ``tests/test_train_lm.py::test_trained_lm_answers_through_pipeline``).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semcode_tpu.models import decoder as jdec
from semcode_tpu.models import tokenizer as jtok
from semcode_tpu.models import train_lm as jtl
from semcode_tpu.parallel.mesh import make_mesh
from semcode_tpu_torch.chunking.chunker import CodeChunker
from semcode_tpu_torch.models import decoder as tdec
from semcode_tpu_torch.models import tokenizer as ttok
from semcode_tpu_torch.models import train_lm as ttl

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(vocab_size=512, hidden=64, layers=2, heads=4, mlp_dim=128, max_len=32)
SEQ, BATCH = 32, 8
CORPUS = [
    "def add(a, b):\n    return a + b\n" * 4,
    "class VectorStore:\n    def search(self, q):\n        pass\n" * 3,
    "for i in range(10):\n    print(i)\n" * 5,
]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The models here are tiny: torch's intra-op threads would only contend
    with the other test processes (pytest-xdist runs several files at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, np.asarray(tree, dtype=np.float32)


def _lm_batch(seed, vocab=512):
    rng = np.random.default_rng(seed)
    lens = rng.integers(3, SEQ + 1, size=BATCH)
    mask = (np.arange(SEQ)[None] < lens[:, None]).astype(np.int32)
    ids = rng.integers(2, vocab, size=(BATCH, SEQ)).astype(np.int32)
    return {"ids": np.where(mask > 0, ids, 0).astype(np.int32), "mask": mask}


def _chunks():
    chunker, chunks = CodeChunker(), []
    for f in sorted((ROOT / "semcode_tpu" / "index").glob("*.py")):
        rel = f.relative_to(ROOT)
        chunks += chunker.chunk_text(f.read_text(encoding="utf-8"), path=rel,
                                     language="python")
    return chunks


# -- the data -----------------------------------------------------------------------


def test_build_qa_texts_and_window_batches_are_equal():
    chunks = _chunks()
    want_qa = jtl.build_qa_texts(chunks)
    got_qa = ttl.build_qa_texts(chunks)
    assert got_qa == want_qa and len(got_qa) > 50
    assert ttl.build_qa_texts(chunks, ctx_chars=40) == jtl.build_qa_texts(chunks, ctx_chars=40)
    texts = [c.content for c in chunks]
    for frac in (0.0, 0.5):
        kwargs = dict(seq_len=128, batch_size=16, seed=5, anchored_texts=got_qa,
                      anchored_frac=frac)
        jb = jtl.WindowBatcher(texts, jtok.ByteTokenizer(), **kwargs)
        tb = ttl.WindowBatcher(texts, ttok.ByteTokenizer(), **kwargs)
        n = 0
        for want, got in zip(jb.batches(5), tb.batches(5)):
            for k in ("ids", "mask"):
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k], err_msg=f"{k} {frac}")
            n += 1
        assert n == 5


# -- LMTrainer ----------------------------------------------------------------------


def _trainers(jdtype, tdtype, lr=1e-3):
    jt = jtl.LMTrainer(jdec.DecoderConfig(dtype=jdtype, **SMALL),
                       make_mesh((1,), ("data",), devices=jax.devices()[:1]),
                       learning_rate=lr)
    tt = ttl.LMTrainer(tdec.DecoderConfig(dtype=tdtype, **SMALL), learning_rate=lr,
                       device="cpu")
    return (jt, *jt.init_state(seed=0)), (tt, *tt.init_state(seed=0))


def test_lm_step_matches_jax_at_float32():
    (jt, jp, jo), (tt, tp, to) = _trainers(jnp.float32, torch.float32)
    batch = _lm_batch(0)
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(jt._loss_fn, has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tm, tgrads = tt.value_and_grad(tp, batch)
    assert abs(float(tm["loss"]) - float(jloss)) <= 1e-5
    assert abs(float(tm["accuracy"]) - float(jm["accuracy"])) <= 1e-5
    want = dict(_leaves(jax.tree_util.tree_map(np.asarray, jgrads)))
    got = dict(_leaves(tdec.decoder_state_to_jax(tgrads)))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)
    assert np.abs(got["/wpe"]).sum() > 0
    jl, tl = [], []
    for i in range(5):
        b = _lm_batch(i + 1)
        jp, jo, m1 = jt.train_step(jp, jo, b)
        tp, to, m2 = tt.train_step(tp, to, b)
        jl.append(float(m1["loss"]))
        tl.append(float(m2["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=1e-3)


def test_lm_first_loss_matches_jax_at_bfloat16():
    (jt, jp, _), (tt, tp, _) = _trainers(jnp.bfloat16, torch.bfloat16)
    batch = _lm_batch(0)
    jloss, _ = jax.jit(jt._loss_fn)(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tm, tgrads = tt.value_and_grad(tp, batch)
    assert abs(float(tm["loss"]) - float(jloss)) <= 2e-2
    for name, g in tgrads.items():
        assert tp[name].dtype == torch.float32 and g.dtype == torch.float32, name
    assert tgrads["wpe"].abs().sum() > 0


# -- checkpoints --------------------------------------------------------------------


def test_decoder_state_to_jax_inverts_from_jax():
    params = tdec.init_params(tdec.DecoderConfig(**SMALL), seed=3)
    back = tdec.decoder_state_to_jax(tdec.decoder_state_from_jax(params))
    want, got = dict(_leaves(params)), dict(_leaves(back))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("tdtype", [torch.float32, torch.bfloat16])
def test_trained_lm_checkpoint_loads_in_jax_and_answers(tmp_path, tdtype):
    from semcode_tpu_torch.index.store import SearchHit
    from semcode_tpu_torch.rag.pipeline import SemanticSearchPipeline
    from semcode_tpu_torch.settings import AppSettings

    tok = ttok.ByteTokenizer(max_len=48)
    cfg = tdec.DecoderConfig(vocab_size=tok.vocab_size, hidden=64, layers=2, heads=2,
                             mlp_dim=128, max_len=64, dtype=tdtype)
    # enough steps that greedy decoding emits non-whitespace tokens (an
    # empty completion is treated as an LLM failure by design)
    trainer = ttl.LMTrainer(cfg, learning_rate=1e-2, device="cpu")
    params, opt_state = trainer.init_state(seed=0)
    for batch in ttl.WindowBatcher(CORPUS, tok, seq_len=48, batch_size=16,
                                   seed=1).batches(40):
        params, opt_state, _ = trainer.train_step(params, opt_state, batch)
    tree = tdec.decoder_state_to_jax(params)
    ttl.save_lm_params(tree, cfg, tmp_path)

    jparams, jcfg = jtl.load_lm_params(tmp_path)
    assert jcfg.layers == 2 and jcfg.hidden == 64
    assert jcfg.dtype == (jnp.float32 if tdtype == torch.float32 else jnp.bfloat16)
    got = dict(_leaves(jax.tree_util.tree_map(np.asarray, jparams)))
    want = dict(_leaves(tree))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    class Store:
        def search(self, vector, top_k=10, filters=None, **kw):
            return [SearchHit(id="c1", score=0.9, repo="r", path="a.py",
                              language="python",
                              text="def add(a, b):\n    return a + b")][:top_k]

    class Emb:
        def embed_query(self, text):
            return [1.0, 0.0]

    app = AppSettings(rag_provider="tpu-lm", rag_weights_path=tmp_path,
                      rag_max_new_tokens=8, rag_query_cache_size=0)
    out = SemanticSearchPipeline(config=app, vector_store=Store(), embeddings=Emb(),
                                 device="cpu").query("what does add do?")
    assert out["sources"], "retrieval must feed the generator"
    assert isinstance(out["answer"], str) and out["answer"].strip()
    assert not out["meta"]["fallback_used"]
