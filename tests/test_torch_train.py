"""The port's encoder training against the JAX package's, on the CPU.

Both packages get the same numpy inputs in one process; JAX runs on a
one-device mesh.

- ``PairBatcher``: five batches equal bit for bit, with paths (same-file
  hard negatives), symbols and docstrings in the texts;
- ``ContrastiveTrainer`` on a small config (hidden 64, 2 layers, 4 heads,
  MLP 128, vocab 512, seq 32, batch 8) from flax's init carried across by
  ``encoder_state_from_jax``: at float32 the loss and accuracy within 1e-5,
  every gradient (mapped back by ``encoder_state_to_jax``) within rtol 1e-4
  / atol 1e-6 of ``jax.grad``'s, and five full steps' losses within 1e-3
  relative; at bfloat16 the first loss within 2e-2 (found: 9.0e-3; XLA and
  torch round the bf16 products and sums in their own orders);
- the optimizer and schedule: the same gradients fed to ``optax.adamw``
  and to ``train.adamw`` for 6 steps, with and without a warmup-cosine
  schedule: params within 1e-6, the schedule equal to optax's (rtol 1e-6)
  at every count;
- ``hash_embedder.jax_normal_f32`` against ``jax.random.normal`` (rtol 1e-5:
  torch's erfinv is not XLA's polynomial);
- checkpoints: ``encoder_state_to_jax`` inverts ``encoder_state_from_jax``;
  after a port step, the port's ``save_params`` loads in the JAX package's
  ``load_params`` with equal arrays, and both packages' ``EncoderEmbeddings``
  on it embed the same texts at per-row cosine >= 0.9999 (float32).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from semcode_tpu.models import data as jdata
from semcode_tpu.models import encoder as jenc
from semcode_tpu.models import tokenizer as jtok
from semcode_tpu.models import train as jtrain
from semcode_tpu.parallel.mesh import make_mesh
from semcode_tpu_torch.chunking.chunker import CodeChunker
from semcode_tpu_torch.embeddings.hash_embedder import jax_normal_f32
from semcode_tpu_torch.models import data as tdata
from semcode_tpu_torch.models import encoder as tenc
from semcode_tpu_torch.models import tokenizer as ttok
from semcode_tpu_torch.models import train as ttrain

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(vocab_size=512, hidden=64, layers=2, heads=4, mlp_dim=128, max_len=32)
SEQ, BATCH = 32, 8


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The models here are tiny: torch's intra-op threads would only contend
    with the other test processes (pytest-xdist runs several files at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh():
    return make_mesh((1,), ("data",), devices=jax.devices()[:1])


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree, dtype=np.float32)


def _pair_batch(seed, vocab=512):
    """Anchor and positive rows: CLS first, random lengths, pad after."""
    rng = np.random.default_rng(seed)
    out = {}
    for side in ("anchor", "pos"):
        lens = rng.integers(3, SEQ + 1, size=BATCH)
        mask = (np.arange(SEQ)[None] < lens[:, None]).astype(np.int32)
        ids = rng.integers(2, vocab, size=(BATCH, SEQ)).astype(np.int32)
        ids[:, 0] = 1
        out[f"{side}_ids"] = np.where(mask > 0, ids, 0).astype(np.int32)
        out[f"{side}_mask"] = mask
    return out


def _trainers(jdtype, tdtype, lr=1e-3, vocab=512):
    kwargs = {**SMALL, "vocab_size": vocab}
    jcfg = jenc.EncoderConfig(dtype=jdtype, **kwargs)
    tcfg = tenc.EncoderConfig(dtype=tdtype, **kwargs)
    jt = jtrain.ContrastiveTrainer(jcfg, _mesh(), learning_rate=lr)
    jp, jo = jt.init_state(jax.random.PRNGKey(0), seq_len=SEQ)
    tt = ttrain.ContrastiveTrainer(tcfg, learning_rate=lr, device="cpu")
    tp, to = tt.state_from(tenc.encoder_state_from_jax(
        jax.tree_util.tree_map(np.asarray, jp)))
    return (jt, jp, jo), (tt, tp, to)


# -- PairBatcher ------------------------------------------------------------------


def test_pair_batcher_batches_are_bit_identical():
    chunker = CodeChunker()
    texts, symbols, languages, paths = [], [], [], []
    for f in sorted((ROOT / "semcode_tpu" / "index").glob("*.py")):
        rel = str(f.relative_to(ROOT))
        for c in chunker.chunk_text(f.read_text(encoding="utf-8"), path=rel,
                                    language="python"):
            texts.append(c.content)
            symbols.append(c.symbol)
            languages.append(c.language)
            paths.append(rel)
    assert sum(s is not None for s in symbols) > 20
    kwargs = dict(seq_len=64, batch_size=16, seed=3, symbols=symbols,
                  languages=languages, paths=paths)
    jb = jdata.PairBatcher(texts, jtok.HashingTokenizer(max_len=64), **kwargs)
    tb = tdata.PairBatcher(texts, ttok.HashingTokenizer(max_len=64), **kwargs)
    assert tb._by_path and tb._by_path.keys() == jb._by_path.keys()
    assert any(d is not None for d in tb._docs) and tb._docs == jb._docs
    assert tb._sym_queries == jb._sym_queries
    n = 0
    for want, got in zip(jb.batches(5), tb.batches(5)):
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        n += 1
    assert n == 5


# -- ContrastiveTrainer -------------------------------------------------------------


def test_contrastive_step_matches_jax_at_float32():
    (jt, jp, jo), (tt, tp, to) = _trainers(jnp.float32, torch.float32)
    batch = _pair_batch(0)
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(jt._loss_fn, has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tm, tgrads = tt.value_and_grad(tp, batch)
    assert abs(float(tm["loss"]) - float(jloss)) <= 1e-5
    assert abs(float(tm["accuracy"]) - float(jm["accuracy"])) <= 1e-5
    want = dict(_leaves(jax.tree_util.tree_map(np.asarray, jgrads)))
    got = dict(_leaves(tenc.encoder_state_to_jax(tgrads, tt.cfg)))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)
    jl, tl = [], []
    for i in range(5):
        b = _pair_batch(i + 1)
        jp, jo, m1 = jt.train_step(jp, jo, b)
        tp, to, m2 = tt.train_step(tp, to, b)
        jl.append(float(m1["loss"]))
        tl.append(float(m2["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    assert tl[-1] < tl[0]


def test_contrastive_first_loss_matches_jax_at_bfloat16():
    (jt, jp, _), (tt, tp, _) = _trainers(jnp.bfloat16, torch.bfloat16)
    batch = _pair_batch(0)
    jloss, _ = jax.jit(jt._loss_fn)(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tm, tgrads = tt.value_and_grad(tp, batch)
    assert abs(float(tm["loss"]) - float(jloss)) <= 2e-2
    # the masters stay float32 and get float32 gradients through the casts
    for name, g in tgrads.items():
        assert tp[name].dtype == torch.float32 and g.dtype == torch.float32, name
    assert all(torch.isfinite(g).all() for g in tgrads.values())
    assert tgrads["pos_emb"].abs().sum() > 0 and tgrads["tok_emb.weight"].abs().sum() > 0


# -- optimizer and schedule ---------------------------------------------------------


@pytest.mark.parametrize("warmup", [0, 3])
def test_adamw_and_schedule_match_optax(warmup):
    lr, steps = 1e-2, 6
    rng = np.random.default_rng(warmup)
    shapes = {"w": (5, 7), "b": (7,), "s": ()}
    init = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(steps)]
    if warmup:
        jsched = optax.warmup_cosine_decay_schedule(0.0, lr, warmup, max(steps, warmup + 1))
        tsched = ttrain.warmup_cosine_decay_schedule(0.0, lr, warmup, max(steps, warmup + 1))
        for count in range(steps + 3):
            np.testing.assert_allclose(tsched(count), float(jsched(count)),
                                       rtol=1e-6, atol=1e-12, err_msg=str(count))
        assert tsched(0) == 0.0
    else:
        jsched = tsched = lr
    tx = optax.adamw(jsched, weight_decay=0.01)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = tx.init(jparams)
    tparams = ttrain.master_params({k: torch.from_numpy(v) for k, v in init.items()},
                                   torch.device("cpu"))
    opt = ttrain.adamw(tparams, tsched, weight_decay=0.01)
    for step, g in enumerate(grads):
        updates, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                    jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for k in shapes:
            np.testing.assert_allclose(tparams[k].detach().numpy(), np.asarray(jparams[k]),
                                       rtol=0, atol=1e-6, err_msg=f"{k} step {step}")
        if warmup and step == 0:  # the first update ran at schedule(0) = 0
            for k in shapes:
                np.testing.assert_array_equal(tparams[k].detach().numpy(), init[k])


# -- jax_normal_f32 -----------------------------------------------------------------


@pytest.mark.parametrize("seed,shape", [(0, (4096, 16)), (7, (1001, 3))])
def test_jax_normal_f32_matches_jax(seed, shape):
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape, jnp.float32))
    got = jax_normal_f32(seed, shape, torch.device("cpu")).numpy()
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


# -- checkpoints --------------------------------------------------------------------


def test_encoder_state_to_jax_inverts_from_jax():
    for kwargs in ({}, dict(post_ln=True, emb_ln=True, type_vocab=2)):
        jcfg = jenc.EncoderConfig(dtype=jnp.float32, **SMALL, **kwargs)
        params = jenc.CodeEncoder(jcfg).init(
            jax.random.PRNGKey(4), jnp.zeros((1, 8), jnp.int32), jnp.ones((1, 8), jnp.int32))
        want = dict(_leaves(jax.tree_util.tree_map(np.asarray, params)))
        tcfg = tenc.EncoderConfig(dtype=torch.float32, **SMALL, **kwargs)
        back = tenc.encoder_state_to_jax(
            tenc.encoder_state_from_jax(jax.tree_util.tree_map(np.asarray, params)), tcfg)
        got = dict(_leaves(back))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_trained_encoder_checkpoint_loads_and_embeds_in_both(tmp_path):
    from semcode_tpu.models.train import load_params as jload

    (_, _, _), (tt, tp, to) = _trainers(jnp.float32, torch.float32, vocab=32768)
    tp, to, _ = tt.train_step(tp, to, _pair_batch(0, vocab=32768))
    tree = tenc.encoder_state_to_jax(tp, tt.cfg)
    ttrain.save_params(tree, tt.cfg, tmp_path / "enc")
    jparams, jcfg = jload(tmp_path / "enc")
    assert jcfg.dtype == jnp.float32 and jcfg.hidden == 64 and jcfg.vocab_size == 32768
    got = dict(_leaves(jax.tree_util.tree_map(np.asarray, jparams)))
    want = dict(_leaves(tree))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    texts = ["parse the config file", "def add(a, b):\n    return a + b\n",
             "class VectorStore:\n    def search(self, q):\n        pass\n" * 8]
    jemb = jenc.EncoderEmbeddings(weights_path=tmp_path / "enc")
    temb = tenc.EncoderEmbeddings(weights_path=tmp_path / "enc", device="cpu")
    assert temb.signature == jemb.signature
    for fn in ("embed_documents", "embed_queries"):
        a = np.asarray(getattr(temb, fn)(texts))
        b = np.asarray(getattr(jemb, fn)(texts))
        cos = (a * b).sum(1) / np.linalg.norm(a, axis=1) / np.linalg.norm(b, axis=1)
        assert cos.min() >= 0.9999, (fn, cos)
