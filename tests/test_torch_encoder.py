"""The port's transformer encoder against the JAX package's, on the CPU.

- a small config (2 layers, hidden 64, 4 heads, MLP 128, vocab 512,
  max_len 64) with flax-initialised, perturbed params carried across by
  ``encoder_state_from_jax``, pre-LN and post-LN (``emb_ln``, ``type_vocab
  2``), with padded and all-pad rows: atol 1e-5 at f32, per-row cosine
  >= 0.999 at bf16, all-pad rows zero in both;
- the shipped encoder-mini checkpoint: the port's ``load_params`` equals
  the JAX package's bit for bit; ``embed_query``, ``embed_queries`` and the
  windowed ``embed_documents`` agree at per-row cosine >= 0.999 with equal
  window counts; the signatures are identical;
- ``save_params`` round trips in both directions, also with ``half=True``;
- the HF loader on a synthetic BERT directory (safetensors): equal param
  trees and an equal forward at f32;
- the tokenizers give identical ids and masks.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semcode_tpu.models import encoder as jenc
from semcode_tpu.models import tokenizer as jtok
from semcode_tpu_torch.models import encoder as tenc
from semcode_tpu_torch.models import tokenizer as ttok

SMALL = dict(vocab_size=512, hidden=64, layers=2, heads=4, mlp_dim=128, max_len=64)
LAYOUTS = {
    "pre_ln": {},
    "post_ln": dict(post_ln=True, emb_ln=True, type_vocab=2),
}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _to_numpy(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, dtype=np.float32), tree)


def _flax_params(cfg, seed):
    """flax's own init, perturbed so that every layernorm scale and bias and
    every product bias differs from its init value."""
    params = jenc.CodeEncoder(cfg).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32),
        jnp.ones((1, 8), jnp.int32))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32)
        + 0.05 * rng.standard_normal(x.shape).astype(np.float32), params)


def _batch(seed, vocab, lengths, width):
    rng = np.random.default_rng(seed)
    ids = np.zeros((len(lengths), width), np.int32)
    mask = np.zeros_like(ids)
    for i, n in enumerate(lengths):
        ids[i, :n] = rng.integers(2, vocab, size=n)
        mask[i, :n] = 1
    return ids, mask


def _port_model(cfg_kwargs, tdtype, params):
    model = tenc.CodeEncoder(tenc.EncoderConfig(dtype=tdtype, **cfg_kwargs))
    model.load_state_dict(tenc.encoder_state_from_jax(params))
    return model.eval()


def _row_cos(a, b):
    num = (a * b).sum(axis=1)
    den = np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1)
    return num / den


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_small_config_forward_matches_flax(layout, dtype):
    jdtype, tdtype = DTYPES[dtype]
    kwargs = {**SMALL, **LAYOUTS[layout]}
    jcfg = jenc.EncoderConfig(dtype=jdtype, **kwargs)
    params = _flax_params(jcfg, seed=3)
    lengths = [64, 40, 1, 0, 17, 64, 0, 9]  # full, padded and all-pad rows
    ids, mask = _batch(5, SMALL["vocab_size"], lengths, 64)
    want = np.asarray(jenc.CodeEncoder(jcfg).apply(params, ids, mask), np.float32)
    model = _port_model(kwargs, tdtype, _to_numpy(params))
    with torch.inference_mode():
        got = model(torch.from_numpy(ids).long(), torch.from_numpy(mask).long()).numpy()
    assert got.shape == want.shape == (len(lengths), SMALL["hidden"])
    assert got.dtype == np.float32
    pad = np.asarray(lengths) == 0
    np.testing.assert_array_equal(got[pad], 0.0)
    np.testing.assert_array_equal(want[pad], 0.0)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        assert _row_cos(got[~pad], want[~pad]).min() >= 0.999


def test_attention_scale_is_rounded_to_the_compute_dtype():
    # flax divides the query by jnp.sqrt(head_dim).astype(dtype)
    cfg = tenc.EncoderConfig(**SMALL)  # head_dim 16: sqrt exact in bf16
    assert tenc._Attention(cfg).scale == 4.0
    mini = tenc.EncoderConfig.preset("mini")
    assert tenc._Attention(mini).scale == 5.65625
    f32 = tenc.EncoderConfig.preset("mini", dtype=torch.float32)
    assert tenc._Attention(f32).scale == pytest.approx(32 ** 0.5, rel=1e-7)
    assert tenc.LN_EPS == 1e-6


def test_presets_and_buckets_match():
    for name in ("mini", "base", "large"):
        j = jenc.EncoderConfig.preset(name, vocab_size=1000, max_len=128)
        t = tenc.EncoderConfig.preset(name, vocab_size=1000, max_len=128)
        for field in ("vocab_size", "hidden", "layers", "heads", "mlp_dim",
                      "max_len", "post_ln", "emb_ln", "type_vocab"):
            assert getattr(j, field) == getattr(t, field)
    with pytest.raises(ValueError, match="unknown encoder preset"):
        tenc.EncoderConfig.preset("huge")
    for n in (1, 63, 64, 65, 200, 256, 257, 511, 512, 900):
        for max_len in (64, 256, 512, 1024):
            assert tenc._len_bucket(n, max_len) == jenc._len_bucket(n, max_len)


# -- the shipped checkpoint ---------------------------------------------------


@pytest.fixture(scope="module")
def shipped():
    jemb = jenc.EncoderEmbeddings()
    temb = tenc.EncoderEmbeddings(device="cpu")
    return jemb, temb


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def test_shipped_checkpoint_loads_bit_for_bit(shipped):
    from semcode_tpu.models.train import load_params as jload
    from semcode_tpu_torch.models.train import load_params as tload

    path = tenc.shipped_checkpoint()
    jparams, jcfg = jload(path)
    tparams, tcfg = tload(path)
    jl = dict(_leaves(jax.tree_util.tree_map(np.asarray, jparams)))
    tl = dict(_leaves(tparams))
    assert sorted(jl) == sorted(tl) and len(tl) == 100
    for key, want in jl.items():
        got = tl[key]
        assert got.dtype == want.dtype == np.float32, key
        assert got.shape == want.shape, key
        np.testing.assert_array_equal(got, want, err_msg=key)
    assert (tcfg.hidden, tcfg.layers, tcfg.heads, tcfg.mlp_dim, tcfg.max_len) == (
        jcfg.hidden, jcfg.layers, jcfg.heads, jcfg.mlp_dim, jcfg.max_len)
    assert tcfg.max_len == 256 and tcfg.dtype == torch.bfloat16
    # the config file decides: windows hold 255 tokens although the
    # provider's max_tokens is 512
    jemb, temb = shipped
    assert temb.cfg.max_len == jemb.cfg.max_len == 256
    assert not temb.random_init


QUERIES = [
    "where is the flat index defined",
    "how are int8 rows quantized",
    "quantize_rows_device",
    "VectorStore.search_batch(",
    "lockFreeSnapshot of the device arrays",
    "",
    "x",
    "what happens when the store promotes to IVF",
]


def _docs():
    from pathlib import Path

    root = Path(__file__).resolve().parents[1] / "semcode_tpu" / "index"
    long_a = (root / "store.py").read_text()[:9000]
    long_b = (root / "flat.py").read_text()[:7000]
    return ["def parse_config(path):\n    return toml.load(path)\n",
            long_a, "class Store:\n    pass\n", long_b, "", "snake_case_name"]


def test_shipped_signatures_identical(shipped):
    jemb, temb = shipped
    assert temb.signature == jemb.signature
    assert temb.signature.startswith("encoder:") and temb.signature.endswith(":d384")
    assert temb.dim == jemb.dim == 384


def test_shipped_queries_match(shipped):
    jemb, temb = shipped
    want = np.asarray(jemb.embed_queries(QUERIES), np.float32)
    got = np.asarray(temb.embed_queries(QUERIES), np.float32)
    assert got.shape == want.shape == (len(QUERIES), 384)
    assert _row_cos(got, want).min() >= 0.999
    one = np.asarray(temb.embed_query(QUERIES[0]), np.float32)
    assert _row_cos(one[None], np.asarray([jemb.embed_query(QUERIES[0])]))[0] >= 0.999
    # a query's vector does not depend on what it was batched with
    np.testing.assert_array_equal(one, got[0])
    again = np.asarray(temb.embed_queries(QUERIES[::-1][:5] + QUERIES[:3]), np.float32)
    np.testing.assert_array_equal(again[5:], got[:3])


def test_shipped_documents_match_with_equal_windows(shipped):
    jemb, temb = shipped
    docs = _docs()
    window = temb.cfg.max_len - 1

    def windows(emb, text):
        n = len(emb.tokenizer.encode_ids(text, cap=window * emb.MAX_DOC_WINDOWS))
        return max(1, -(-n // window))

    counts = [windows(temb, d) for d in docs]
    assert counts == [windows(jemb, d) for d in docs]
    assert sum(c >= 3 for c in counts) >= 2  # two documents take 3+ windows
    want = np.asarray(jemb.embed_documents(docs), np.float32)
    got = np.asarray(temb.embed_documents(docs), np.float32)
    assert _row_cos(got, want).min() >= 0.999


def test_concurrent_queries_give_the_serial_vectors(shipped):
    """The API's query threads and ingest worker share one encoder: its
    forward keeps no state, so threads get the serial vectors bit for bit."""
    import sys
    import threading

    _, temb = shipped
    want = np.asarray(temb.embed_queries(QUERIES), np.float32)
    docs = _docs()[2:4]
    want_docs = np.asarray(temb.embed_documents(docs), np.float32)
    got, errors = {}, []

    def work(i):
        try:
            if i % 4 == 3:
                got[i] = np.asarray(temb.embed_documents(docs), np.float32)
            else:
                got[i] = np.asarray(temb.embed_queries(QUERIES[i % 3:]), np.float32)
        except Exception as exc:  # noqa: BLE001 - reported by the assert below
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not errors and not any(t.is_alive() for t in threads)
    assert len(got) == 12
    for i, v in got.items():
        if i % 4 == 3:
            np.testing.assert_array_equal(v, want_docs)
        else:
            np.testing.assert_array_equal(v, want[i % 3:])


def test_random_init_is_seeded_and_signed_apart(tmp_path):
    missing = tmp_path / "no-checkpoint"
    a = tenc.EncoderEmbeddings(weights_path=missing, max_tokens=64, device="cpu", seed=1)
    again = tenc.EncoderEmbeddings(weights_path=missing, max_tokens=64, device="cpu", seed=1)
    other = tenc.EncoderEmbeddings(weights_path=missing, max_tokens=64, device="cpu", seed=2)
    assert a.random_init and a.dim == 384
    # the port's draw is not flax's: it must not share the reference's
    # random-init signature, and another seed is another vector definition
    ref = jenc.EncoderEmbeddings(weights_path=missing, max_tokens=64)
    assert ref.signature == "encoder:random:d384"
    assert a.signature == "encoder:torch-random:s1:d384"
    assert len({a.signature, other.signature, ref.signature}) == 3
    v = np.asarray(a.embed_queries(["tokens of a query"]))
    np.testing.assert_array_equal(v, np.asarray(again.embed_queries(["tokens of a query"])))
    assert abs(np.linalg.norm(v[0]) - 1.0) < 1e-5
    with pytest.raises(ValueError, match="embedding_dimension=512"):
        tenc.EncoderEmbeddings(weights_path=missing, dim=512, max_tokens=64, device="cpu")


# -- checkpoints: save_params both ways -----------------------------------------


@pytest.mark.parametrize("half", [False, True])
def test_save_params_round_trips_both_ways(tmp_path, half):
    from semcode_tpu.models.train import load_params as jload
    from semcode_tpu.models.train import save_params as jsave
    from semcode_tpu_torch.models.train import load_params as tload
    from semcode_tpu_torch.models.train import save_params as tsave

    for layout in sorted(LAYOUTS):
        kwargs = {**SMALL, **LAYOUTS[layout]}
        jcfg = jenc.EncoderConfig(dtype=jnp.bfloat16, **kwargs)
        tcfg = tenc.EncoderConfig(dtype=torch.bfloat16, **kwargs)
        params = _flax_params(jcfg, seed=11)
        want = {k: (v.astype(np.float16).astype(np.float32) if half else v)
                for k, v in _leaves(_to_numpy(params))}
        # the port writes, the JAX package reads
        tsave(_to_numpy(params), tcfg, tmp_path / f"t-{layout}", half=half)
        jparams, jcfg_back = jload(tmp_path / f"t-{layout}")
        got = dict(_leaves(jax.tree_util.tree_map(np.asarray, jparams)))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert jcfg_back == jcfg
        # the JAX package writes, the port reads
        jsave(params, jcfg, tmp_path / f"j-{layout}", half=half)
        tparams, tcfg_back = tload(tmp_path / f"j-{layout}")
        got = dict(_leaves(tparams))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert tcfg_back == tcfg
        # the port reads back what it wrote
        again, _ = tload(tmp_path / f"t-{layout}")
        for k, v in _leaves(again):
            np.testing.assert_array_equal(v, want[k], err_msg=k)
        assert json.loads((tmp_path / f"t-{layout}" / "semcode_encoder.json")
                          .read_text())["dtype"] == "bfloat16"


def test_checkpoint_provider_uses_the_checkpoint_config(tmp_path):
    """A saved small checkpoint drives both providers the same way."""
    from semcode_tpu.models.train import save_params as jsave

    jcfg = jenc.EncoderConfig(dtype=jnp.float32, **{**SMALL, "vocab_size": 32768})
    params = _flax_params(jcfg, seed=2)
    jsave(params, jcfg, tmp_path / "ckpt")
    jemb = jenc.EncoderEmbeddings(weights_path=tmp_path / "ckpt")
    temb = tenc.EncoderEmbeddings(weights_path=tmp_path / "ckpt", device="cpu")
    assert temb.cfg.dtype == torch.float32 and temb.dim == 64
    assert temb.signature == jemb.signature
    texts = ["short query", "def f(x):\n    return x * 2\n" * 40]
    np.testing.assert_allclose(np.asarray(temb.embed_documents(texts)),
                               np.asarray(jemb.embed_documents(texts)), atol=1e-5)
    np.testing.assert_allclose(np.asarray(temb.embed_queries(texts)),
                               np.asarray(jemb.embed_queries(texts)), atol=1e-5)


# -- the HF loader ----------------------------------------------------------------


def _bert_dir(path, rng, hidden=32, heads=4, layers=2, mlp=64, vocab=50, maxpos=16):
    from safetensors.numpy import save_file

    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps({
        "vocab_size": vocab, "hidden_size": hidden, "num_hidden_layers": layers,
        "num_attention_heads": heads, "intermediate_size": mlp,
        "max_position_embeddings": maxpos, "type_vocab_size": 2}))

    def w(*shape, scale=0.08):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    raw = {
        "bert.embeddings.word_embeddings.weight": w(vocab, hidden),
        "bert.embeddings.position_embeddings.weight": w(maxpos, hidden),
        "bert.embeddings.token_type_embeddings.weight": w(2, hidden),
        "bert.embeddings.LayerNorm.weight": 1.0 + w(hidden, scale=0.02),
        "bert.embeddings.LayerNorm.bias": w(hidden, scale=0.02),
    }
    for i in range(layers):
        p = f"bert.encoder.layer.{i}."
        for name in ("query", "key", "value"):
            raw[p + f"attention.self.{name}.weight"] = w(hidden, hidden)
            raw[p + f"attention.self.{name}.bias"] = w(hidden)
        raw.update({
            p + "attention.output.dense.weight": w(hidden, hidden),
            p + "attention.output.dense.bias": w(hidden),
            p + "attention.output.LayerNorm.weight": 1.0 + w(hidden, scale=0.02),
            p + "attention.output.LayerNorm.bias": w(hidden, scale=0.02),
            p + "intermediate.dense.weight": w(mlp, hidden),
            p + "intermediate.dense.bias": w(mlp),
            p + "output.dense.weight": w(hidden, mlp),
            p + "output.dense.bias": w(hidden),
            p + "output.LayerNorm.weight": 1.0 + w(hidden, scale=0.02),
            p + "output.LayerNorm.bias": w(hidden, scale=0.02),
        })
    save_file(raw, str(path / "model.safetensors"))


def test_hf_loader_matches_jax(tmp_path):
    from semcode_tpu.models.hf_loader import load_hf_encoder_params as jload
    from semcode_tpu_torch.models.hf_loader import load_hf_encoder_params as tload

    _bert_dir(tmp_path / "bert", np.random.default_rng(0))
    jparams, jcfg = jload(tmp_path / "bert", jenc.EncoderConfig(dtype=jnp.float32))
    tparams, tcfg = tload(tmp_path / "bert", tenc.EncoderConfig(dtype=torch.float32))
    assert (tcfg.post_ln, tcfg.emb_ln, tcfg.type_vocab, tcfg.max_len) == (True, True, 2, 16)
    jl = dict(_leaves(jax.tree_util.tree_map(np.asarray, jparams)))
    tl = dict(_leaves(tparams))
    assert sorted(jl) == sorted(tl)
    for k in jl:
        np.testing.assert_array_equal(tl[k], jl[k], err_msg=k)
    ids, mask = _batch(1, 50, [16, 10, 3, 0], 16)
    want = np.asarray(jenc.CodeEncoder(jcfg).apply(jparams, ids, mask))
    model = tenc.CodeEncoder(tcfg)
    model.load_state_dict(tenc.encoder_state_from_jax(tparams))
    with torch.inference_mode():
        got = model(torch.from_numpy(ids).long(), torch.from_numpy(mask).long()).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# -- the tokenizers ------------------------------------------------------------


TEXTS = [
    "def parse_config(path):\n    return toml.load(path)",
    "HTTPServerError in getUserName", "", "x", "naïve unicode — ünïcödé 42",
    "a " * 600,
]


def test_hashing_tokenizer_matches():
    j = jtok.HashingTokenizer(vocab_size=32768, max_len=64)
    t = ttok.HashingTokenizer(vocab_size=32768, max_len=64)
    for max_len in (None, 16, 256):
        ji, jm = j.encode_batch(TEXTS, max_len=max_len)
        ti, tm = t.encode_batch(TEXTS, max_len=max_len)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tm, jm)
    for text in TEXTS:
        for cap in (None, 5):
            np.testing.assert_array_equal(t.encode_ids(text, cap=cap),
                                          j.encode_ids(text, cap=cap))
    assert (ttok.PAD_ID, ttok.CLS_ID, ttok.RESERVED) == (0, 1, 2)


def test_byte_and_hf_tokenizers_match(tmp_path):
    from tokenizers import Tokenizer
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import Whitespace

    vocab = {"[PAD]": 0, "[UNK]": 1, "def": 2, "parse_config": 3, "(": 4,
             ")": 5, ":": 6, "return": 7, "x": 8, "a": 9}
    tok = Tokenizer(WordLevel(vocab, unk_token="[UNK]"))
    tok.pre_tokenizer = Whitespace()
    tok.save(str(tmp_path / "tokenizer.json"))
    j = jtok.load_tokenizer(tmp_path, 32768, 32)
    t = ttok.load_tokenizer(tmp_path, 32768, 32)
    assert isinstance(t, ttok.HFTokenizer) and t.vocab_size == j.vocab_size == 10
    ji, jm = j.encode_batch(TEXTS)
    ti, tm = t.encode_batch(TEXTS)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tm, jm)
    for text in TEXTS:
        np.testing.assert_array_equal(t.encode_ids(text, cap=7), j.encode_ids(text, cap=7))
        assert t.encode(text) == j.encode(text)
    assert t.decode([2, 3]) == j.decode([2, 3])
    assert isinstance(ttok.load_tokenizer(None, 100, 8), ttok.HashingTokenizer)
    assert isinstance(ttok.load_lm_tokenizer(tmp_path, 8), ttok.HFTokenizer)
    jb, tb = jtok.load_lm_tokenizer(None, 8), ttok.load_lm_tokenizer(None, 8)
    assert isinstance(tb, ttok.ByteTokenizer) and tb.vocab_size == jb.vocab_size
    for text in TEXTS:
        assert tb.encode(text) == jb.encode(text)
        ids = tb.encode(text) + [tb.EOS_ID, 40]
        assert tb.decode(ids) == jb.decode(ids) == text
