"""Hash embedder: semcode_tpu_torch against semcode_tpu.

The projection matrix must be BIT-EQUAL to JAX's (so both packages share
one embedding signature), the 128-value table behind it must be what JAX's
bf16 normal sampler produces, featurization must be identical (Python and
native paths), and embeddings must agree within 1e-6 (f32 sums over the
256 features run in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semcode_tpu.embeddings.hash_embedder import HashEmbeddings as JaxHash
from semcode_tpu_torch.embeddings import hash_embedder as th
from semcode_tpu_torch.embeddings.hash_embedder import HashEmbeddings

TEXTS = [
    "def quantize_rows(x):\n    scale = np.abs(x).max(axis=-1) / 127.0",
    "class VectorStore:\n    \"\"\"In-process store with upsert/search.\"\"\"",
    "where is quantize_rows defined",
    "uñicode ïdentifiers — and émojis 🎉 stay on the Python path",
    "",
    "x" * 5000,
    "fooBar baz_qux HTTPServer parseURLString 42 + 7",
]


@pytest.fixture(scope="module")
def jax_384():
    return JaxHash(384)


@pytest.fixture(scope="module")
def torch_384():
    return HashEmbeddings(384, device="cpu")


def test_projection_bit_equal_at_384(jax_384, torch_384):
    ref = np.asarray(jax_384._proj, dtype=np.float32)
    got = torch_384.projection()
    assert got.dtype == np.float32 and got.shape == ref.shape == (65536, 384)
    assert np.array_equal(got, ref)
    assert torch_384.signature == jax_384.signature


def test_normal_table_is_jax_bf16_sampler():
    """Regenerate the 128-entry table from JAX: every bf16 normal that
    jax.random.normal can emit, keyed by its 7-bit uniform index."""
    n = 1 << 16
    ref = np.asarray(
        jax.random.normal(jax.random.PRNGKey(3), (n,), dtype=jnp.bfloat16)
    ).astype(np.float32)
    got = th.jax_normal_bf16(3, (n,), torch.device("cpu")).numpy()
    assert np.array_equal(got, ref)
    assert sorted(set(ref.tolist())) == sorted(th._NORMAL_BF16)
    assert len(th._NORMAL_BF16) == 128


@pytest.mark.parametrize("seed,shape", [(0, (7, 5)), (123, (300,)), (2**33 + 5, (4, 4)), (-3, (9,))])
def test_threefry_bits_follow_jax_keys(seed, shape):
    ref = np.asarray(
        jax.random.normal(jax.random.PRNGKey(seed), shape, dtype=jnp.bfloat16)
    ).astype(np.float32)
    got = th.jax_normal_bf16(seed, shape, torch.device("cpu")).numpy()
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("use_native", [True, False])
def test_featurization_identical(jax_384, use_native):
    a = JaxHash.__new__(JaxHash)
    a.__dict__.update({k: v for k, v in jax_384.__dict__.items() if k != "_proj"})
    a.use_native = use_native
    b = HashEmbeddings.from_numpy_projection(
        np.zeros((65536, 8), np.float32), device="cpu", use_native=use_native
    )
    ia, wa = a._featurize_chunk(TEXTS, len(TEXTS))
    ib, wb = b._featurize_chunk(TEXTS, len(TEXTS))
    np.testing.assert_array_equal(ib, ia)
    np.testing.assert_array_equal(wb, wa)


def test_embeddings_agree(jax_384, torch_384):
    ea = np.asarray(jax_384.embed_documents(TEXTS))
    eb = np.asarray(torch_384.embed_documents(TEXTS))
    np.testing.assert_allclose(eb, ea, rtol=0, atol=1e-6)
    assert np.all(eb[4] == 0.0)  # empty text: zero vector, as the reference
    qa = np.asarray(jax_384.embed_queries_device(TEXTS[:3]))
    qb = torch_384.embed_queries_device(TEXTS[:3]).numpy()
    assert qb.shape == qa.shape == (8, 384)
    np.testing.assert_allclose(qb, qa, rtol=0, atol=1e-6)


def test_from_numpy_projection_small_dim():
    rng = np.random.default_rng(0)
    proj = rng.standard_normal((1024, 16)).astype(np.float32)
    a = JaxHash(16, n_buckets=1024)
    a._proj = jnp.asarray(proj)
    b = HashEmbeddings.from_numpy_projection(proj, device="cpu")
    np.testing.assert_allclose(
        np.asarray(b.embed_documents(TEXTS)), np.asarray(a.embed_documents(TEXTS)),
        rtol=0, atol=1e-6,
    )
    with pytest.raises(TypeError, match="unexpected"):
        HashEmbeddings.from_numpy_projection(proj, device="cpu", bogus=1)
