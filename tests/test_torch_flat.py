"""FlatIndex and the exact scan: semcode_tpu_torch against semcode_tpu.

The same numpy rows and queries go through the JAX FlatIndex on a 1-device
mesh (so its per-shard fetch equals the port's) and the port's FlatIndex on
the CPU. Rows are unit-norm, as the store's embeddings are. Required:
identical ids and scores within 1e-5 (f32 dot products summed in another
order). The kernel route is compared only with JAX's kernel route (Pallas
interpret): at a few hundred rows its top-2-per-block pool holds fewer than
k candidates, so it differs from the full-matrix route by design.
"""

import jax
import numpy as np
import pytest
import torch

from semcode_tpu.index.flat import FlatIndex as JaxFlat
from semcode_tpu.index.ivf import IVFIndex as JaxIVF
from semcode_tpu.parallel.mesh import make_mesh
from semcode_tpu_torch.index.convert import flat_from_jax_state, flat_to_jax_state
from semcode_tpu_torch.index.flat import FlatIndex, quantize_rows, quantize_rows_device
from semcode_tpu_torch.index.ivf import IVFIndex
from semcode_tpu_torch.index.scan import stable_topk

DIM = 128


@pytest.fixture(scope="module")
def mesh1():
    return make_mesh((1,), ("data",), devices=jax.devices()[:1])


def _data(seed, n=300, nq=6):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, DIM)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    x[50:60] = x[40:50]  # exact duplicates: ties break to the lowest row
    tags = rng.integers(0, 3, n).astype(np.int32)
    q = rng.standard_normal((nq, DIM)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q[0] = x[45]
    return x, tags, q


def _pair(mesh1, kind="flat", **kw):
    if kind == "ivf":  # searched with mode="exact": the flat mirror's scan
        return (JaxIVF(DIM, mesh=mesh1, nlist=8, **kw),
                IVFIndex(DIM, nlist=8, device="cpu", **kw))
    return JaxFlat(DIM, mesh=mesh1, **kw), FlatIndex(DIM, device="cpu", **kw)


def _same(a, b, q, k=10, allow=None, **kw):
    sa, ia = a.search(q, k, allow_tags=allow, **kw)
    sb, ib = b.search(q, k, allow_tags=allow, **kw)
    np.testing.assert_array_equal(ib, ia)
    np.testing.assert_allclose(sb, sa, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float32"])
@pytest.mark.parametrize("metric", ["ip", "l2", "cosine"])
@pytest.mark.parametrize("scan_impl", ["xla", "pallas"])
@pytest.mark.parametrize("rescore_mode", ["auto", "residual"])
def test_search_matches_jax(mesh1, dtype, metric, scan_impl, rescore_mode):
    x, tags, q = _data(seed=len(dtype) + len(metric))
    a, b = _pair(mesh1, metric=metric, dtype=dtype, scan_impl=scan_impl,
                 rescore_mode=rescore_mode)
    a.add(x, tags)
    b.add(x, tags)
    assert a._rescore_kind() == b._route.rescore_kind(b.capacity)
    a.remove(np.arange(0, 300, 7))
    b.remove(np.arange(0, 300, 7))
    _same(a, b, q)
    _same(a, b, q, allow=[1, 2])


@pytest.mark.parametrize("kind", ["flat", "ivf"])
@pytest.mark.parametrize("scan_impl", ["xla", "pallas"])
@pytest.mark.parametrize("rescore_width,fetch_width", [(-1, 0), (12, 0), (0, 64)])
def test_rescore_width_and_fetch_width(mesh1, kind, scan_impl, rescore_width,
                                       fetch_width):
    x, tags, q = _data(seed=11, n=600)
    a, b = _pair(mesh1, kind, dtype="int8", scan_impl=scan_impl,
                 rescore_width=rescore_width, fetch_width=fetch_width)
    a.add(x, tags)
    b.add(x, tags)
    _same(a, b, q, k=8, **({"mode": "exact"} if kind == "ivf" else {}))


@pytest.mark.parametrize("scan_impl", ["xla", "pallas"])
def test_update_delete_compact(mesh1, scan_impl):
    x, tags, q = _data(seed=12)
    a, b = _pair(mesh1, dtype="int8", scan_impl=scan_impl)
    for idx in (a, b):
        idx.add(x[:200], tags[:200])
        idx.update_rows(np.arange(10, 20), x[200:210], tags[200:210])
        idx.add(x[200:], tags[200:])
        idx.remove(np.arange(0, 300, 3))
    _same(a, b, q)
    ra = a.compact()
    rb = b.compact()
    np.testing.assert_array_equal(rb, ra)
    _same(a, b, q)
    na, _ = a.compacted()
    nb, _ = b.compacted()
    _same(na, nb, q)


def test_float16_score_matrix(mesh1):
    x, tags, q = _data(seed=13)
    a, b = _pair(mesh1, dtype="int8", scan_impl="xla", score_dtype="float16")
    a.add(x, tags)
    b.add(x, tags)
    _same(a, b, q)


def test_search_device_and_batched(mesh1):
    x, tags, q = _data(seed=14, nq=8)
    a, b = _pair(mesh1, dtype="int8", scan_impl="pallas")
    a.add(x, tags)
    b.add(x, tags)
    sa, ia = a.search_device(jax.numpy.asarray(q), 5)
    sb, ib = b.search_device(torch.from_numpy(q), 5)
    np.testing.assert_array_equal(ib.numpy(), np.asarray(ia))
    np.testing.assert_allclose(sb.numpy(), np.asarray(sa), atol=1e-5)
    qs = np.stack([q, q[::-1].copy()])
    sa, ia = a.search_device_batched(jax.numpy.asarray(qs), 5)
    sb, ib = b.search_device_batched(torch.from_numpy(qs), 5)
    assert ib.shape == (2, 8, 5)
    np.testing.assert_array_equal(ib.numpy(), np.asarray(ia))


def test_state_dict_round_trip_between_packages(mesh1):
    x, tags, q = _data(seed=15)
    a = JaxFlat(DIM, mesh=mesh1, dtype="int8")
    a.add(x, tags)
    a.remove(np.arange(5))
    b = flat_from_jax_state(a.state_dict(), dtype="int8", device="cpu")
    _same(a, b, q)
    c = JaxFlat.from_state(flat_to_jax_state(b), mesh=mesh1, dtype="int8")
    _same(c, b, q)
    with pytest.raises(ValueError, match="not a flat-index state"):
        flat_from_jax_state({"kind": "ivf"})


def test_quantization_matches_host_and_reference():
    from semcode_tpu.index.flat import quantize_rows as jax_quantize_rows

    x, _, _ = _data(seed=16)
    qa, sa = jax_quantize_rows(x)
    qb, sb = quantize_rows(x)
    qd, sd = quantize_rows_device(torch.from_numpy(x))
    np.testing.assert_array_equal(qb, qa)
    np.testing.assert_array_equal(sb, sa)
    np.testing.assert_array_equal(qd.numpy(), qa)
    np.testing.assert_array_equal(sd.numpy(), sa)


def test_stable_topk_breaks_ties_by_lowest_index():
    x = torch.tensor([[1.0, 3.0, 3.0, -0.0, 0.0, 3.0, -3e38, 2.0]])
    s, i = stable_topk(x, 6)
    assert i.tolist() == [[1, 2, 5, 7, 0, 4]]
    assert s.tolist() == [[3.0, 3.0, 3.0, 2.0, 1.0, 0.0]]
    jv, ji = jax.lax.top_k(jax.numpy.asarray(x.numpy()), 6)
    assert np.asarray(ji).tolist() == i.tolist()


def test_default_device_without_cuda_raises(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    monkeypatch.delenv("SEMCODE_TORCH_DEVICE", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FlatIndex(DIM)
