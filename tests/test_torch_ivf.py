"""IVFIndex and k-means: semcode_tpu_torch against semcode_tpu.

The JAX index is built on a 1-device mesh (so its one shard owns every
cluster, as the port's single device does) and its state is cross-loaded
into the port with ``ivf_from_jax_state``: the port re-adds the vectors
under the reference's centroids, so both hold the same cluster layout.
Required: identical assignments and ``cmax``; identical ids and scores
within rtol 1e-5 (f32 sums in another order) in modes ivf/exact/auto, for
ip/cosine/l2 and both probing routes (the kernel's plain version and the
gather-scan). Inputs are clustered Gaussian rows with no duplicates; where
two scores still lie within the tolerance of each other (l2 scores of
magnitude ~200 differ in the 7th digit), the pair may swap. The k-means++
init cannot reproduce ``jax.random`` bits; parity of the build comes from
``_lloyd`` with an injected init and reseed table.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semcode_tpu.index.flat import FlatIndex as JaxFlat
from semcode_tpu.index.ivf import IVFIndex as JaxIVF
from semcode_tpu.ops import kmeans as jk
from semcode_tpu.parallel.mesh import make_mesh
from semcode_tpu_torch.index.convert import ivf_from_jax_state, ivf_to_jax_state
from semcode_tpu_torch.index.flat import FlatIndex
from semcode_tpu_torch.index.ivf import IVFIndex
from semcode_tpu_torch.ops import kmeans as tk

D = 128


@pytest.fixture(scope="module")
def mesh1():
    return make_mesh((1,), ("data",), devices=jax.devices()[:1])


def _clustered(rng, n, d=D, n_centers=40, spread=0.15):
    centers = rng.standard_normal((n_centers, d)).astype(np.float32)
    assign = rng.integers(0, n_centers, size=n)
    return (centers[assign]
            + spread * rng.standard_normal((n, d))).astype(np.float32)


def _oracle(x, q, k):
    return np.argsort(-(q @ x.T), axis=1)[:, :k]


def _recall(ids, ref):
    k = ref.shape[1]
    return np.mean([len(set(a) & set(b)) / k
                    for a, b in zip(ids.tolist(), ref.tolist())])


def _same_ids(sa, ia, sb, ib, rtol=1e-5):
    """The port's k best (sb, ib) against the reference's k + 1 best (sa,
    ia). Ids identical at every position whose reference score stands apart
    from its neighbours by more than the score tolerance, the (k+1)-th
    included; at a near-tied position the port's id must be one the
    reference lists with a score within the tolerance of the port's score
    there. f32 sums run in another order, and in another on each machine, so
    a near-tied pair may swap inside the list or across the k cut."""
    k = ib.shape[1]
    gap = sa[:, :-1] - sa[:, 1:]
    near = gap <= rtol * np.abs(sa[:, 1:]) + 1e-5
    apart = np.ones(sa.shape, dtype=bool)
    apart[:, 1:] &= ~near
    apart[:, :-1] &= ~near
    apart = apart[:, :k]
    np.testing.assert_array_equal(ib[apart], ia[:, :k][apart])
    for r, j in zip(*np.nonzero(~apart)):
        listed = ia[r] == ib[r, j]
        assert listed.any(), f"row {r}: id {ib[r, j]} at {j} is not among the reference's"
        close = np.abs(sa[r][listed] - sb[r, j]) <= rtol * np.abs(sb[r, j]) + 1e-5
        assert close.any(), f"row {r}: id {ib[r, j]} at {j} scores apart from the reference's"
    for r in range(ib.shape[0]):  # no id twice (empty slots, -1, aside)
        got = ib[r][ib[r] >= 0]
        assert np.unique(got).size == got.size, f"row {r}: an id repeats"


def _same(a, b, q, k=10, rtol=1e-5, **kw):
    """``b`` (the port) searched at k against ``a`` (the reference) searched
    at k + 1: ids by ``_same_ids``, scores by the tolerance."""
    sa, ia = a.search(q, k=k + 1, **kw)
    sb, ib = b.search(q, k=k, **kw)
    _same_ids(sa, ia, sb, ib, rtol)
    np.testing.assert_allclose(sb, sa[:, :k], rtol=rtol, atol=1e-5)


def test_same_ids_lets_a_near_tie_swap_across_the_cut():
    """A near-tied pair that straddles the k cut may swap (the reference
    keeps 1973, the port 2337, scores 1e-5 apart at -200.5), as a pair
    inside the list may; untied positions must still agree."""
    sa = np.array([[-10.0, -50.0, -120.0, -150.0, -200.52817, -200.52818]])
    ia = np.array([[5, 7, 9, 11, 1973, 2337]])
    sb = np.array([[-10.0, -50.0, -120.0, -150.0, -200.52818]])
    ib = np.array([[5, 7, 9, 11, 2337]])
    _same_ids(sa, ia, sb, ib)
    inside = np.array([[5, 7, 11, 9, 1973]])  # -120 / -150 stand apart
    with pytest.raises(AssertionError):
        _same_ids(sa, ia, sb, inside)
    tied = sa.copy()
    tied[0, 3] = -120.0000001  # now a near-tied pair inside the list
    _same_ids(tied, ia, np.array([[-10.0, -50.0, -120.0, -120.0000001, -200.52817]]),
              inside)


def test_same_ids_rejects_a_real_mismatch():
    """An id the reference does not list, or lists with another score, is
    refused even at a near-tied position; so is an id listed twice."""
    sa = np.array([[-1.0, -2.0, -3.0, -3.0000001]])
    ia = np.array([[1, 2, 3, 4]])
    sb = np.array([[-1.0, -2.0, -3.0]])
    with pytest.raises(AssertionError):
        _same_ids(sa, ia, sb, np.array([[1, 2, 99]]))
    with pytest.raises(AssertionError):  # 1 is listed, but at -1.0
        _same_ids(sa, ia, sb, np.array([[1, 2, 1]]))
    with pytest.raises(AssertionError):
        _same_ids(sa, ia, sb, np.array([[2, 1, 3]]))  # an untied swap
    _same_ids(sa, ia, sb, np.array([[1, 2, 4]]))


def _cross_loaded(mesh1, x, tags=None, **kw):
    a = JaxIVF(D, mesh=mesh1, **kw)
    a.add(x, tags)
    opts = {k: v for k, v in kw.items() if k not in ("nlist", "nprobe", "metric")}
    b = ivf_from_jax_state(a.state_dict(), device="cpu", **opts)
    return a, b


@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float32"])
@pytest.mark.parametrize("metric", ["ip", "cosine", "l2"])
@pytest.mark.parametrize("use_pallas", ["always", "never"])
def test_cross_loaded_search_matches_jax(mesh1, dtype, metric, use_pallas):
    rng = np.random.default_rng(len(dtype) + len(metric))
    x = _clustered(rng, 3000)
    q = _clustered(rng, 16)
    a, b = _cross_loaded(mesh1, x, nlist=32, nprobe=8, metric=metric,
                         dtype=dtype, use_pallas=use_pallas)
    assert b.cmax == a.cmax
    np.testing.assert_array_equal(b._assign[: b._n_rows], a._assign[: a._n_rows])
    np.testing.assert_array_equal(b._loc[: b._n_rows], a._loc[: a._n_rows])
    mode = "plain" if use_pallas == "always" and metric != "l2" else "off"
    assert b._pallas_mode() == mode
    for m in ("ivf", "exact", "auto"):
        _same(a, b, q, mode=m)
    _same(a, b, q, k=5, nprobe=3, mode="ivf")


def test_port_state_loads_in_jax(mesh1):
    rng = np.random.default_rng(3)
    x = _clustered(rng, 2000)
    q = _clustered(rng, 8)
    a, b = _cross_loaded(mesh1, x, nlist=16, nprobe=4, dtype="int8")
    b.remove(np.arange(0, 2000, 9))
    state = ivf_to_jax_state(b)
    np.testing.assert_array_equal(state["rows"], np.flatnonzero(b._alive[:2000]))
    # both packages re-add the saved live rows under the saved centroids
    c = JaxIVF.from_state(state, mesh=mesh1, dtype="int8")
    d = ivf_from_jax_state(state, dtype="int8", device="cpu")
    assert c.cmax == d.cmax and c.size == d.size == b.size
    np.testing.assert_array_equal(d._loc[: d._n_rows], c._loc[: c._n_rows])
    for m in ("ivf", "exact"):
        _same(c, d, q, mode=m)
    with pytest.raises(ValueError, match="not an ivf-index state"):
        ivf_from_jax_state({"kind": "flat"})


def test_streaming_adds_remove_and_compact(mesh1):
    rng = np.random.default_rng(4)
    x = _clustered(rng, 2000)
    a, b = _cross_loaded(mesh1, x, nlist=16, nprobe=4, dtype="int8",
                         use_pallas="always")
    x2 = _clustered(rng, 300)
    q = np.concatenate([_clustered(rng, 6), x2[:2]])
    for idx in (a, b):
        idx.search(q[:1], k=1)  # materialize, then stream into the layout
        rows = idx.add(x2)
        assert rows[0] == 2000 and idx.size == 2300
        idx.remove(np.arange(0, 2300, 5))
    np.testing.assert_array_equal(b._loc[:2300], a._loc[:2300])
    for m in ("ivf", "exact"):
        _same(a, b, q, mode=m)
    np.testing.assert_array_equal(b.compact(), a.compact())
    assert b._n_rows == a._n_rows == b.size
    for m in ("ivf", "exact"):
        _same(a, b, q, mode=m)


def test_pending_tail_all_paths(mesh1):
    """Streamed rows past the memory threshold land in the pending tail and
    appear in exact, probing and batched searches; tombstoned pending rows
    vanish; a compaction folds them."""
    rng = np.random.default_rng(5)
    x = _clustered(rng, 2000)
    a, b = _cross_loaded(mesh1, x, nlist=16, nprobe=16, dtype="int8")
    extra = _clustered(rng, 64) + 3.0
    extra = (20.0 * extra / np.linalg.norm(extra, axis=1, keepdims=True)).astype(np.float32)
    q = extra[:4] + 0.001 * rng.standard_normal((4, D)).astype(np.float32)
    for idx in (a, b):
        idx.PENDING_THRESHOLD_BYTES = 0  # force the side-buffer route
        rows = idx.add(extra, tags=np.full(64, 7, dtype=np.int32))
        assert idx._pend is not None and idx._pend[3] == 64
        assert (idx._loc[rows, 0] == -1).all()
    for m in ("ivf", "exact"):
        _same(a, b, q, k=3, mode=m)
    _, ids = b.search(q, k=3, mode="ivf")
    assert (ids[:, 0] == rows[:4]).all()
    qs = np.stack([q, q[::-1].copy()])
    sa, ia = a.search_device_batched(jnp.asarray(qs), 3)
    sb, ib = b.search_device_batched(torch.from_numpy(qs), 3)
    np.testing.assert_array_equal(ib.numpy(), np.asarray(ia))
    _same(a, b, q, k=3, allow_tags=[7])
    for idx in (a, b):
        idx.remove(rows[:2])
    _same(a, b, q, k=3, mode="ivf")
    np.testing.assert_array_equal(b.compact(), a.compact())
    assert b._pend is None
    _same(a, b, q, k=3, mode="exact")


def test_allow_tags_force_exact(mesh1):
    rng = np.random.default_rng(6)
    x = _clustered(rng, 3000)
    tags = (np.arange(3000) % 4).astype(np.int32)
    a, b = _cross_loaded(mesh1, x, tags, nlist=32, nprobe=8, dtype="int8",
                         device_rescore=True)
    q = _clustered(rng, 16)
    _same(a, b, q, k=5, mode="ivf", allow_tags=[2])
    _, ids = b.search(q, k=5, mode="ivf", allow_tags=[2])
    assert (ids >= 0).all() and (tags[ids.ravel()] == 2).all()
    masked = np.where((tags == 2)[None, :], q @ x.T, -np.inf)
    np.testing.assert_array_equal(ids[:, 0], np.argmax(masked, axis=1))


@pytest.mark.parametrize("mode", ["exact", "probe"])
def test_search_device_batched(mesh1, mode):
    rng = np.random.default_rng(7)
    x = _clustered(rng, 2500)
    a, b = _cross_loaded(mesh1, x, nlist=32, nprobe=8, dtype="int8",
                         use_pallas="always")
    q = _clustered(rng, 8)
    qs = np.stack([q, q[::-1].copy()])
    sa, ia = a.search_device_batched(jnp.asarray(qs), 5, mode=mode)
    sb, ib = b.search_device_batched(torch.from_numpy(qs), 5, mode=mode)
    assert tuple(ib.shape) == (2, 8, 5)
    np.testing.assert_array_equal(ib.numpy(), np.asarray(ia))
    np.testing.assert_allclose(sb.numpy(), np.asarray(sa), rtol=1e-5, atol=1e-5)
    sa, ia = a.search_device(jnp.asarray(q), 5, mode="ivf", nprobe=4)
    sb, ib = b.search_device(torch.from_numpy(q), 5, mode="ivf", nprobe=4)
    np.testing.assert_array_equal(ib.numpy(), np.asarray(ia))
    with pytest.raises(ValueError, match="'exact' or 'probe'"):
        b.search_device_batched(torch.from_numpy(qs), 5, mode="auto")


@pytest.mark.parametrize("metric", ["ip", "l2"])
@pytest.mark.parametrize("rescore_mode", ["auto", "residual", "off"])
@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float32"])
def test_flat_and_ivf_exact_share_one_route(mesh1, dtype, rescore_mode, metric):
    """The flat index and the IVF index's exact mode run one exact route:
    over the same rows they return equal (scores, ids), and the route's
    rescore tier, widths and score dtype are each JAX index's."""
    rng = np.random.default_rng(9)
    x = _clustered(rng, 600)
    q = torch.from_numpy(_clustered(rng, 8))
    kw = dict(metric=metric, dtype=dtype, rescore_mode=rescore_mode)
    flat = FlatIndex(D, device="cpu", **kw)
    ivf = IVFIndex(D, nlist=8, device="cpu", **kw)
    flat.add(x)
    ivf.add(x)
    sf, idf = flat.search_device(q, 10)
    si, idi = ivf.search_device(q, 10, mode="exact")
    np.testing.assert_array_equal(idi.numpy(), idf.numpy())
    if metric == "l2":
        # the flat index sums the row norms on the host (numpy), the IVF
        # index on the device: l2 scores may differ in the last bit
        np.testing.assert_allclose(si.numpy(), sf.numpy(), rtol=1e-6)
    else:
        np.testing.assert_array_equal(si.numpy(), sf.numpy())
    jax_flat = JaxFlat(D, mesh=mesh1, **kw)
    jax_ivf = JaxIVF(D, mesh=mesh1, nlist=8, **kw)
    # at d 128: inside the f32 mirror's budget, past it, past the residual's
    for rows in (600, 12_000_000, 60_000_000):
        jax_flat.capacity = rows
        assert flat._route.rescore_kind(rows) == jax_flat._rescore_kind()
        assert ivf._route.rescore_kind(rows) == jax_ivf._rescore_kind(rows)
    # tier payloads: none, the f32 mirror, the (residual, scales) pair
    for payload in (None, object(), (None, None)):
        for k, shard_rows in ((1, 2048), (10, 2048), (40, 2048), (10, 100)):
            for idx, ref in ((flat, jax_flat), (ivf, jax_ivf)):
                fetch, w = idx._route.widths(k, shard_rows, payload)
                assert fetch == ref._fetch_width(k, shard_rows, payload)
                assert w == ref._rescore_width(k, payload)
                assert idx._route.select_dtype(payload) == ref._score_dtype(payload)


def test_pick_mode_regimes_match_reference(mesh1):
    def mk(cls, dim, **kw):
        idx = cls(dim, nlist=1024, nprobe=32, metric="ip", **kw)
        idx.cmax = 2176  # the 1M-row layout
        idx._mirror_cap = 1_000_000
        return idx

    for dim in (384, 3072):
        a, b = mk(JaxIVF, dim, mesh=mesh1), mk(IVFIndex, dim, device="cpu")
        for n_q, nprobe in ((8, 8), (8, 16), (8, 32), (256, 32), (512, 32),
                            (8, 1024)):
            assert b._pick_mode(n_q, nprobe, 10) == a._pick_mode(n_q, nprobe, 10)
    wide = mk(IVFIndex, 3072, device="cpu")
    assert wide._pick_mode(8, 16, 10) == "ivf"
    assert mk(IVFIndex, 384, device="cpu")._pick_mode(8, 8, 10) == "ivf"
    assert wide._pick_mode(256, 32, 10) == "exact"


def test_lloyd_matches_jax_with_injected_init():
    rng = np.random.default_rng(8)
    x = _clustered(rng, 1200, d=32, n_centers=12, spread=0.2)
    init = x[rng.choice(1200, 16, replace=False)]
    reseed = rng.integers(0, 1200, size=(6, 16)).astype(np.int32)
    ja = np.asarray(jk._lloyd(jnp.asarray(x), jnp.asarray(init), 6,
                              jnp.asarray(reseed)))
    tb = tk._lloyd(torch.from_numpy(x), torch.from_numpy(init), 6,
                   torch.from_numpy(reseed)).numpy()
    np.testing.assert_allclose(tb, ja, rtol=1e-4, atol=1e-4)
    # assignment and top-m candidates of the same centroids agree exactly
    np.testing.assert_array_equal(
        tk.assign_clusters(x, ja, device="cpu"), jk.assign_clusters(x, ja))
    np.testing.assert_array_equal(
        tk.topm_clusters(x, ja, m=4, device="cpu"), jk.topm_clusters(x, ja, m=4))


def test_balanced_assign_is_the_reference():
    rng = np.random.default_rng(9)
    n, k = 2000, 16
    cands = rng.integers(0, k, size=(n, 8)).astype(np.int32)
    cands[:600, 0] = 0  # a hot cluster
    for cap, counts in ((150, None), (130, rng.integers(0, 40, k))):
        np.testing.assert_array_equal(
            tk.balanced_assign(cands, k, cap, counts),
            jk.balanced_assign(cands, k, cap, counts))


def test_kmeans_init_is_seeded_and_separates_clusters():
    rng = np.random.default_rng(10)
    centers = rng.standard_normal((4, 16)).astype(np.float32) * 10
    x = np.concatenate([c + 0.1 * rng.standard_normal((50, 16)).astype(np.float32)
                        for c in centers])
    c1, a1 = tk.kmeans_fit(x, 4, iters=8, seed=0, device="cpu")
    c2, _ = tk.kmeans_fit(x, 4, iters=8, seed=0, device="cpu")
    np.testing.assert_array_equal(c1, c2)
    assert float(np.linalg.norm(x - c1[a1], axis=1).mean()) < 2.0
    gen = torch.Generator(device="cpu").manual_seed(0)
    c3 = tk.kmeans_fit_dev(torch.from_numpy(x), 4, iters=8, seed=0, generator=gen)
    np.testing.assert_array_equal(c3, c1)
    few, assign = tk.kmeans_fit(x[:3], 16, seed=0, device="cpu")
    assert few.shape == (16, 16) and assign.shape == (3,)


def test_port_built_index_recall():
    rng = np.random.default_rng(11)
    x = _clustered(rng, 5000)
    q = _clustered(rng, 32)
    ref = _oracle(x, q, 10)
    idx = IVFIndex(D, nlist=64, nprobe=16, dtype="float32", device="cpu")
    idx.add(x)
    _, ids = idx.search(q, k=10, mode="ivf")
    assert _recall(ids, ref) >= 0.95
    _, ids = idx.search(q, k=10, mode="exact")
    assert _recall(ids, ref) == 1.0
    _, ids = idx.search(q, k=10, nprobe=64)  # full probe -> exact
    assert _recall(ids, ref) == 1.0
    q8 = _clustered(rng, 16)
    for mode in ("ivf", "exact"):
        i8 = IVFIndex(D, nlist=32, nprobe=16, dtype="int8", device="cpu",
                      use_pallas="always")
        i8.add(x[:3000])
        _, ids = i8.search(q8, k=10, mode=mode)
        assert _recall(ids, _oracle(x[:3000], q8, 10)) >= 0.9


def test_bulk_build_state_roundtrip_and_retrain():
    rng = np.random.default_rng(12)
    n = 3000
    x = _clustered(rng, n)
    q = _clustered(rng, 16)
    one = IVFIndex(D, nlist=32, nprobe=8, dtype="int8", device="cpu")
    one.add(x)
    idx = IVFIndex(D, nlist=32, nprobe=8, dtype="int8", device="cpu")
    with idx.bulk(expected_rows=n):
        for lo in range(0, n, 700):
            idx.add(torch.from_numpy(x[lo:lo + 700]))  # device-tensor chunks
        assert idx._dirty and idx.cmax == 0
        with pytest.raises(RuntimeError, match="nest"):
            with idx.bulk():
                pass
    assert idx._mir.fvecs.shape[0] == round(n / 128 + 0.5) * 128
    assert idx.size == n and not idx._dirty
    s1, i1 = one.search(q, k=10, mode="exact")
    s2, i2 = idx.search(q, k=10, mode="exact")
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(idx._host, x, rtol=1e-6)
    again = IVFIndex.from_state(idx.state_dict(), dtype="int8", device="cpu")
    for m in ("ivf", "exact"):
        _same(idx, again, q, mode=m)
    drifted = 5 + rng.standard_normal((500, D)).astype(np.float32)
    idx.add(drifted)
    idx.retrain()
    _, ids = idx.search(drifted[:4], k=5, nprobe=32)
    assert _recall(ids, _oracle(idx._host, drifted[:4], 5)) == 1.0


def test_empty_and_bulk_search_guard():
    idx = IVFIndex(16, nlist=16, dtype="float32", device="cpu")
    s, ids = idx.search(np.ones((2, 16), np.float32), k=5)
    assert (ids == -1).all() and (s <= -1e38).all()
    with idx.bulk() as b:
        b.add(np.random.default_rng(0).standard_normal((300, 16)).astype(np.float32))
        with pytest.raises(RuntimeError, match="bulk"):
            idx.search(np.ones((2, 16), np.float32), k=3, mode="exact")
    assert idx.search(np.ones((2, 16), np.float32), k=3)[1].min() >= 0
