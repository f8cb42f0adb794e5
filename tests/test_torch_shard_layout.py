"""Each shard's rows in tensors of their own: the port's per-shard layout.

An index's row-indexed device tensors are ``ShardedRows``
(``semcode_tpu_torch/parallel/mesh.py``): shard ``r``'s rows, or its
clusters, in a tensor of its own on shard ``r``'s device, as the JAX
package's arrays under ``NamedSharding(mesh, P(row_axes, ...))`` put each
shard on its device. These tests walk every tensor a flat index, an IVF
index, a lexical table or a store holds, after each kind of write (add with
growth, update, remove, the IVF pending tail, compaction, the store's
promotion to IVF), and require

- every tensor to sit in a ``ShardedRows`` holding one tensor per local
  shard, on that shard's device, of ``shard_rows`` rows: nothing of the
  global row count remains, apart from what the JAX package replicates too
  (IVF's centroids and its pending tail);
- each shard's tensor to equal that shard's rows of the same index built on
  ONE shard, bit for bit: it holds exactly its own rows or clusters;
- the answers to equal the JAX package's at the same shard count (ids equal
  wherever neighbouring scores stand more than 1e-5 apart, scores within
  rtol 1e-5).

Meshes: 8 shards, ``(2, 4)`` over ``("dcn", "data")``, and 8 shards whose
entries alternate between ``cpu`` and ``cpu:0``: two names of the one CPU,
which the mesh code tells apart and the tensors do not, so that mesh shows
no more of placement than the first.

Placement is checked on a mesh whose odd shards lie on the ``meta`` device,
where a tensor shows the device it was made for: the container's
constructors and writes, and the flat index and the lexical table through
their adds, updates, removals and compaction, must leave every shard's
tensor on that shard's device. The IVF index and the store make their shard
tensors through the same container operations, but their builds read
values across shards, which a meta tensor does not hold, so their placement
is checked only through those operations.
"""

import jax
import numpy as np
import pytest
import torch

from semcode_tpu.embeddings.providers import EmbeddingPayload as JaxPayload
from semcode_tpu.index import lexical as jl
from semcode_tpu.index.flat import FlatIndex as JaxFlat
from semcode_tpu.index.ivf import IVFIndex as JaxIVF
from semcode_tpu.index.store import VectorStore as JaxStore
from semcode_tpu.parallel.mesh import make_mesh as jax_mesh
from semcode_tpu.settings import AppSettings as JaxSettings
from semcode_tpu_torch.embeddings.providers import EmbeddingPayload
from semcode_tpu_torch.index import lexical as tl
from semcode_tpu_torch.index.flat import FlatIndex, quantize_rows_device
from semcode_tpu_torch.index.ivf import IVFIndex
from semcode_tpu_torch.index.store import VectorStore
from semcode_tpu_torch.parallel.mesh import ShardedRows, local_shards, make_mesh
from semcode_tpu_torch.settings import AppSettings

MESHES = {
    "8": ((8,), ("data",), ["cpu"] * 8),
    "2x4": ((2, 4), ("dcn", "data"), ["cpu"] * 8),
    "split": ((8,), ("data",), ["cpu", "cpu:0"] * 4),
}
# what the JAX package replicates on every device, as the port does on its
# first local device
REPLICATED = {"centroids", "_pend"}
CASES = ["flat-int8-f32", "flat-int8-residual", "flat-bf16", "flat-f32",
         "ivf-int8-pending", "lexical", "store"]


@pytest.fixture(scope="module")
def meshes():
    out = {}
    for name, (shape, axes, devices) in MESHES.items():
        out[name] = (jax_mesh(shape, axes), make_mesh(shape, axes, devices=devices))
    out["1"] = (jax_mesh((1,), ("data",), devices=jax.devices()[:1]),
                make_mesh((1,), ("data",), devices=["cpu"]))
    return out


def _walk(obj, path, found):
    """Every tensor and ShardedRows reachable from an index's state."""
    if isinstance(obj, (ShardedRows, torch.Tensor)):
        found[path] = obj
    elif isinstance(obj, (tuple, list)):
        names = getattr(obj, "_fields", None)
        for i, v in enumerate(obj):
            _walk(v, f"{path}.{names[i] if names else i}", found)
    elif isinstance(obj, dict):
        for k, v in obj.items():
            _walk(v, f"{path}[{k}]", found)
    elif isinstance(obj, (FlatIndex, IVFIndex, tl.LexicalFingerprints)):
        for k, v in vars(obj).items():
            _walk(v, f"{path}.{k}", found)
    return found


def check_layout(obj, mesh, one=None):
    """``obj``'s tensors are split by shard (see the module docstring);
    with ``one``, the same index on one shard, each shard holds exactly
    its own rows of ``one``'s."""
    found = _walk(obj, "", {})
    shards = local_shards(mesh)
    split = {p: c for p, c in found.items() if isinstance(c, ShardedRows)}
    assert split, "the index holds no per-shard tensors"
    for path, t in found.items():
        if isinstance(t, torch.Tensor):
            assert REPLICATED & set(path.split(".")), (
                f"{path} {tuple(t.shape)} is a tensor outside the shards")
    for path, c in split.items():
        assert c.mesh is mesh and list(c.parts) == [r for r, _ in shards], path
        assert c.rows == c.shard_rows * len(shards), path
        for r, dev in shards:
            part = c.shard(r)
            assert part.device.type == dev.type, path
            assert part.shape[0] == c.shard_rows and part.is_contiguous(), path
    if one is not None:
        whole = _walk(one, "", {})
        assert set(whole) == set(found), set(whole) ^ set(found)
        for path, c in split.items():
            full = whole[path].shard(0)
            assert full.shape[0] == c.rows, path
            s = c.shard_rows
            for r, part in c.parts.items():
                assert torch.equal(part, full[r * s:(r + 1) * s]), (path, r)
    return split


def gathered(c: ShardedRows) -> np.ndarray:
    """The whole of ``c`` in global row order, on the host."""
    return c.take(np.arange(c.rows)).numpy()


def _same(js, ji, ts, ti, tol=1e-5):
    np.testing.assert_allclose(ts, js, rtol=tol, atol=tol)
    gap = np.abs(np.diff(js, axis=1)) > tol
    apart = np.ones(js.shape, dtype=bool)
    apart[:, 1:] &= gap
    apart[:, :-1] &= gap
    np.testing.assert_array_equal(ti[apart], ji[apart])


def _rows(seed, n, d=128):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    x[100:120] = x[300:320]  # exact duplicates on both sides of a shard edge
    tags = rng.integers(0, 3, n).astype(np.int32)
    q = x[rng.choice(n, 12, replace=False)] + 0.05 * rng.standard_normal(
        (12, d)).astype(np.float32)
    return x, tags, q


FLAT = {
    "flat-int8-f32": dict(dtype="int8", rescore_mode="f32", scan_impl="pallas"),
    "flat-int8-residual": dict(dtype="int8", rescore_mode="residual"),
    "flat-bf16": dict(dtype="bfloat16", scan_impl="pallas"),
    "flat-f32": dict(dtype="float32"),
}


def _flat_case(meshes, mesh, kw):
    x, tags, q = _rows(3, 900)
    jm, tm = meshes[mesh]
    j, t, one = (JaxFlat(128, mesh=jm, **kw), FlatIndex(128, mesh=tm, **kw),
                 FlatIndex(128, mesh=meshes["1"][1], **kw))
    for step in range(4):
        for idx in (j, t, one):
            if step == 0:
                idx.add(x[:300], tags[:300])
            elif step == 1:
                idx.add(x[300:], tags[300:])  # grows: the shard ranges move
            elif step == 2:
                idx.update_rows(np.arange(10, 30), x[600:620], tags[600:620])
            else:
                idx.remove(np.arange(0, 900, 7))
        check_layout(t, tm, one)
        _same(*j.search(q, 10), *t.search(q, 10))
    _same(*j.search(q, 10, allow_tags=[1]), *t.search(q, 10, allow_tags=[1]))
    for idx in (j, t, one):
        idx.compact()
    check_layout(t, tm, one)
    _same(*j.search(q, 10), *t.search(q, 10))


def _ivf_case(meshes, mesh):
    x, tags, q = _rows(21, 1600)
    jm, tm = meshes[mesh]
    kw = dict(dtype="int8", use_pallas="always")
    j0 = JaxIVF(128, nlist=16, nprobe=4, mesh=jm, **kw)
    j0.add(x[:1200], tags[:1200])
    state = j0.state_dict()  # one trained layout for every index
    j = JaxIVF.from_state(state, mesh=jm, **kw)
    t = IVFIndex.from_state(state, mesh=tm, **kw)
    one = IVFIndex.from_state(state, mesh=meshes["1"][1], **kw)
    check_layout(t, tm, one)
    for idx in (j, t, one):
        idx.PENDING_THRESHOLD_BYTES = 0  # streaming adds land in the tail
        idx.add(x[1200:], tags[1200:])
        assert idx._pend is not None
        idx.remove(np.array([1250, 5, 1300, 700]))
    check_layout(t, tm, one)
    for mode in ("ivf", "exact"):
        _same(*j.search(q, 10, mode=mode), *t.search(q, 10, mode=mode))
    got, want = t.state_dict(), one.state_dict()
    for key in ("vectors", "assignments", "rows", "tags", "centroids"):
        np.testing.assert_array_equal(got[key], want[key])
    for idx in (j, t, one):
        idx.compact()  # folds the tail, then re-packs every live row
    check_layout(t, tm, one)
    _same(*j.search(q, 10, mode="ivf"), *t.search(q, 10, mode="ivf"))


DOCS = [
    {"text": "def load_config(path):\n    return json.loads(open(path).read())",
     "symbol": "load_config", "path": "cfg.py"},
    {"text": "class MeshRouter:\n    def route(self, shard): return shard % 8",
     "symbol": "MeshRouter", "path": "mesh.py"},
    {"text": "async def fetch_rows(ids):\n    return [await get(i) for i in ids]",
     "symbol": "fetch_rows", "path": "rows.py"},
    {"text": "# gather fingerprints by global row id\nx = 1", "symbol": None,
     "path": "notes.py"},
]


def _lexical_case(meshes, mesh):
    jm, tm = meshes[mesh]
    metas = DOCS * 60
    rows = np.arange(len(metas))
    ja = jl.LexicalFingerprints(jm, 128, kterms=16)
    ta = tl.LexicalFingerprints(128, kterms=16, mesh=tm)
    one = tl.LexicalFingerprints(128, kterms=16, mesh=meshes["1"][1])
    for fp in (ja, ta, one):
        fp.set_rows(rows[:100], metas[:100])
        fp.device_arrays(0)
        fp.set_rows(rows[100:], metas[100:])  # grows: the mirror is dropped
        fp.device_arrays(0)
        fp.set_rows(np.array([3, 130]), metas[5:7])  # the mirror in lockstep
    check_layout(ta, tm, one)
    remap = np.where(rows % 5 == 0, -1, rows)
    for fp in (ja, ta, one):
        fp.remap(remap)
        fp.device_arrays(len(metas))
    check_layout(ta, tm, one)
    rng = np.random.default_rng(4)
    texts = ["where is load_config defined", "mesh router shard",
             "fetch rows by id", None]
    ids = np.stack([rng.permutation(len(metas))[:16] for _ in texts])
    ids[0, -3:] = -1
    scores = np.where(ids >= 0, rng.random(ids.shape), jl._NEG_INF).astype(np.float32)
    q_ids, q_sym = jl.featurize_queries(texts), jl.featurize_query_symbols(texts)
    js, ji = jl.rerank_device(jm, ja.device_arrays(0), scores, ids, q_ids,
                              q_sym=q_sym, weight=0.8, sym_bonus=1.0)
    ts, ti = tl.rerank_device(ta.device_arrays(0), scores, ids, q_ids,
                              q_sym=q_sym, weight=0.8, sym_bonus=1.0, mesh=tm)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def _store_case(tmp_path, meshes, mesh):
    jm, tm = meshes[mesh]
    kw = dict(embedding_dimension=128, index_kind="auto", index_ivf_min_size=200,
              index_nlist=8, index_nprobe=3, index_auto_compact_ratio=0.0,
              rag_query_cache_size=0)
    rng = np.random.default_rng(2)
    vecs = rng.standard_normal((300, 128)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    stores = [JaxStore(JaxSettings(workspace_root=tmp_path / "j", **kw), mesh=jm),
              VectorStore(AppSettings(workspace_root=tmp_path / "t", **kw), mesh=tm),
              VectorStore(AppSettings(workspace_root=tmp_path / "o", **kw),
                          mesh=meshes["1"][1])]

    def payloads(cls, lo, hi):
        return [cls(id=f"c{i}", text=f"def sym_{i}(): return {i}", vector=vecs[i],
                    metadata={"repo": f"r{i % 2}", "path": f"m{i}.py",
                              "symbol": f"sym_{i}", "language": "python"})
                for i in range(lo, hi)]

    def check():
        texts = ["sym_7", None, "where is sym_150 defined", "return 9", None, None]
        for filters in (None, {"repo": "r1"}):
            hj, ht, _ = (s.search_batch(vecs[1:7], top_k=6, filters=filters,
                                        query_texts=texts) for s in stores)
            assert ([[h.id for h in hs] for hs in ht]
                    == [[h.id for h in hs] for hs in hj])
        t, one = stores[1], stores[2]
        check_layout(t._index, tm, one._index)
        check_layout(t._lex, tm, one._lex)  # built by the searches' rerank

    for lo, hi in ((0, 150), (150, 300)):  # the second upsert promotes to IVF
        for cls, store in zip((JaxPayload, EmbeddingPayload, EmbeddingPayload),
                              stores):
            store.upsert_embeddings(payloads(cls, lo, hi))
        check()
    assert [s._index.kind for s in stores] == ["ivf"] * 3
    for store in stores:
        store.delete([f"c{i}" for i in range(0, 300, 6)])
    check()
    assert [s.compact() for s in stores] == [50] * 3
    check()


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_every_index_tensor_is_split_by_shard(tmp_path, meshes, mesh, case):
    if case in FLAT:
        _flat_case(meshes, mesh, FLAT[case])
    elif case == "ivf-int8-pending":
        _ivf_case(meshes, mesh)
    elif case == "lexical":
        _lexical_case(meshes, mesh)
    else:
        _store_case(tmp_path, meshes, mesh)


def test_sharded_rows_writes_gathers_and_growth():
    """The container alone: writes go to the owner shards (out of place
    unless asked), ``take`` gathers across shards in the asked order, and
    ``grow`` moves rows across the shifted shard boundaries."""
    mesh = make_mesh((4,), ("data",), devices=["cpu", "cpu:0"] * 2)
    host = np.arange(64 * 3, dtype=np.float32).reshape(64, 3)
    c = ShardedRows.from_host(mesh, host)
    assert c.shape == (64, 3) and c.shard_rows == 16
    assert [p.shape[0] for p in c.parts.values()] == [16] * 4
    rows = np.array([63, 0, 17, 40])
    np.testing.assert_array_equal(c.take(rows).numpy(), host[rows])
    assert c.take(rows).device == mesh.home
    d = c.set_rows(np.array([1, 50]), torch.full((2, 3), -1.0))
    assert d.shard(1) is c.shard(1) and d.shard(0) is not c.shard(0)
    np.testing.assert_array_equal(gathered(c), host)  # the old version stands
    want = host.copy()
    want[[1, 50]] = -1.0
    np.testing.assert_array_equal(gathered(d), want)
    g = d.grow(128)
    assert g.shard_rows == 32
    want = np.concatenate([want, np.zeros((64, 3), np.float32)])
    np.testing.assert_array_equal(gathered(g), want)
    np.testing.assert_array_equal(g.shard(1).numpy(), want[32:64])
    ids = ShardedRows.full(mesh, 8, (4,), torch.int32, -1)
    ids = ids.fill_rows(np.array([2, 7]), 5, cols=np.array([1, 3]))
    want = np.full((8, 4), -1, np.int32)
    want[2, 1] = want[7, 3] = 5
    np.testing.assert_array_equal(gathered(ids), want)
    with pytest.raises(ValueError, match="split"):
        ShardedRows.from_host(mesh, host[:10])


# odd shards on the meta device: a shard's tensor shows the device it was
# made for
PLACED = ["cpu", "meta"] * 2


def check_placed(obj, mesh):
    """Every shard tensor ``obj`` holds lies on its own shard's device."""
    found = _walk(obj, "", {})
    split = {p: c for p, c in found.items() if isinstance(c, ShardedRows)}
    assert split, "no per-shard tensors"
    for path, c in split.items():
        for r, dev in local_shards(mesh):
            assert c.shard(r).device == dev, (path, r, c.shard(r).device)


def _host(m):
    return ShardedRows.from_host(m, np.ones((64, 3), np.float32))


CONTAINER_OPS = {
    "from_host": _host,
    "full": lambda m: ShardedRows.full(m, 64, (3,), torch.int32, -1),
    "of": lambda m: ShardedRows.of(m, torch.ones(64, 3)),
    "set_rows": lambda m: _host(m).set_rows(np.array([1, 20, 50]),
                                            torch.zeros(3, 3)),
    "set_rows-inplace": lambda m: _host(m).set_rows(
        np.array([40, 2]), torch.zeros(2, 3), inplace=True),
    "fill_rows-cols": lambda m: ShardedRows.full(m, 8, (4,), torch.int32, -1)
    .fill_rows(np.array([2, 7]), 5, cols=np.array([1, 3])),
    "map": lambda m: _host(m).map(quantize_rows_device),
}


@pytest.mark.parametrize("op", list(CONTAINER_OPS))
def test_container_makes_each_shard_on_its_device(op):
    mesh = make_mesh((4,), ("data",), devices=PLACED)
    check_placed(CONTAINER_OPS[op](mesh), mesh)


@pytest.mark.parametrize("case", list(FLAT) + ["lexical"])
def test_index_keeps_each_shard_on_its_device(case):
    """The flat index and the lexical table through every write, on the
    mesh of ``PLACED``."""
    mesh = make_mesh((4,), ("data",), devices=PLACED)
    if case == "lexical":
        fp = tl.LexicalFingerprints(128, kterms=16, mesh=mesh)
        fp.set_rows(np.arange(100), DOCS * 25)
        fp.device_arrays(0)
        fp.set_rows(np.array([3, 90]), DOCS[:2])  # the mirror in lockstep
        check_placed(fp, mesh)
        fp.remap(np.where(np.arange(100) % 3 == 0, -1, np.arange(100)))
        fp.device_arrays(0)
        check_placed(fp, mesh)
        return
    x, tags, _ = _rows(3, 900)
    idx = FlatIndex(128, mesh=mesh, **FLAT[case])
    idx.add(x[:300], tags[:300])
    check_placed(idx, mesh)
    idx.add(x[300:], tags[300:])  # grows: materialized anew
    idx.update_rows(np.arange(10, 30), x[600:620], tags[600:620])
    idx.remove(np.arange(0, 900, 7))
    check_placed(idx, mesh)
    idx.compact()
    check_placed(idx, mesh)
