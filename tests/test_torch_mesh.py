"""The port's meshes and its sharded merge, gather and rescore against JAX's.

The JAX package runs on its 8 virtual CPU devices (``tests/conftest.py``),
on the 1-D ``mesh8`` and on the ``(2, 4)`` ``("dcn", "data")`` mesh; the
port runs the same shapes on ``[cpu] * 8``. Inputs come from numpy seeds.
Required: the merge and the fingerprint gather equal bit for bit (ties
included), the rescores within rtol 1e-5 (f32 dot products summed in
another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from semcode_tpu.index import lexical as jl
from semcode_tpu.index import scan as jscan
from semcode_tpu.parallel import mesh as jmesh
from semcode_tpu_torch.index import lexical as tl
from semcode_tpu_torch.index import scan as tscan
from semcode_tpu_torch.parallel import distributed as tdist
from semcode_tpu_torch.parallel import mesh as tmesh

MESHES = [((8,), ("data",)), ((2, 4), ("dcn", "data"))]


def _pair(shape, names):
    return (jmesh.make_mesh(shape, names),
            tmesh.make_mesh(shape, names, devices=["cpu"] * 8))


# -- mesh construction -----------------------------------------------------------


def test_make_mesh_shapes_and_errors():
    m = tmesh.make_mesh((2, 4), ("dcn", "data"), devices=["cpu"] * 8)
    assert m.shape == {"dcn": 2, "data": 4}
    assert m.home == torch.device("cpu") and len(m.local_devices()) == 8
    assert (m.process_index, m.process_count) == (0, 1)
    assert tmesh.n_shards(m) == 8
    with pytest.raises(ValueError, match="does not match"):
        tmesh.make_mesh((3,), devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="axis names"):
        tmesh.make_mesh((2, 4), ("data",), devices=["cpu"] * 8)
    assert tmesh.make_mesh(devices=["cpu"] * 3).shape == {"data": 3}


def test_get_mesh_on_the_cpu(monkeypatch):
    monkeypatch.setenv("SEMCODE_TORCH_DEVICE", "cpu")
    assert tmesh.get_mesh("").shape == {"data": 1}
    assert tmesh.get_mesh("8").shape == {"data": 8}
    m = tmesh.get_mesh("2x4", ("dcn", "data"))
    assert m.shape == {"dcn": 2, "data": 4}
    assert tmesh.get_mesh("", device="cpu").local_devices() == [torch.device("cpu")]
    # the default mesh of an index follows its device
    assert tmesh.resolve_mesh(None, "cpu").shape == {"data": 1}
    elsewhere = tmesh.Mesh(np.array([torch.device("meta")], dtype=object),
                           ("data",))
    with pytest.raises(ValueError, match="not the home"):
        tmesh.resolve_mesh(elsewhere, "cpu")
    assert tmesh.resolve_mesh(m, "cpu") is m


@pytest.mark.parametrize("spec", ["", "8", "4x2", "4X2 ", " 2x2x2"])
def test_parse_mesh_shape_matches_reference(spec):
    assert tmesh.parse_mesh_shape(spec) == jmesh.parse_mesh_shape(spec)


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 100, 513])
def test_pad_bucket_and_round_up_match_reference(n):
    assert tmesh.pad_bucket(n) == jmesh.pad_bucket(n)
    for m in (0, 8, 128, 96):
        assert tmesh.round_up(n, m) == jmesh.round_up(n, m)


def test_row_axes_and_linear_rank_match_reference():
    jm = jmesh.make_mesh((2, 2, 2), ("dcn", "data", "model"))
    tm = tmesh.make_mesh((2, 2, 2), ("dcn", "data", "model"),
                         devices=["cpu"] * 8)
    assert tmesh.row_axes(tm) == jmesh.row_axes(jm) == ("dcn", "data")
    assert tmesh.n_shards(tm) == 4
    # a shard is read on the first device of its model group
    assert [r for r, _ in tmesh.local_shards(tm)] == [0, 1, 2, 3]
    axes = tmesh.row_axes(tm)
    ranks = {pos: tmesh.linear_rank(tm, axes, pos)
             for pos in np.ndindex(2, 2, 2)}
    assert ranks[(1, 0, 1)] == 2 and ranks[(0, 1, 0)] == 1

    # JAX's traced rank, read out of a shard_map, per device position
    def body(x):
        return x * 0 + jmesh.linear_rank(jm, axes)

    got = jax.shard_map(body, mesh=jm, in_specs=P(axes), out_specs=P(axes),
                        check_vma=False)(jnp.zeros((4,), jnp.int32))
    assert np.asarray(got).tolist() == [0, 1, 2, 3]


# -- the merge -------------------------------------------------------------------


def _jax_merge(jm, s, i, k):
    axes = jmesh.row_axes(jm)

    def body(ss, ii):
        return jmesh.hierarchical_topk_merge(ss[0], ii[0], k, axes)

    return jax.shard_map(
        body, mesh=jm, in_specs=(P(axes), P(axes)),
        out_specs=(P(None, None), P(None, None)), check_vma=False,
    )(jnp.asarray(s), jnp.asarray(i))


@pytest.mark.parametrize("shape,names", MESHES)
@pytest.mark.parametrize("k", [1, 5, 16, 40])
def test_hierarchical_merge_with_ties_matches_reference(shape, names, k):
    jm, tm = _pair(shape, names)
    rng = np.random.default_rng(k)
    # (shards, Q, k') candidates on a coarse grid: many exact ties within
    # and across shards, including the -3e38 padding
    s = rng.integers(0, 6, (8, 5, 5)).astype(np.float32) / 4.0
    s[:, 0, :] = 1.0  # a query whose candidates all tie
    s[3, 1, 2:] = -3.0e38
    s = -np.sort(-s, axis=2)
    i = rng.integers(0, 1000, (8, 5, 5)).astype(np.int32)
    js, ji = _jax_merge(jm, s, i, k)
    ts, ti = tmesh.hierarchical_topk_merge(
        [(torch.from_numpy(s[r]), torch.from_numpy(i[r]).long())
         for r in range(8)], k, tm,
    )
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    # inner-first merging equals one merge over every shard in rank order
    fs, fi = tmesh.topk_merge([torch.from_numpy(s[r]) for r in range(8)],
                              [torch.from_numpy(i[r]).long() for r in range(8)], k)
    assert torch.equal(fs, ts) and torch.equal(fi, ti)


# -- the sharded rescore and fingerprint gather ----------------------------------


def _ids(rng, n_rows, shape):
    ids = rng.integers(0, n_rows, shape).astype(np.int32)
    ids[0, :3] = -1
    ids[1, 0] = n_rows - 1
    return ids


@pytest.mark.parametrize("shape,names", MESHES)
@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_rescore_global_matches_reference(shape, names, metric):
    jm, tm = _pair(shape, names)
    rng = np.random.default_rng(7)
    n, d = 256, 32
    f = rng.standard_normal((n, d)).astype(np.float32)
    nrm = np.sum(f * f, axis=1)
    q = rng.standard_normal((6, d)).astype(np.float32)
    ids = _ids(rng, n, (6, 9))
    want = np.asarray(jscan.rescore_global(jm, jnp.asarray(f), jnp.asarray(nrm),
                                           jnp.asarray(q), jnp.asarray(ids), metric))
    got = tscan.rescore_global(tm, torch.from_numpy(f), torch.from_numpy(nrm),
                               torch.from_numpy(q), torch.from_numpy(ids), metric)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # the two-level int8 mirror: corpus + residual rebuilt on the owning shard
    from semcode_tpu.index.flat import quantize_residual, quantize_rows

    qx, sx = quantize_rows(f)
    rq, rs = quantize_residual(f, qx, sx)
    want = np.asarray(jscan.rescore_global_residual(
        jm, *(jnp.asarray(a) for a in (qx, sx, rq, rs, nrm, q, ids)), metric))
    got = tscan.rescore_global_residual(
        tm, *(torch.from_numpy(a) for a in (qx, sx, rq, rs, nrm, q, ids)), metric)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape,names", MESHES)
def test_gather_fingerprints_matches_reference(shape, names):
    jm, tm = _pair(shape, names)
    rng = np.random.default_rng(11)
    n, kt = 256, 16
    fp_ids = rng.integers(-1, 1 << 20, (n, kt)).astype(np.int32)
    fp_w = rng.random((n, kt)).astype(np.float16)
    fp_len = rng.random(n).astype(np.float32) * 50
    fp_sym = rng.integers(-1, 1 << 20, n).astype(np.int32)
    ids = _ids(rng, n + 40, (5, 12))  # some ids past the table: unowned
    want = jl.gather_fingerprints(jm, *(jnp.asarray(a) for a in
                                        (fp_ids, fp_w, fp_len, fp_sym, ids)))
    got = tl.gather_fingerprints(tm, *(torch.from_numpy(a) for a in
                                       (fp_ids, fp_w, fp_len, fp_sym, ids)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# -- multi-process settings ----------------------------------------------------------


class _Cfg:
    def __init__(self, **kw):
        self.mesh_num_processes = kw.get("num", 1)
        self.mesh_coordinator = kw.get("coordinator")
        self.mesh_process_id = kw.get("pid", 0)


def test_distributed_settings_single_process():
    assert tdist.maybe_init_distributed(_Cfg(), device="cpu") is False
    assert tdist.multihost_mesh_shape(_Cfg(), device="cpu") is None
    with pytest.raises(ValueError, match="coordinator"):
        tdist.maybe_init_distributed(_Cfg(num=2), device="cpu")
    assert tdist.pick_backend("cpu") == "gloo"
    assert tdist.pick_backend("cpu", "nccl") == "nccl"
    assert tdist.pick_backend("cpu", "gloo") == "gloo"
    with pytest.raises(ValueError, match="backend"):
        tdist.pick_backend("cpu", "mpi")
