"""The IVF probing kernel's plain version against the Pallas kernel.

The same numpy cluster blocks, ids, queries and probe tables go through the
JAX ``ivf_scan_shard`` (Pallas interpret mode, one shard that owns every
probe) and the port's ``ivf_scan`` on the CPU, which runs its plain torch
version. Inputs hold empty (-1) slots and duplicated rows, so scores tie.
Required: int8 scores bit-identical (both compute the exact integer dot and
the same two f32 multiplies); bf16/f32 scores within rtol 1e-5 (f32 sums in
another order); ids identical at every position whose score stands apart
from its neighbours (the Pallas kernel's order among tied scores depends on
its running-slot reuse once more than 128 candidates reach a query's top-k).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semcode_tpu.ops.kernels import ivf_scan_shard
from semcode_tpu_torch.ops import ivf_scan as ivf_ops
from semcode_tpu_torch.ops.ivf_scan import NEG, ivf_scan, ivf_scan_reference, probe_table


def _inputs(storage, nlist, cmax, d, nq, nprobe, seed, tail=24):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((nlist, cmax, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    x[:, 8:16] = x[:, 0:8]  # duplicated rows: tied scores
    ids = np.arange(nlist * cmax, dtype=np.int32).reshape(nlist, cmax)
    ids[rng.random((nlist, cmax)) < 0.1] = -1  # tombstones
    ids[:, cmax - tail:] = -1  # the empty tail of each capacity-padded block
    q = rng.standard_normal((nq, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    probes = np.stack(
        [rng.choice(nlist, nprobe, replace=False) for _ in range(nq)]
    ).astype(np.int32)
    if storage == "int8":
        sc = (np.maximum(np.abs(x).max(-1), 1e-12) / 127.0).astype(np.float32)
        data = np.clip(np.rint(x / sc[..., None]), -127, 127).astype(np.int8)
        return data, ids, q, probes, sc, jnp.asarray(data), torch.from_numpy(data)
    jdt = jnp.bfloat16 if storage == "bfloat16" else jnp.float32
    jd = jnp.asarray(x).astype(jdt)
    tdt = torch.bfloat16 if storage == "bfloat16" else torch.float32
    td = torch.from_numpy(np.array(jd.astype(jnp.float32))).to(tdt)
    return x, ids, q, probes, None, jd, td


def untied_ids_equal(s_ref, i_ref, i_got, tol=0.0):
    """Ids equal wherever the reference score stands apart from both
    neighbours by more than ``tol``; the last column is excluded."""
    gap = s_ref[:, :-1] - s_ref[:, 1:]
    apart = np.ones(s_ref.shape, dtype=bool)
    apart[:, 1:] &= gap > tol
    apart[:, :-1] &= gap > tol
    apart[:, -1] = False
    return np.array_equal(i_got[apart], i_ref[apart])


def _run_both(storage, nlist, cmax, d, nq, nprobe, k, seed, tiles=None,
              tail=24):
    _, ids, q, probes, sc, jd, td = _inputs(storage, nlist, cmax, d, nq,
                                            nprobe, seed, tail)
    js, ji = ivf_scan_shard(
        jd, jnp.asarray(ids), jnp.asarray(q), jnp.asarray(probes),
        jnp.ones(probes.shape, jnp.int32), k=k, interpret=True,
        scales_s=None if sc is None else jnp.asarray(sc), tiles=tiles,
    )
    ts, ti = ivf_scan(td, torch.from_numpy(ids), torch.from_numpy(q),
                      torch.from_numpy(probes), k,
                      None if sc is None else torch.from_numpy(sc))
    return np.asarray(js), np.asarray(ji), ts.numpy(), ti.numpy()


def _check(storage, js, ji, ts, ti):
    if storage == "int8":
        np.testing.assert_array_equal(ts, js)
        assert untied_ids_equal(js, ji, ti)
    else:
        np.testing.assert_allclose(ts, js, rtol=1e-5, atol=1e-6)
        assert untied_ids_equal(js, ji, ti, tol=1e-5)
    # the tail of a query with fewer than k candidates is -3e38 / -1
    assert ((ti == -1) == (ts <= NEG / 2)).all()


@pytest.mark.parametrize("storage", ["int8", "bfloat16", "float32"])
@pytest.mark.parametrize("cmax,d,nq,nprobe,k", [
    (128, 128, 8, 1, 16),
    (128, 256, 16, 3, 64),
    (256, 128, 16, 8, 64),
    (256, 256, 8, 3, 16),
])
def test_plain_version_matches_pallas_kernel(storage, cmax, d, nq, nprobe, k):
    js, ji, ts, ti = _run_both(storage, 8, cmax, d, nq, nprobe, k,
                               seed=cmax + d + nq + nprobe)
    _check(storage, js, ji, ts, ti)


@pytest.mark.parametrize("storage", ["int8", "float32"])
def test_matches_dim_slab_and_row_split_variants(storage):
    """The Pallas kernel's dim-slab (dtile < d) and cluster row-split
    (ctile < cmax) tilings compute the same function."""
    js, ji, ts, ti = _run_both(storage, 8, 256, 256, 8, 3, 16, seed=5,
                               tiles=(128, 128))
    _check(storage, js, ji, ts, ti)


def test_fewer_candidates_than_k():
    """One probe of a cluster with at most 28 valid slots, k=64: the
    result's tail is empty."""
    js, ji, ts, ti = _run_both("int8", 8, 128, 128, 8, 1, 64, seed=9, tail=100)
    assert (ti[:, -1] == -1).all()
    _check("int8", js, ji, ts, ti)


def test_probe_table_orders_and_dedupes():
    p = torch.tensor([[5, 1, 5, 9], [3, -1, 2, 2]])
    assert probe_table(p, 8).tolist() == [[1, 5, -1, -1], [-1, 2, -1, 3]]


def test_cpu_wrapper_runs_the_plain_version():
    _, ids, q, probes, sc, _, td = _inputs("int8", 8, 128, 128, 4, 2, 3)
    args = (td, torch.from_numpy(ids), torch.from_numpy(q),
            torch.from_numpy(probes), 10, torch.from_numpy(sc))
    before = ivf_ops.ivf_scan.launches
    s, i = ivf_scan(*args)
    rs, ri = ivf_scan_reference(*args)
    assert torch.equal(s, rs) and torch.equal(i, ri)
    assert ivf_ops.ivf_scan.launches == before  # no kernel on the CPU
    assert s.dtype == torch.float32 and i.dtype == torch.int32
    assert (s[:, :-1] >= s[:, 1:]).all()


def test_argument_checks():
    _, ids, q, probes, sc, _, td = _inputs("int8", 8, 128, 128, 4, 2, 3)
    t_ids, t_q, t_p = torch.from_numpy(ids), torch.from_numpy(q), torch.from_numpy(probes)
    with pytest.raises(ValueError, match="per-row scales"):
        ivf_scan(td, t_ids, t_q, t_p, 10)
    with pytest.raises(ValueError, match="k <= 64"):
        ivf_scan(td, t_ids, t_q, t_p, 65, torch.from_numpy(sc))
    with pytest.raises(ValueError, match="multiples of 128"):
        ivf_scan(td[:, :100], t_ids[:, :100], t_q, t_p, 10,
                 torch.from_numpy(sc)[:, :100])
