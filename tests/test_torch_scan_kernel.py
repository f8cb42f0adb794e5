"""top2_scan (semcode_tpu_torch/ops/scan_top2.py) against the Pallas kernel.

The plain torch version ``top2_scan_reference`` — what the wrapper runs on
CPU tensors — is held against ``semcode_tpu.ops.scan_kernel2.
top2_scan_shard`` in Pallas interpret mode on the same numpy inputs. int8:
identical rows and scores within 1e-6 (both dots are exact integers);
bf16/f32: scores within rtol 1e-5 (f32 accumulation order differs), rows
identical where a block's top-2 are separated by more than 1e-4. The CUDA
kernel itself is compared with the plain version on the card only
(tests/test_torch_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semcode_tpu.ops.scan_kernel2 import top2_scan_shard
from semcode_tpu_torch.ops.scan_top2 import NEG, top2_scan, top2_scan_reference


def _inputs(storage, rs, d, nq, metric, seed):
    """Shard operands as both exact scans build them (unit-norm rows)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rs, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    x[rs // 3 : rs // 3 + 4] = x[:4]  # exact duplicates: tie order
    q = rng.standard_normal((nq, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    dead = rng.random(rs) < 0.05
    add = np.where(dead, NEG, 0.0).astype(np.float32)
    if metric == "l2":
        add = add - np.sum(x * x, axis=1)
    if storage == "int8":
        sc = np.maximum(np.abs(x).max(axis=1), 1e-12) / 127.0
        vecs = np.clip(np.rint(x / sc[:, None]), -127, 127).astype(np.int8)
        mult = sc.astype(np.float32)
        qs = np.maximum(np.abs(q).max(axis=1), 1e-12) / 127.0
        qq = np.clip(np.rint(q / qs[:, None]), -127, 127).astype(np.float32)
        qsc = qs.astype(np.float32)
    else:
        vecs = x
        mult = np.ones(rs, np.float32)
        qq, qsc = q, np.ones(nq, np.float32)
    if metric == "l2":
        mult = (2.0 * mult).astype(np.float32)
    return vecs, mult, add.astype(np.float32), qq, qsc


def _jax(storage, vecs, mult, add, qq, qsc):
    v = jnp.asarray(vecs)
    if storage == "bfloat16":
        v = v.astype(jnp.bfloat16)
    bm, br = top2_scan_shard(
        v, jnp.asarray(mult)[None, :], jnp.asarray(add)[None, :],
        jnp.asarray(qq).astype(jnp.bfloat16), jnp.asarray(qsc)[:, None],
        interpret=True,
    )
    return np.asarray(bm), np.asarray(br)


def _torch(storage, vecs, mult, add, qq, qsc, device="cpu"):
    v = torch.from_numpy(vecs)
    if storage == "bfloat16":
        v = v.to(torch.bfloat16)
    q_t = torch.from_numpy(qq)
    q_t = q_t.to(torch.int8) if storage == "int8" else q_t.to(torch.bfloat16)
    args = [v, torch.from_numpy(mult), torch.from_numpy(add), q_t,
            torch.from_numpy(qsc)]
    return [a.to(device) for a in args]


@pytest.mark.parametrize("storage", ["int8", "bfloat16", "float32"])
@pytest.mark.parametrize("metric", ["ip", "l2"])
@pytest.mark.parametrize("rs,d,nq", [(300, 128, 5), (1000, 256, 8)])
def test_reference_matches_pallas_interpret(storage, metric, rs, d, nq):
    ops = _inputs(storage, rs, d, nq, metric, seed=rs + d)
    jm, jr = _jax(storage, *ops)
    tm, tr = top2_scan_reference(*_torch(storage, *ops))
    tm, tr = tm.numpy(), tr.numpy()
    # JAX tiles rows by pick_tiles(); below 4096 rows its block count is
    # ceil(Rs/128), the port's layout
    assert jm.shape == tm.shape == (nq, 2 * (-(-rs // 128)))
    if storage == "int8":
        np.testing.assert_array_equal(tr, jr)
        np.testing.assert_allclose(tm, jm, rtol=0, atol=1e-6)
    else:
        np.testing.assert_allclose(tm, jm, rtol=1e-5, atol=1e-6)
        nb = tm.shape[1] // 2
        gap = np.abs(jm[:, :nb] - jm[:, nb:])
        clear = np.concatenate([gap, gap], axis=1) > 1e-4
        np.testing.assert_array_equal(tr[clear], jr[clear])


def test_dead_block_emits_lane_zero_twice():
    """An all-sentinel block emits (-3e38, block base) in both slots, as the
    Pallas kernel's _top2_lanes does; a block with one live row puts the
    sentinel's lowest lane second."""
    storage, rs, d, nq = "int8", 384, 128, 3
    vecs, mult, add, qq, qsc = _inputs(storage, rs, d, nq, "ip", seed=3)
    add[128:256] = NEG  # block 1 dead
    add[256:384] = NEG
    add[300] = 0.0  # block 2: one live row
    jm, jr = _jax(storage, vecs, mult, add, qq, qsc)
    tm, tr = top2_scan_reference(*_torch(storage, vecs, mult, add, qq, qsc))
    np.testing.assert_array_equal(tr.numpy(), jr)
    np.testing.assert_array_equal(tm.numpy(), jm)
    nb = 3
    assert (tr.numpy()[:, 1] == 128).all() and (tr.numpy()[:, nb + 1] == 128).all()
    assert (tr.numpy()[:, 2] == 300).all() and (tr.numpy()[:, nb + 2] == 256).all()


def test_wrapper_runs_plain_version_on_cpu_without_launching():
    ops = _torch("int8", *_inputs("int8", 200, 128, 4, "ip", seed=5))
    before = top2_scan.launches
    bm, br = top2_scan(*ops)
    rm, rr = top2_scan_reference(*ops)
    assert torch.equal(bm, rm) and torch.equal(br, rr)
    assert top2_scan.launches == before


def test_wrapper_rejects_bad_operands():
    vecs, mult, add, qq, qsc = _torch("int8", *_inputs("int8", 200, 128, 4, "ip", 6))
    with pytest.raises(ValueError, match="dim % 128"):
        top2_scan(vecs[:, :64], mult, add, qq[:, :64], qsc)
    with pytest.raises(TypeError, match="qq must be"):
        top2_scan(vecs, mult, add, qq.to(torch.bfloat16), qsc)
    with pytest.raises(TypeError, match="mult must hold"):
        top2_scan(vecs, mult[:10], add, qq, qsc)
