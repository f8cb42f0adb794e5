"""dot_max (semcode_tpu_torch/ops/dot_max.py) against the JAX formulations.

The TPU kernel that dot_max replaces is built inside
``tools/dot_pallas.py::main()`` (``make_kernel`` is a closure there, over
module-level sizes), so no test can reach it. The reference side is
therefore the XLA formulation that tool holds its kernel against
(``xla_s8s8``, dot_pallas.py:147-153) and the kernel's own ``bf16cast``
contraction (dot_pallas.py:64-72), both through ``jax.lax.dot_general`` on
the CPU. The port's plain version, which the wrapper runs on CPU tensors,
must equal them exactly (int32) on the same numpy inputs. The CUDA kernel is
compared with the plain version on the card (tests/test_torch_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semcode_tpu_torch.ops import dot_max as dot_ops
from semcode_tpu_torch.ops.dot_max import BF16_MAX_DIM, RTILES, dot_max, dot_max_reference

DN = (((1,), (1,)), ((), ()))


def _inputs(n, d, nq, low, seed):
    """int8 rows and queries over [low, 127], with a row of +127s, a row of
    ``low``s and queries of both, so the extreme sums of either sign occur."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(low, 128, (n, d), dtype=np.int8)
    q = rng.integers(low, 128, (nq, d), dtype=np.int8)
    rows[n // 2] = 127
    rows[-1] = low
    q[0] = 127
    q[-1] = low
    return rows, q


def _jax_s32(rows, q):
    s = jax.lax.dot_general(jnp.asarray(q), jnp.asarray(rows), DN,
                            preferred_element_type=jnp.int32)
    return np.asarray(jnp.max(s, axis=1))


def _jax_bf16cast(rows, q):
    s = jax.lax.dot_general(
        jnp.asarray(q).astype(jnp.bfloat16), jnp.asarray(rows).astype(jnp.bfloat16),
        DN, preferred_element_type=jnp.float32,
    ).astype(jnp.int32)
    return np.asarray(jnp.max(s, axis=1))


@pytest.mark.parametrize("nq", [1, 7, 64])
@pytest.mark.parametrize("d", [128, 384, 1024])
@pytest.mark.parametrize("n", [1, 127, 1000, 4097])
@pytest.mark.parametrize("mode", ["s32", "bf16"])
def test_dot_max_matches_jax(mode, n, d, nq):
    low = -128 if mode == "s32" else -127
    rows, q = _inputs(n, d, nq, low, seed=n + d + nq)
    want = _jax_s32(rows, q) if mode == "s32" else _jax_bf16cast(rows, q)
    got = dot_max(torch.from_numpy(rows), torch.from_numpy(q), mode=mode)
    assert got.dtype == torch.int32 and got.shape == (nq,)
    np.testing.assert_array_equal(got.numpy(), want)
    # the plain version itself, and the other JAX formulation where both hold
    plain = dot_max_reference(torch.from_numpy(rows), torch.from_numpy(q))
    np.testing.assert_array_equal(plain.numpy(), _jax_s32(rows, q))


def test_bf16_limit_is_the_exactness_limit():
    """d * 127**2 < 2**24 up to d = 1040, so the largest d the kernel stages
    (a multiple of 128) in bf16 mode is 1024, where all-127 operands are
    exact; the wrapper refuses d = 1152, where f32 partial sums can pass
    2**24 and round, and the s32 mode takes it."""
    assert BF16_MAX_DIM * 127 * 127 < 2**24 < (BF16_MAX_DIM + 1) * 127 * 127
    rows = np.full((3, 1024), 127, np.int8)
    q = np.full((2, 1024), 127, np.int8)
    np.testing.assert_array_equal(_jax_bf16cast(rows, q), [1024 * 127 * 127] * 2)
    got = dot_max(torch.from_numpy(rows), torch.from_numpy(q), mode="bf16")
    assert got.tolist() == [1024 * 127 * 127] * 2
    rows = np.full((3, 1152), 127, np.int8)
    q = np.full((2, 1152), 127, np.int8)
    with pytest.raises(ValueError, match="bf16 mode is exact only"):
        dot_max(torch.from_numpy(rows), torch.from_numpy(q), mode="bf16")
    got = dot_max(torch.from_numpy(rows), torch.from_numpy(q), mode="s32")
    assert got.tolist() == [1152 * 127 * 127] * 2


def _ok(n=8, d=128, nq=2):
    return torch.zeros((n, d), dtype=torch.int8), torch.zeros((nq, d), dtype=torch.int8)


@pytest.mark.parametrize("rtile", [32, 100, 512, "128"])
def test_unknown_rtile_raises(rtile):
    rows, q = _ok()
    with pytest.raises(ValueError, match="rtile"):
        dot_max(rows, q, rtile=rtile)


@pytest.mark.parametrize("rtile", RTILES)
def test_every_rtile_accepted(rtile):
    rows, q = _inputs(300, 128, 5, -128, seed=rtile)
    got = dot_max(torch.from_numpy(rows), torch.from_numpy(q), rtile=rtile)
    np.testing.assert_array_equal(got.numpy(), _jax_s32(rows, q))


def test_bad_arguments_raise():
    rows, q = _ok()
    with pytest.raises(ValueError, match="mode"):
        dot_max(rows, q, mode="f32")
    for d in (64, 200, 0):
        with pytest.raises(ValueError, match="d % 128"):
            dot_max(*_ok(d=d))
    with pytest.raises(ValueError, match=r"q must be \(Q, 128\)"):
        dot_max(rows, torch.zeros((2, 256), dtype=torch.int8))
    with pytest.raises(ValueError, match="at least one row"):
        dot_max(*_ok(n=0))
    with pytest.raises(ValueError, match="2-D"):
        dot_max(rows[0], q)
    with pytest.raises(TypeError, match="int8"):
        dot_max(rows.to(torch.float32), q)
    with pytest.raises(TypeError, match="int8"):
        dot_max(rows, q.to(torch.int16))
    with pytest.raises(ValueError, match="span devices"):
        dot_max(rows, q.to("meta"))


def test_cpu_call_launches_no_kernel():
    rows, q = _inputs(500, 256, 9, -128, seed=3)
    before = dot_ops.dot_max.launches
    got = dot_max(torch.from_numpy(rows), torch.from_numpy(q), mode="bf16", rtile=64)
    assert dot_ops.dot_max.launches == before
    np.testing.assert_array_equal(got.numpy(), _jax_s32(rows, q))
