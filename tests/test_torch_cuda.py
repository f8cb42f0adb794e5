"""Kernels and device paths of semcode_tpu_torch on a CUDA card.

Every test needs an NVIDIA card and nvcc and skips without them. This file
imports nothing of JAX, so it runs on a card host that has no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``--noconftest``: the suite's conftest configures JAX's CPU mesh.)
Comparisons hold each kernel against its plain torch version on the same
card inputs: int8 bit-identical; bf16/f32 within rtol 1e-5 (f32 sums run
in another order).
"""

import numpy as np
import pytest
import torch

from semcode_tpu_torch.embeddings.hash_embedder import HashEmbeddings
from semcode_tpu_torch.index.flat import FlatIndex
from semcode_tpu_torch.ops import scan_top2
from semcode_tpu_torch.ops.scan_top2 import NEG, top2_scan, top2_scan_reference

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _operands(storage, rs, d, nq, gen, device):
    x = torch.randn(rs, d, generator=gen, device=device)
    x = x / x.norm(dim=1, keepdim=True)
    q = torch.randn(nq, d, generator=gen, device=device)
    q = q / q.norm(dim=1, keepdim=True)
    add = torch.where(torch.rand(rs, generator=gen, device=device) < 0.05,
                      NEG, 0.0).float()
    if storage == "int8":
        sc = torch.clamp(x.abs().amax(1), min=1e-12) / 127.0
        vecs = torch.clamp(torch.round(x / sc[:, None]), -127, 127).to(torch.int8)
        qs = torch.clamp(q.abs().amax(1), min=1e-12) / 127.0
        qq = torch.clamp(torch.round(q / qs[:, None]), -127, 127).to(torch.int8)
        return vecs, sc, add, qq, qs
    dt = torch.bfloat16 if storage == "bfloat16" else torch.float32
    return (x.to(dt), torch.ones(rs, device=device), add, q.to(torch.bfloat16),
            torch.ones(nq, device=device))


@pytest.mark.parametrize("storage", ["int8", "bfloat16", "float32"])
@pytest.mark.parametrize("rs,d,nq", [(100, 128, 1), (1000, 384, 8), (70001, 384, 512)])
def test_top2_scan_matches_plain_version(cuda, storage, rs, d, nq):
    gen = torch.Generator(device=cuda).manual_seed(rs + d + nq)
    ops = _operands(storage, rs, d, nq, gen, cuda)
    before = scan_top2.top2_scan.launches
    bm, br = top2_scan(*ops)
    torch.cuda.synchronize()
    assert scan_top2.top2_scan.launches == before + 1
    rm, rr = top2_scan_reference(*ops)
    if storage == "int8":
        assert torch.equal(bm, rm) and torch.equal(br, rr)
    else:
        torch.testing.assert_close(bm, rm, rtol=1e-5, atol=1e-6)


def test_flat_index_card_matches_cpu(cuda):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5000, 384)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = x[:16] + 0.05 * rng.standard_normal((16, 384)).astype(np.float32)
    out = {}
    for dev in ("cpu", "cuda"):
        idx = FlatIndex(384, dtype="int8", scan_impl="pallas", device=dev)
        idx.add(x)
        idx.remove(np.arange(0, 5000, 11))
        out[dev] = idx.search(q, 10)
    np.testing.assert_array_equal(out["cuda"][1], out["cpu"][1])
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5, atol=1e-6)


def test_hash_projection_card_equals_cpu(cuda):
    a = HashEmbeddings(384, device="cpu").projection()
    b = HashEmbeddings(384, device=cuda).projection()
    assert np.array_equal(a, b)
