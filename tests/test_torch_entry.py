"""The port's multi-device entry (``semcode_tpu_torch.entry``) on the CPU.

- ``dryrun_multichip(8, device="cpu")`` and ``(4, ...)`` run every step of
  the reference's ``_dryrun_body`` (the DP x TP contrastive step, the
  sharded flat search with a filtered search, the full-probe IVF search
  against the exact scan, the batched dispatch, the DP x TP LM step with a
  sharded KV-cache decode, the ``("dcn", "data")`` int8 IVF search) with
  its assertions, on ``[cpu] * n``, and print the reference's summary line;
- ``entry(device="cpu")``'s forward, fed the JAX ``entry()``'s params
  through ``encoder_state_from_jax``, gives the JAX forward's embeddings at
  ``tests/test_torch_encoder.py``'s bf16 tolerance (per-row cosine >=
  0.999);
- the CLI ``train --steps 2`` with ``SEMCODE_TORCH_DEVICE=cpu`` and
  ``SEMCODE_MESH_SHAPE=4`` (four data replicas on the CPU) writes a
  checkpoint both packages load with equal arrays; a batch of 6 rows on
  that mesh is refused.
"""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SUMMARY = (r"dryrun_multichip ok: {n} devices \(train mesh {mesh} dp x tp, encoder "
           r"loss=\d+\.\d{{4}}, lm loss=\d+\.\d{{4}} \+ sharded kv-cache decode; index "
           r"mesh {n} shards; 2-level dcn x data mesh verified\)")
NO_JAX = ("import sys; from semcode_tpu_torch.cli import main; rc = main(sys.argv[1:]); "
          "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
          "('jax', 'flax', 'optax', 'semcode_tpu')); "
          "assert not bad, bad; raise SystemExit(rc)")


@pytest.fixture()
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n,mesh", [(8, "4x2"), (4, "2x2")])
def test_dryrun_multichip_runs_every_step(n, mesh, capsys, _two_torch_threads):
    from semcode_tpu_torch.entry import dryrun_multichip, mesh_devices

    assert mesh_devices(3, "cpu") == [torch.device("cpu")] * 3
    line = dryrun_multichip(n, device="cpu")
    assert re.fullmatch(SUMMARY.format(n=n, mesh=mesh), line), line
    assert line in capsys.readouterr().out


def test_entry_forward_matches_jax(_two_torch_threads):
    import __graft_entry__ as graft

    from semcode_tpu_torch.entry import entry
    from semcode_tpu_torch.models.encoder import encoder_state_from_jax

    jfn, (jparams, jids, jmask) = graft.entry()
    want = np.asarray(jfn(jparams, jids, jmask))
    fn, (params, ids, mask) = entry(device="cpu")
    assert ids.shape == mask.shape == (8, 128) and params["tok_emb.weight"].shape == (32768, 384)
    state = encoder_state_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    with torch.no_grad():
        got = fn(state, ids, mask).numpy()
        own = fn(params, ids, mask).numpy()
    assert got.shape == want.shape == (8, 384)
    cos = (got * want).sum(1) / np.linalg.norm(got, axis=1) / np.linalg.norm(want, axis=1)
    assert cos.min() >= 0.999, cos
    assert np.isfinite(own).all()
    np.testing.assert_allclose(np.linalg.norm(own, axis=1), 1.0, rtol=1e-5)


def _cli(ws, *args, check=True):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("SEMCODE_") and k != "XLA_FLAGS"}
    env.update(PYTHONPATH=str(ROOT), SEMCODE_TORCH_DEVICE="cpu", SEMCODE_MESH_SHAPE="4",
               SEMCODE_WORKSPACE_ROOT=str(ws), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", NO_JAX, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    if check:
        assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    return proc


def test_cli_train_on_a_four_replica_mesh(tmp_path):
    from semcode_tpu.models.train import load_params as jload

    from semcode_tpu_torch.models.train import load_params as tload

    src = tmp_path / "corpus" / "pkg"
    src.mkdir(parents=True)
    for name in ("data.py", "train.py", "tokenizer.py"):
        shutil.copy(ROOT / "semcode_tpu" / "models" / name, src / name)
    args = ("train", "--from", str(src.parent), "--steps", "2", "--seq-len", "32")
    out = _cli(tmp_path / "ws", *args, "--batch-size", "4").stdout
    assert "step 1/2 loss=" in out and "step 2/2 loss=" in out
    ckpt = tmp_path / "ws" / "encoder"
    jparams, jcfg = jload(ckpt)
    tparams, tcfg = tload(ckpt)
    assert (jcfg.hidden, jcfg.layers, jcfg.max_len) == (tcfg.hidden, tcfg.layers,
                                                          tcfg.max_len) == (384, 6, 32)
    want = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, jparams))
    got = jax.tree_util.tree_leaves(tparams)
    assert len(got) == len(want) > 50
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    bad = _cli(tmp_path / "ws2", *args, "--batch-size", "6", check=False)
    assert bad.returncode != 0
    assert "a batch of 6 rows does not split over 4 data replicas" in bad.stderr
