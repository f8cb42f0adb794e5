"""The port's training commands on the CPU, each in a fresh process.

``python -m semcode_tpu_torch.cli train``, ``train-lm`` (after an ``ingest``
of a small repository) and ``train-rerank`` run with
``SEMCODE_TORCH_DEVICE=cpu`` in a temporary workspace, print the JAX CLI's
step lines and hints, exit 0, load no JAX module, and write files that the
JAX package's ``load_params``, ``load_lm_params`` and ``load_table`` read.
Without a card and without that variable they raise instead of running on
the CPU.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
NO_JAX = ("import sys; from semcode_tpu_torch.cli import main; rc = main(sys.argv[1:]); "
          "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
          "('jax', 'flax', 'optax', 'semcode_tpu')); "
          "assert not bad, bad; raise SystemExit(rc)")


def _env(ws):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("SEMCODE_") and k != "XLA_FLAGS"}
    # one intra-op thread: the models are small, and pytest-xdist runs
    # several test processes at once
    env.update(PYTHONPATH=str(ROOT), SEMCODE_TORCH_DEVICE="cpu",
               SEMCODE_WORKSPACE_ROOT=str(ws), OMP_NUM_THREADS="1")
    return env


def _cli(ws, *args):
    proc = subprocess.run([sys.executable, "-c", NO_JAX, *args], cwd=ROOT, env=_env(ws),
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    return proc.stdout


@pytest.fixture()
def corpus(tmp_path):
    src = tmp_path / "corpus" / "pkg"
    src.mkdir(parents=True)
    for name in ("data.py", "train.py", "term_reranker.py", "tokenizer.py"):
        shutil.copy(ROOT / "semcode_tpu" / "models" / name, src / name)
    return src.parent


def test_train_writes_an_encoder_checkpoint_jax_loads(tmp_path, corpus):
    from semcode_tpu.models.train import load_params

    out = _cli(tmp_path / "ws", "train", "--from", str(corpus), "--steps", "2",
               "--seq-len", "32", "--batch-size", "4", "--warmup", "1")
    assert "training on " in out and "step 1/2 loss=" in out and "step 2/2 loss=" in out
    ckpt = tmp_path / "ws" / "encoder"
    assert f"[encoder] weights_path='{ckpt}'" in out
    params, cfg = load_params(ckpt)
    assert (cfg.hidden, cfg.layers, cfg.max_len, cfg.vocab_size) == (384, 6, 32, 32768)
    assert params["params"]["block_5"]["attn"]["query"]["kernel"].shape == (384, 12, 32)


def test_train_lm_writes_a_checkpoint_jax_loads(tmp_path, corpus):
    from semcode_tpu.models.train_lm import load_lm_params

    ws = tmp_path / "ws"
    _cli(ws, "ingest", "--name", "demo", "--include", "pkg", "--root", str(corpus), "--yes")
    out = _cli(ws, "train-lm", "--repo", "demo", "--steps", "2", "--seq-len", "64",
               "--batch-size", "4")
    assert "training LM on " in out and "QA mix: " in out and "step 2/2 loss=" in out
    assert f"weights_path='{ws / 'lm'}'" in out
    params, cfg = load_lm_params(ws / "lm")
    assert (cfg.hidden, cfg.layers, cfg.vocab_size, cfg.max_len) == (384, 6, 258, 1024)
    assert len(params["blocks"]) == 6


def test_train_rerank_writes_a_table_jax_loads(tmp_path, corpus):
    from semcode_tpu.models.term_reranker import load_table

    out = _cli(tmp_path / "ws", "train-rerank", "--from", str(corpus), "--steps", "3",
               "--batch-size", "8", "--dim", "8")
    assert "(query, chunk) pairs" in out and "term-reranker step 3/3 loss=" in out
    table = load_table(tmp_path / "ws" / "term-reranker.npz")
    assert table.shape == (131072, 8)


@pytest.mark.parametrize("command", ["train", "train-lm", "train-rerank"])
def test_training_raises_without_a_card(tmp_path, corpus, monkeypatch, command):
    from semcode_tpu_torch.cli import main

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    monkeypatch.delenv("SEMCODE_TORCH_DEVICE", raising=False)
    monkeypatch.setenv("SEMCODE_WORKSPACE_ROOT", str(tmp_path / "ws"))
    args = {"train": ["--from", str(corpus)], "train-lm": ["--repo", "all"],
            "train-rerank": ["--from", str(corpus)]}[command]
    with pytest.raises(RuntimeError, match="SEMCODE_TORCH_DEVICE=cpu"):
        main([command, *args, "--steps", "1"])
