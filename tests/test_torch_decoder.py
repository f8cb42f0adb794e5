"""The causal LM (semcode_tpu_torch/models/decoder.py) against the JAX package's.

Same inputs, made from numpy seeds, go through both packages on the CPU:

- ``init_params`` is bit-equal to JAX's (numpy draws in the same order);
- a synthetic HF GPT-2 checkpoint (HF's names and Conv1D layout) gives
  teacher-forced logits equal to JAX's at float32 (atol 1e-5) and within
  4% of the logits' spread at bfloat16 (two libraries' bf16 products);
- greedy ``generate_tokens`` equals JAX's token for token at float32 on the
  seeded init, the HF checkpoint and the shipped fixture, at several
  buckets and ``max_new`` 1, 2 and 17, and the KV-cached decode equals the
  teacher-forced rollout;
- ``CodeDecoderLM``: the ``max_new_tokens`` clamp, the tail kept from an
  over-long prompt and ``prompt_bucket`` as in JAX; checkpoints load across
  packages in both directions (a 12-layer tree: flax keys blocks "0".."11",
  and "10" sorts before "2" as a string); 12 threads get the serial tokens.

The fixture ``semcode_tpu_torch/assets/lm-tiny`` is a byte-level decoder
written by the JAX package's own ``LMTrainer`` and ``save_lm_params`` on the
CPU over the chunks of ``semcode_tpu/`` with the QA mix. Its recipe is
``write_fixture`` below, run as

    JAX_PLATFORMS=cpu python tests/test_torch_decoder.py --write-fixture
"""

import json
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "semcode_tpu_torch" / "assets" / "lm-tiny"

if __name__ == "__main__":  # the script form: the repo root on the path
    sys.path.insert(0, str(ROOT))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from semcode_tpu.models import decoder as jdec  # noqa: E402
from semcode_tpu_torch.models import decoder as tdec  # noqa: E402

VOCAB, HIDDEN, LAYERS, HEADS, MAXLEN = 97, 32, 2, 2, 160
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _synthetic_hf_checkpoint(path: Path, rng) -> None:
    """A tiny GPT-2 checkpoint in HF's on-disk format (config.json +
    model.safetensors, ``transformer.`` prefix, Conv1D (in, out) kernels)."""
    from safetensors.numpy import save_file

    (path / "config.json").write_text(json.dumps({
        "model_type": "gpt2", "vocab_size": VOCAB, "n_embd": HIDDEN,
        "n_layer": LAYERS, "n_head": HEADS, "n_positions": MAXLEN, "n_inner": None,
    }))

    def w(*shape):
        return rng.normal(0.0, 0.1, size=shape).astype(np.float32)

    raw = {
        "transformer.wte.weight": w(VOCAB, HIDDEN),
        "transformer.wpe.weight": w(MAXLEN, HIDDEN),
        "transformer.ln_f.weight": 1.0 + 0.1 * w(HIDDEN),
        "transformer.ln_f.bias": 0.1 * w(HIDDEN),
    }
    for i in range(LAYERS):
        p = f"transformer.h.{i}."
        for ln in ("ln_1", "ln_2"):
            raw[p + ln + ".weight"] = 1.0 + 0.1 * w(HIDDEN)
            raw[p + ln + ".bias"] = 0.1 * w(HIDDEN)
        for name, n_in, n_out in (("attn.c_attn", HIDDEN, 3 * HIDDEN),
                                  ("attn.c_proj", HIDDEN, HIDDEN),
                                  ("mlp.c_fc", HIDDEN, 4 * HIDDEN),
                                  ("mlp.c_proj", 4 * HIDDEN, HIDDEN)):
            raw[p + name + ".weight"] = w(n_in, n_out)
            raw[p + name + ".bias"] = 0.1 * w(n_out)
    save_file(raw, str(path / "model.safetensors"))


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("gpt2-tiny")
    _synthetic_hf_checkpoint(path, np.random.default_rng(3))
    return path


def _pair(source, dtype, hf_dir=None):
    """(JAX params, JAX cfg, port model) for one weight source."""
    if source == "seeded":
        jcfg = jdec.DecoderConfig(vocab_size=258, hidden=64, layers=2, heads=2,
                                  mlp_dim=256, max_len=160, dtype=JDT[dtype])
        tcfg = tdec.DecoderConfig(vocab_size=258, hidden=64, layers=2, heads=2,
                                  mlp_dim=256, max_len=160, dtype=TDT[dtype])
        jp, tp = jdec.init_params(jcfg, seed=7), tdec.init_params(tcfg, seed=7)
    elif source == "hf":
        jp, jcfg = jdec.load_hf_decoder_params(hf_dir, dtype=JDT[dtype])
        tp, tcfg = tdec.load_hf_decoder_params(hf_dir, dtype=TDT[dtype])
    else:
        from semcode_tpu.models.train_lm import load_lm_params as jload
        from semcode_tpu_torch.models.train_lm import load_lm_params as tload

        jp, jcfg = jload(FIXTURE, dtype=JDT[dtype])
        tp, tcfg = tload(FIXTURE, dtype=TDT[dtype])
    return jp, jcfg, tdec.build_decoder(tp, tcfg, "cpu")


def _prompts(rng, vocab, bucket, lengths):
    ids = np.zeros((len(lengths), bucket), np.int32)
    mask = np.zeros_like(ids)
    for row, n in enumerate(lengths):
        ids[row, :n] = rng.integers(2, vocab, n)
        mask[row, :n] = 1
    return ids, mask


def _leaves(tree):
    return jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, tree))


@pytest.mark.parametrize("preset", ["tiny", "mini"])
def test_init_params_bit_equal(preset):
    if preset == "tiny":
        kw = dict(vocab_size=VOCAB, hidden=HIDDEN, layers=LAYERS, heads=HEADS,
                  mlp_dim=4 * HIDDEN, max_len=MAXLEN)
        jcfg, tcfg = jdec.DecoderConfig(**kw), tdec.DecoderConfig(**kw)
    else:
        jcfg, tcfg = jdec.DecoderConfig.preset("mini"), tdec.DecoderConfig.preset("mini")
    assert tcfg.hidden == jcfg.hidden and tcfg.layers == jcfg.layers
    want = jax.tree_util.tree_flatten(jdec.init_params(jcfg, seed=3))
    got = jax.tree_util.tree_flatten(tdec.init_params(tcfg, seed=3))
    assert got[1] == want[1]  # the same tree, blocks a list
    for a, b in zip(want[0], got[0]):
        assert b.dtype == np.float32 and np.array_equal(np.asarray(a), b)


def test_hf_loader_maps_the_same_tree(hf_dir):
    jp, jcfg = jdec.load_hf_decoder_params(hf_dir, dtype=jnp.float32)
    tp, tcfg = tdec.load_hf_decoder_params(hf_dir, dtype=torch.float32)
    assert (tcfg.vocab_size, tcfg.hidden, tcfg.layers, tcfg.heads, tcfg.mlp_dim,
            tcfg.max_len) == (jcfg.vocab_size, jcfg.hidden, jcfg.layers, jcfg.heads,
                              jcfg.mlp_dim, jcfg.max_len)
    for a, b in zip(_leaves(jp), _leaves(tp)):
        assert np.array_equal(a, b)


# float32: the same function in float32 (atol 1e-5); bfloat16: the logits'
# largest difference within 4% of their standard deviation (XLA and torch
# round bf16 products and sums in their own orders)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_logits_match_jax(hf_dir, dtype):
    jp, jcfg, model = _pair("hf", dtype, hf_dir)
    ids, mask = _prompts(np.random.default_rng(5), VOCAB, 24, [24, 13, 1])
    want = np.asarray(jdec.forward_logits(jp, jcfg, jnp.asarray(ids), jnp.asarray(mask)))
    got = tdec.forward_logits(model, ids, mask).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape == (3, 24, VOCAB)
    live = mask.astype(bool)  # padded rows' logits are not read
    if dtype == "float32":
        np.testing.assert_allclose(got[live], want[live], rtol=0, atol=1e-5)
    else:
        assert np.abs(got[live] - want[live]).max() <= 0.04 * want[live].std()


# the first token of every case is the prefill's argmax; max_new 2 takes one
# decode step, 17 sixteen; buckets wider than the prompt pad it
GEN_CASES = [(bucket, max_new) for bucket in (16, 32, 128) for max_new in (1, 2, 17)]


@pytest.mark.parametrize("bucket,max_new", GEN_CASES)
@pytest.mark.parametrize("source", ["seeded", "hf", "fixture"])
def test_greedy_tokens_match_jax(hf_dir, source, bucket, max_new):
    jp, jcfg, model = _pair(source, "float32", hf_dir)
    rng = np.random.default_rng(bucket * 31 + max_new)
    lengths = [bucket, max(bucket // 2 - 3, 1), 1]
    ids, mask = _prompts(rng, jcfg.vocab_size, bucket, lengths)
    want = np.asarray(jdec.generate_tokens(
        jp, jcfg, jnp.asarray(ids), jnp.asarray(mask), jax.random.PRNGKey(0),
        max_new=max_new, greedy=True))
    got = tdec.generate_tokens(model, ids, mask, max_new=max_new)
    assert got.shape == (3, max_new) and got.dtype == torch.long
    assert got.numpy().tolist() == want.tolist()
    counts = model.counts
    assert counts["prefills"] == 1 and counts["decode_steps"] == max_new - 1
    assert counts["graph_captures"] == counts["graph_replays"] == 0  # the CPU: eager


def test_kv_cache_decode_matches_teacher_forced_rollout(hf_dir):
    _, _, model = _pair("hf", "float32", hf_dir)
    prompt = np.random.default_rng(11).integers(0, VOCAB, size=5).tolist()
    ids = np.zeros((1, 8), np.int64)
    mask = np.zeros_like(ids)
    ids[0, :5], mask[0, :5] = prompt, 1
    got = tdec.generate_tokens(model, ids, mask, max_new=6)[0].tolist()
    seq, want = list(prompt), []
    for _ in range(6):
        logits = tdec.forward_logits(model, np.asarray([seq]), np.ones((1, len(seq))))
        want.append(int(logits[0, -1].argmax()))
        seq.append(want[-1])
    assert got == want


def test_sampling_is_seeded_and_greedy_ignores_the_seed(hf_dir):
    _, _, model = _pair("hf", "float32", hf_dir)
    ids, mask = _prompts(np.random.default_rng(2), VOCAB, 16, [9])

    def run(**kw):
        return tdec.generate_tokens(model, ids, mask, max_new=12, **kw)[0].tolist()

    assert run(seed=1) == run(seed=2)
    hot = dict(greedy=False, temperature=1.5)
    assert run(seed=4, **hot) == run(seed=4, **hot) != run(seed=5, **hot)
    with pytest.raises(ValueError, match="CUDA model"):
        run(graph=True)


def _lms(max_len=64):
    """The same seeded float32 decoder as a JAX and a port ``CodeDecoderLM``
    (the JAX one assembled as the JAX package's tests do)."""
    from semcode_tpu.models.tokenizer import ByteTokenizer

    jcfg = jdec.DecoderConfig(vocab_size=258, hidden=32, layers=2, heads=2, mlp_dim=128,
                              max_len=max_len, dtype=jnp.float32)
    jlm = jdec.CodeDecoderLM.__new__(jdec.CodeDecoderLM)
    jlm.tokenizer, jlm.cfg = ByteTokenizer(max_len=max_len), jcfg
    jlm.params, jlm.random_init = jdec.init_params(jcfg, seed=0), True
    from semcode_tpu_torch.models.tokenizer import ByteTokenizer as TByteTokenizer

    tcfg = tdec.DecoderConfig(vocab_size=258, hidden=32, layers=2, heads=2, mlp_dim=128,
                              max_len=max_len, dtype=torch.float32)
    tlm = tdec.CodeDecoderLM.__new__(tdec.CodeDecoderLM)
    tlm.tokenizer, tlm.cfg = TByteTokenizer(max_len=max_len), tcfg
    tlm.model = tdec.build_decoder(tdec.init_params(tcfg, seed=0), tcfg, "cpu")
    return jlm, tlm


def test_code_decoder_lm_clamps_max_new_tokens():
    """``rag_max_new_tokens`` >= max_len flows raw from settings: both
    packages clamp it to max_len - 16 (and at least 1) alike."""
    jlm, tlm = _lms()
    for bad in (64, 100, 48, 0, -5, 7):
        arr, msk, max_new = tlm.prompt_arrays("some question", bad)
        assert max_new == max(1, min(bad, 48))
        assert arr.shape == (1, max(64 - max_new, 16))
        assert tlm.generate("some question", max_new_tokens=bad) == jlm.generate(
            "some question", max_new_tokens=bad)


def test_code_decoder_lm_keeps_the_prompt_tail():
    jlm, tlm = _lms(max_len=160)
    prompt = "".join(chr(97 + i % 26) for i in range(300)) + " where is the tail?"
    arr, msk, max_new = tlm.prompt_arrays(prompt, 32)
    assert max_new == 32 and arr.shape == (1, 128) and msk.sum() == 128
    assert bytes(int(i) - 2 for i in arr[0]).decode().endswith(" where is the tail?")
    for n in (32, 100):
        assert tlm.generate(prompt, max_new_tokens=n) == jlm.generate(prompt, max_new_tokens=n)


def test_prompt_bucket_matches_jax():
    for max_len in (16, 64, 100, 128, 300, 512, 832, 1024, 4096):
        for n in (1, 15, 16, 100, 128, 129, 256, 257, 511, 512, 513, 1024, 3000):
            assert tdec.prompt_bucket(n, max_len) == jdec.prompt_bucket(n, max_len)


def test_code_decoder_lm_weight_sources(hf_dir):
    lm = tdec.CodeDecoderLM("mini", max_len=128, seed=3, device="cpu")
    assert lm.random_init and lm.cfg.hidden == 384 and lm.cfg.dtype == torch.bfloat16
    assert lm.cfg.vocab_size == 258 and lm.model.wte.device.type == "cpu"
    np.testing.assert_array_equal(
        lm.model.wte.numpy(), tdec.init_params(lm.cfg, seed=3)["wte"])
    hf = tdec.CodeDecoderLM(weights_path=hf_dir, dtype="float32", device="cpu")
    assert not hf.random_init and hf.cfg.vocab_size == VOCAB
    fx = tdec.CodeDecoderLM(weights_path=FIXTURE, device="cpu")
    assert not fx.random_init and fx.cfg.dtype == torch.bfloat16
    assert fx.model.blocks[0].c_attn.kernel.dtype == torch.bfloat16
    assert fx.model.wte.dtype == torch.float32 and fx.model.wte_c.dtype == torch.bfloat16


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_checkpoints_cross_load(tmp_path, direction):
    """A 12-layer tree through either package's writer and the other's
    reader: the same leaves, blocks in order (string order would put "10"
    and "11" before "2")."""
    from semcode_tpu.models.train_lm import load_lm_params as jload, save_lm_params as jsave
    from semcode_tpu_torch.models.train_lm import load_lm_params as tload, save_lm_params as tsave

    kw = dict(vocab_size=258, hidden=16, layers=12, heads=2, mlp_dim=32, max_len=32)
    jcfg, tcfg = jdec.DecoderConfig(**kw), tdec.DecoderConfig(**kw)
    params = tdec.init_params(tcfg, seed=5)
    for i, block in enumerate(params["blocks"]):
        block["ln_1"]["bias"] += i  # each block tells its index
    if direction == "jax_to_torch":
        jsave(jax.tree_util.tree_map(jnp.asarray, params), jcfg, tmp_path)
        got, cfg = tload(tmp_path)
        assert cfg == tcfg
    else:
        tsave(params, tcfg, tmp_path)
        got, cfg = jload(tmp_path)
        assert (cfg.layers, cfg.hidden, cfg.dtype) == (12, 16, jnp.bfloat16)
    assert [float(np.asarray(b["ln_1"]["bias"])[0]) for b in got["blocks"]] == list(range(12))
    for a, b in zip(_leaves(params), _leaves(got)):
        assert np.array_equal(a, b)
    assert json.loads((tmp_path / "semcode_lm.json").read_text())["dtype"] == "bfloat16"


def test_threads_get_the_serial_tokens(hf_dir):
    """12 threads generate at once, with a short switch interval: each
    gets the tokens it gets alone (the decode lock serialises them)."""
    _, _, model = _pair("hf", "bfloat16", hf_dir)
    rng = np.random.default_rng(8)
    cases = [_prompts(rng, VOCAB, 16, [int(rng.integers(1, 17))]) for _ in range(12)]
    serial = [tdec.generate_tokens(model, i, m, max_new=9).tolist() for i, m in cases]
    got = [None] * len(cases)
    barrier = threading.Barrier(len(cases))

    def run(k):
        barrier.wait()
        got[k] = tdec.generate_tokens(model, *cases[k], max_new=9).tolist()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=run, args=(k,)) for k in range(len(cases))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert got == serial


def test_fixture_answers_in_its_grammar():
    """The fixture is trained enough that a QA-grammar prompt completes into
    text, not whitespace (the pipeline treats an empty answer as a failure)."""
    lm = tdec.CodeDecoderLM(weights_path=FIXTURE, device="cpu")
    prompt = (f"{tdec.QA_CONTEXT}def quantize_rows(x):\n    return x"
              f"{tdec.QA_QUESTION}what does quantize_rows do?{tdec.QA_ANSWER}")
    text = lm.generate(prompt, max_new_tokens=48)
    assert text.split(tdec.QA_STOP)[0].strip()


# -- the fixture's recipe -----------------------------------------------------


def write_fixture(out: Path = FIXTURE, steps: int = 3000) -> None:
    """Train the fixture with the JAX package's own trainer on the CPU: the
    chunks of ``semcode_tpu/`` (repo-relative paths) and the QA mix at half
    of each batch, hidden 128, 2 layers, 2 heads, MLP 512, max_len 512."""
    from semcode_tpu.chunking.chunker import CodeChunker, guess_language
    from semcode_tpu.models.tokenizer import ByteTokenizer
    from semcode_tpu.models.train_lm import (
        LMTrainer,
        WindowBatcher,
        build_qa_texts,
        save_lm_params,
    )
    from semcode_tpu.parallel.mesh import make_mesh

    chunker, chunks = CodeChunker(), []
    for f in sorted((ROOT / "semcode_tpu").rglob("*.py")):
        rel = f.relative_to(ROOT)
        chunks += chunker.chunk_text(f.read_text(encoding="utf-8"), path=rel,
                                     language=guess_language(f) or "text")
    qa = build_qa_texts(chunks)
    tok = ByteTokenizer(max_len=512)
    cfg = jdec.DecoderConfig(vocab_size=tok.vocab_size, hidden=128, layers=2, heads=2,
                             mlp_dim=512, max_len=512)
    trainer = LMTrainer(cfg, make_mesh((1,), ("data",), devices=jax.devices()[:1]),
                        learning_rate=3e-3)
    params, opt_state = trainer.init_state(seed=0)
    batcher = WindowBatcher([c.content for c in chunks], tok, seq_len=512, batch_size=16,
                            seed=0, anchored_texts=qa, anchored_frac=0.5)
    print(f"{len(chunks)} chunks, {len(qa)} QA texts")
    for step, batch in enumerate(batcher.batches(steps), 1):
        params, opt_state, metrics = trainer.train_step(params, opt_state, batch)
        if step % 100 == 0:
            print(f"step {step} loss {float(metrics['loss']):.4f} "
                  f"acc {float(metrics['accuracy']):.3f}", flush=True)
    save_lm_params(params, cfg, out)
    print(f"wrote {out}")


if __name__ == "__main__":
    if sys.argv[1:] != ["--write-fixture"]:
        raise SystemExit("usage: JAX_PLATFORMS=cpu python tests/test_torch_decoder.py "
                         "--write-fixture")
    write_fixture()
