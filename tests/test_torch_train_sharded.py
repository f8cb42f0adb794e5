"""The port's DP x TP sharded training against the JAX package's, on the CPU.

The port's meshes are ``parallel.mesh`` meshes of ``[cpu] * 8`` (one
process runs every shard); the JAX trainers run on the conftest's 8 CPU
devices. Both trainers are small (hidden 64, 2 layers, 4 heads, MLP 128,
vocab 512, sequence 32, batch 8) and start from the same params: flax's
init carried across by ``encoder_state_from_jax``, and the decoder's
shared ``init_params``.

- the encoder's and the LM's step on the ``(4, 2)`` ``("data", "model")``
  mesh against the JAX trainers' on ``make_mesh((4, 2), ("data",
  "model"))``: at float32 the loss and accuracy within 1e-5, every
  gradient (gathered onto one device, mapped to the JAX tree) within rtol
  1e-4 / atol 1e-6, five full steps' losses within 1e-3 relative; at
  bfloat16 the first loss within 2e-2 (the one-device tolerances of
  ``test_torch_train.py`` / ``test_torch_train_lm.py``);
- the port's sharded step against its own one-device step at the float32
  tolerances, on ``(8,)``, ``(4, 2)`` and ``(2, 4)`` meshes;
- ``param_spec`` / ``param_spec_lm`` against the reference's
  ``make_param_shardings`` / ``_spec_for``, leaf by leaf through
  ``encoder_state_to_jax`` / ``decoder_state_to_jax``: each element is
  tagged with the model shard that holds it (-1: replicated), and the
  tags must equal JAX's layout, except the decoder's fused ``c_attn``,
  which the port splits by heads (Megatron) and the reference by
  contiguous columns: there the split dim and each shard's share agree;
- the training mesh's grid (``Mesh.device_at``); a batch that does not
  divide by the replica count, and a head count that does not divide by
  the model shards, raise;
- a checkpoint saved from a sharded trainer (``gather``) loads in the JAX
  package's ``load_params`` / ``load_lm_params`` with equal arrays;
- the float32 tokens decoded from the sharded LM state (``LMTrainer.
  decoder``, eager, each shard's KV cache holding its own heads) equal the
  one-device eager tokens on the gathered state, every token, on the
  shipped fixture ``assets/lm-tiny`` (2 heads) at 2 model shards, with 1
  and 4 data replicas; without a model axis ``decoder`` is the
  one-device model.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semcode_tpu.models import decoder as jdec
from semcode_tpu.models import encoder as jenc
from semcode_tpu.models import train as jtrain
from semcode_tpu.models import train_lm as jtl
from semcode_tpu.parallel.mesh import make_mesh as jmake_mesh
from semcode_tpu_torch.models import decoder as tdec
from semcode_tpu_torch.models import encoder as tenc
from semcode_tpu_torch.models import train as ttrain
from semcode_tpu_torch.models import train_lm as ttl
from semcode_tpu_torch.models.tokenizer import ByteTokenizer
from semcode_tpu_torch.parallel.mesh import make_mesh

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(vocab_size=512, hidden=64, layers=2, heads=4, mlp_dim=128, max_len=32)
SEQ, BATCH = 32, 8
LM_FIXTURE = ROOT / "semcode_tpu_torch" / "assets" / "lm-tiny"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The models here are tiny: torch's intra-op threads would only contend
    with the other test processes (pytest-xdist runs several files at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _names(shape):
    return ("data",) if len(shape) == 1 else ("data", "model")


def _tmesh(shape):
    return make_mesh(shape, _names(shape), devices=["cpu"] * int(np.prod(shape)))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, np.asarray(tree, dtype=np.float32)


def _pair_batch(seed, rows=BATCH):
    """Anchor and positive rows: CLS first, random lengths, pad after."""
    rng = np.random.default_rng(seed)
    out = {}
    for side in ("anchor", "pos"):
        lens = rng.integers(3, SEQ + 1, size=rows)
        mask = (np.arange(SEQ)[None] < lens[:, None]).astype(np.int32)
        ids = rng.integers(2, SMALL["vocab_size"], size=(rows, SEQ)).astype(np.int32)
        ids[:, 0] = 1
        out[f"{side}_ids"] = np.where(mask > 0, ids, 0).astype(np.int32)
        out[f"{side}_mask"] = mask
    return out


def _lm_batch(seed, rows=BATCH):
    rng = np.random.default_rng(seed)
    lens = rng.integers(3, SEQ + 1, size=rows)
    mask = (np.arange(SEQ)[None] < lens[:, None]).astype(np.int32)
    ids = rng.integers(2, SMALL["vocab_size"], size=(rows, SEQ)).astype(np.int32)
    return {"ids": np.where(mask > 0, ids, 0).astype(np.int32), "mask": mask}


class _Encoder:
    batch = staticmethod(_pair_batch)

    @staticmethod
    def jax(dtype, mesh, lr=1e-3):
        jt = jtrain.ContrastiveTrainer(jenc.EncoderConfig(dtype=dtype, **SMALL), mesh,
                                       learning_rate=lr)
        return (jt, *jt.init_state(jax.random.PRNGKey(0), seq_len=SEQ))

    @staticmethod
    def port(dtype, mesh, lr=1e-3, jparams=None, **cfg):
        tcfg = tenc.EncoderConfig(dtype=dtype, **{**SMALL, **cfg})
        tt = ttrain.ContrastiveTrainer(tcfg, mesh, learning_rate=lr, device="cpu")
        if jparams is None:
            jparams = _Encoder.jax(jnp.float32, _jax_mesh((1,)))[1]
        state = tenc.encoder_state_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
        return (tt, *tt.state_from(state))

    @staticmethod
    def to_jax(trainer, state):
        return tenc.encoder_state_to_jax(state, trainer.cfg)


class _LM:
    batch = staticmethod(_lm_batch)

    @staticmethod
    def jax(dtype, mesh, lr=1e-3):
        jt = jtl.LMTrainer(jdec.DecoderConfig(dtype=dtype, **SMALL), mesh, learning_rate=lr)
        return (jt, *jt.init_state(seed=0))

    @staticmethod
    def port(dtype, mesh, lr=1e-3, jparams=None, **cfg):
        tt = ttl.LMTrainer(tdec.DecoderConfig(dtype=dtype, **{**SMALL, **cfg}), mesh,
                           learning_rate=lr, device="cpu")
        return (tt, *tt.init_state(seed=0))

    @staticmethod
    def to_jax(trainer, state):
        return tdec.decoder_state_to_jax(state)


KINDS = {"encoder": _Encoder, "lm": _LM}


def _jax_mesh(shape):
    return jmake_mesh(shape, _names(shape), devices=jax.devices()[: int(np.prod(shape))])


def _assert_grads_close(got_tree, want_tree):
    want = dict(_leaves(want_tree))
    got = dict(_leaves(got_tree))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)


# -- against the JAX package's sharded trainers ---------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_sharded_step_matches_jax(kind, dtype):
    k = KINDS[kind]
    jmesh = _jax_mesh((4, 2))
    jt, jp, jo = k.jax(getattr(jnp, dtype), jmesh)
    tt, tp, to = k.port(getattr(torch, dtype), _tmesh((4, 2)), jparams=jp)
    assert tt.mesh.replicas == 4 and tt.mesh.model_shards == 2
    assert any(isinstance(v, list) for v in tp.values())  # split masters
    batch = k.batch(0)
    dev_batch = {key: jax.device_put(jnp.asarray(v), jt._batch_sharding)
                 for key, v in batch.items()}
    tm, tgrads = tt.value_and_grad(tp, batch)
    if dtype == "bfloat16":
        jloss, _ = jax.jit(jt._loss_fn)(jp, dev_batch)
        assert abs(float(tm["loss"]) - float(jloss)) <= 2e-2
        for name, g in tt.gather(tgrads).items():
            assert g.dtype == torch.float32 and torch.isfinite(g).all(), name
        return
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(jt._loss_fn, has_aux=True))(
        jp, dev_batch)
    assert abs(float(tm["loss"]) - float(jloss)) <= 1e-5
    assert abs(float(tm["accuracy"]) - float(jm["accuracy"])) <= 1e-5
    _assert_grads_close(k.to_jax(tt, tt.gather(tgrads)),
                        jax.tree_util.tree_map(np.asarray, jgrads))
    jl, tl = [], []
    for i in range(5):
        b = k.batch(i + 1)
        jp, jo, m1 = jt.train_step(jp, jo, b)
        tp, to, m2 = tt.train_step(tp, to, b)
        jl.append(float(m1["loss"]))
        tl.append(float(m2["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    assert tl[-1] < tl[0]


# -- against the port's own one-device step --------------------------------------------


@pytest.mark.parametrize("shape", [(8,), (4, 2), (2, 4)], ids=["8", "4x2", "2x4"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_sharded_step_matches_one_device(kind, shape):
    k = KINDS[kind]
    jp = _Encoder.jax(jnp.float32, _jax_mesh((1,)))[1] if kind == "encoder" else None
    one, p1, o1 = k.port(torch.float32, None, jparams=jp)
    sh, p2, o2 = k.port(torch.float32, _tmesh(shape), jparams=jp)
    assert sh.mesh.replicas == shape[0]
    assert sh.mesh.model_shards == (shape[1] if len(shape) > 1 else 1)
    m1, g1 = one.value_and_grad(p1, k.batch(0))
    m2, g2 = sh.value_and_grad(p2, k.batch(0))
    assert abs(float(m2["loss"]) - float(m1["loss"])) <= 1e-5
    assert abs(float(m2["accuracy"]) - float(m1["accuracy"])) <= 1e-5
    g2 = sh.gather(g2)
    assert sorted(g2) == sorted(g1)
    for name in g1:
        np.testing.assert_allclose(g2[name].numpy(), g1[name].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=name)
    l1, l2 = [], []
    for i in range(5):
        l1.append(float(one.train_step(p1, o1, k.batch(i + 1))[2]["loss"]))
        l2.append(float(sh.train_step(p2, o2, k.batch(i + 1))[2]["loss"]))
    np.testing.assert_allclose(l2, l1, rtol=1e-3)


# -- the sharding rules ----------------------------------------------------------------


def _port_tags(trainer):
    """Each state_dict element tagged with its model shard (-1: replicated)."""
    tags = {}
    for name, value in trainer.model.state_dict().items():
        split = trainer.splits[name]
        if split is None:
            tags[name] = torch.full(value.shape, -1.0)
            continue
        pieces = ttrain.split_pieces(torch.zeros(value.shape), split, trainer.mesh.model_shards)
        tags[name] = ttrain.merge_pieces(
            [torch.full(p.shape, float(m)) for m, p in enumerate(pieces)], split)
    return tags


def _jax_tags(spec, shape, shards):
    tags = np.full(shape, -1.0, np.float32)
    for axis, name in enumerate(spec):
        if name == "model":
            idx = np.arange(shape[axis]) // (shape[axis] // shards)
            tags = np.broadcast_to(
                np.expand_dims(idx, [a for a in range(len(shape)) if a != axis]),
                shape).astype(np.float32)
    return tags


def _varying_axes(tags):
    return {a for a in range(tags.ndim) if (np.diff(tags, axis=a) != 0).any()}


@pytest.mark.parametrize("shape", [(4, 2), (2, 4)], ids=["4x2", "2x4"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_param_specs_match_jax_leaf_by_leaf(kind, shape):
    k = KINDS[kind]
    jmesh = _jax_mesh(shape)
    shards = shape[1]
    if kind == "encoder":
        params = jenc.CodeEncoder(jenc.EncoderConfig(**SMALL)).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32), jnp.ones((1, 8), jnp.int32))
        specs = jtrain.make_param_shardings(jmesh, params)
    else:
        params = jdec.init_params(jdec.DecoderConfig(**SMALL), seed=0)
        specs = jax.tree_util.tree_map_with_path(
            lambda path, leaf: jtl._spec_for(jmesh, path, leaf), params)
    want = dict(_leaves(jax.tree_util.tree_map(
        lambda s, leaf: _jax_tags(s.spec, np.shape(leaf), shards), specs, params)))
    tt = k.port(torch.float32, _tmesh(shape), jparams=params)[0]
    got = dict(_leaves(k.to_jax(tt, _port_tags(tt))))
    assert sorted(got) == sorted(want)
    # split leaves: per layer q/k/v kernels and biases, out, mlp_in's two,
    # mlp_out, then tok_emb (encoder); c_attn's two, c_proj, c_fc's two,
    # mlp c_proj, then wte (decoder)
    split_leaves = [path for path in want if (want[path] >= 0).any()]
    assert len(split_leaves) == (10 if kind == "encoder" else 6) * SMALL["layers"] + 1
    for path in want:
        if "c_attn" in path:
            # by heads here, by contiguous columns in the reference: the same
            # split dim, the same share a shard
            assert _varying_axes(got[path]) == _varying_axes(want[path]) == {
                want[path].ndim - 1}, path
            for m in range(shards):
                assert (got[path] == m).sum() == (want[path] == m).sum(), path
            assert not np.array_equal(got[path], want[path])
            continue
        np.testing.assert_array_equal(got[path], want[path], err_msg=path)
    # without a "model" axis nothing is split, as in the reference's _spec_for
    assert all(s is None for s in k.port(torch.float32, _tmesh((8,)),
                                         jparams=params)[0].splits.values())


def test_param_spec_rules_by_name():
    spec, spec_lm = ttrain.param_spec, ttl.param_spec_lm
    assert spec("blocks.3.attn.qkv.weight") == ttrain.Split(0, 3)
    assert spec("blocks.0.attn.out.weight") == ttrain.Split(1)
    assert spec("blocks.0.attn.out.bias") is None
    assert spec("blocks.0.mlp_out.bias") is None and spec("pos_emb") is None
    assert spec("tok_emb.weight") == ttrain.Split(1) and spec("ln_f.weight") is None
    assert spec_lm("blocks.1.c_attn.kernel") == ttrain.Split(1, 3)
    assert spec_lm("blocks.1.c_proj.kernel") == ttrain.Split(0)
    assert spec_lm("blocks.1.c_proj.bias") is None and spec_lm("wpe") is None
    assert spec_lm("wte") == ttrain.Split(1) and spec_lm("blocks.0.mlp_proj.bias") is None


def test_training_mesh_grid():
    """``device_at(d, m)`` reads ``devices[d, m]``; a mesh with another axis
    longer than one is no training mesh; a grid whose shard devices differ
    from the home device trains as one whose entries are all the home."""
    cpu, cpu0 = torch.device("cpu"), torch.device("cpu", 0)
    mesh = make_mesh((2, 2), ("data", "model"), devices=[cpu, cpu0, cpu, cpu0])
    assert (mesh.replicas, mesh.model_shards) == (2, 2)
    assert [mesh.device_at(d, m) for d in (0, 1) for m in (0, 1)] == [cpu, cpu0] * 2
    one_axis = make_mesh((4,), ("data",), devices=[cpu] * 4)
    assert (one_axis.replicas, one_axis.model_shards, one_axis.device_at(3, 0)) == (4, 1, cpu)
    with pytest.raises(ValueError, match="not a one-process"):
        make_mesh((2, 2), ("dcn", "data"), devices=[cpu] * 4).device_at(0, 0)
    losses = []
    for m in (mesh, _tmesh((2, 2))):
        tt, tp, _ = _LM.port(torch.float32, m)
        losses.append(float(tt.value_and_grad(tp, _lm_batch(0))[0]["loss"]))
    assert losses[0] == losses[1]


# -- what raises -----------------------------------------------------------------------


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_indivisible_batch_or_heads_raise(kind):
    k = KINDS[kind]
    tt, tp, _ = k.port(torch.float32, _tmesh((4, 2)))
    with pytest.raises(ValueError, match="does not split over 4 data replicas"):
        tt.value_and_grad(tp, k.batch(0, rows=6))
    # hidden 96 and MLP 192 divide by 3 model shards, 4 heads do not
    with pytest.raises(ValueError, match="heads = 4 does not divide"):
        k.port(torch.float32, _tmesh((2, 3)), hidden=96, mlp_dim=192)


# -- checkpoints -----------------------------------------------------------------------


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_sharded_checkpoint_loads_in_jax(kind, tmp_path):
    k = KINDS[kind]
    tt, tp, to = k.port(torch.float32, _tmesh((4, 2)))
    tp, to, _ = tt.train_step(tp, to, k.batch(0))
    tree = k.to_jax(tt, tt.gather(tp))
    if kind == "encoder":
        ttrain.save_params(tree, tt.cfg, tmp_path / "ckpt")
        loaded, cfg = jtrain.load_params(tmp_path / "ckpt")
    else:
        ttl.save_lm_params(tree, tt.cfg, tmp_path / "ckpt")
        loaded, cfg = jtl.load_lm_params(tmp_path / "ckpt")
    assert (cfg.hidden, cfg.layers, cfg.heads) == (64, 2, 4)
    got = dict(_leaves(jax.tree_util.tree_map(np.asarray, loaded)))
    want = dict(_leaves(tree))
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


# -- decoding from the sharded state ---------------------------------------------------


@pytest.mark.parametrize("shape", [(1, 2), (4, 2)], ids=["1x2", "4x2"])
def test_sharded_decode_tokens_equal_one_device(shape):
    params, cfg = ttl.load_lm_params(LM_FIXTURE, dtype=torch.float32)
    tt = ttl.LMTrainer(cfg, _tmesh(shape), device="cpu")
    tp, _ = tt.state_from(tdec.decoder_state_from_jax(params))
    sharded = tt.decoder(tp)
    assert isinstance(sharded, tdec.TPDecoder) and len(sharded.devices) == shape[1]
    one = tdec.build_decoder(tdec.decoder_state_to_jax(tt.gather(tp)), cfg, "cpu")
    prompts = [
        f"{tdec.QA_CONTEXT}def search(self, q):\n    return self.index.search(q)"
        f"{tdec.QA_QUESTION}what does search do?{tdec.QA_ANSWER}",
        f"{tdec.QA_CONTEXT}class FlatIndex:{tdec.QA_QUESTION}where is FlatIndex defined?"
        f"{tdec.QA_ANSWER}",
        "def add(a, b):\n    return a +",
    ]
    tok = ByteTokenizer()
    ids = np.zeros((len(prompts), 128), np.int64)
    mask = np.zeros_like(ids)
    for i, text in enumerate(prompts):
        row = tok.encode(text)[:128]
        ids[i, :len(row)] = row
        mask[i, :len(row)] = 1
    want = tdec.generate_tokens(one, ids, mask, max_new=24, graph=False)
    got = tdec.generate_tokens(sharded, ids, mask, max_new=24)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    # the teacher-forced logits of the sharded forward: the one-device ones
    with torch.no_grad():
        np.testing.assert_allclose(
            sharded(torch.from_numpy(ids), torch.from_numpy(mask)).numpy(),
            tdec.forward_logits(one, ids, mask).numpy(), rtol=0, atol=1e-4)
    assert cfg.heads == 2
    dp_only = ttl.LMTrainer(cfg, _tmesh((4,)), device="cpu")
    assert isinstance(dp_only.decoder(dp_only.state_from(tdec.decoder_state_from_jax(
        params))[0]), tdec.CodeDecoder)
