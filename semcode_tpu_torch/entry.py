"""Entry points for a compile check and a multi-device dry run.

Counterpart of the repository's ``__graft_entry__.py`` (the JAX package's):

- ``entry()``: the flagship forward step (the code encoder, ``mini`` at
  ``max_len`` 128, on (8, 128) ids and mask of ones) with example args;
- ``dryrun_multichip(n)``: one step of each sharded path on an ``n``-entry
  mesh: the DP x TP contrastive step, the data-sharded flat and IVF
  searches (a filtered search, the full probe against the exact scan, the
  batched dispatch), the DP x TP LM step with a KV-cache decode from the
  TP-sharded params, and the int8 IVF search on a two-level ``("dcn",
  "data")`` mesh, with the reference's shapes and assertions.

The meshes are ``parallel.mesh`` meshes of ``n`` entries of the visible
devices (CUDA unless asked for the CPU), repeated round-robin when fewer
than ``n`` are visible: the counterpart of XLA's forced host device count,
which the reference falls back to. One process runs every shard.

    python -m semcode_tpu_torch.entry            # DRYRUN_DEVICES, default 8
    SEMCODE_TORCH_DEVICE=cpu DRYRUN_DEVICES=4 python -m semcode_tpu_torch.entry
"""

from __future__ import annotations

import os
from typing import List

import numpy as np
import torch
from torch.func import functional_call

from .device import DeviceLike
from .parallel.mesh import local_devices, make_mesh


def entry(device: DeviceLike = None):
    """Return ``(fn, example_args)`` for the flagship forward step:
    ``fn(params, ids, mask)`` runs ``CodeEncoder`` on ``params`` (a
    ``state_dict``, cast to the module's dtypes per call as flax casts its
    float32 params) and gives (8, 384) unit embeddings; the params are the
    port's seeded init (``encoder.random_state``, seed 0)."""
    from .models.encoder import CodeEncoder, EncoderConfig, random_state

    dev = local_devices(device)[0]
    cfg = EncoderConfig.preset("mini", max_len=128)
    model = CodeEncoder(cfg).to(dev).requires_grad_(False)
    held = {k: v.dtype for k, v in model.named_parameters()}
    params = {k: v.to(dev) for k, v in random_state(cfg, 0).items()}
    ids = torch.ones((8, 128), dtype=torch.long, device=dev)
    mask = torch.ones((8, 128), dtype=torch.long, device=dev)

    def forward(params, ids, mask):
        cast = {k: v.to(device=dev, dtype=held[k]) for k, v in params.items()}
        return functional_call(model, cast, (ids.to(dev), mask.to(dev)))

    return forward, (params, ids, mask)


def mesh_devices(n_devices: int, device: DeviceLike = None) -> List[torch.device]:
    """``n_devices`` entries of the visible devices, round-robin."""
    devs = local_devices(device)
    return [devs[i % len(devs)] for i in range(n_devices)]


def dryrun_multichip(n_devices: int, device: DeviceLike = None) -> str:
    """Run one step of every sharded path on ``n_devices`` mesh entries
    (see the module docstring); prints the reference's summary line and
    returns it. Any failed check raises."""
    from .index.flat import FlatIndex
    from .index.ivf import IVFIndex
    from .models.decoder import DecoderConfig, generate_tokens
    from .models.encoder import EncoderConfig
    from .models.train import ContrastiveTrainer
    from .models.train_lm import LMTrainer

    devs = mesh_devices(n_devices, device)

    # ---- 1. DP x TP contrastive training step -------------------------------
    model_par = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    data_par = n_devices // model_par
    mesh2d = make_mesh((data_par, model_par), ("data", "model"), devices=devs)
    cfg = EncoderConfig.preset("mini", max_len=64)
    trainer = ContrastiveTrainer(cfg, mesh2d)
    params, opt_state = trainer.init_state(seed=0)
    rng = np.random.default_rng(0)
    batch_size = data_par * 4  # divisible by the data axis
    batch = {
        "anchor_ids": rng.integers(0, cfg.vocab_size, (batch_size, 64)).astype(np.int32),
        "anchor_mask": np.ones((batch_size, 64), dtype=np.int32),
        "pos_ids": rng.integers(0, cfg.vocab_size, (batch_size, 64)).astype(np.int32),
        "pos_mask": np.ones((batch_size, 64), dtype=np.int32),
    }
    params, opt_state, metrics = trainer.train_step(params, opt_state, batch)
    loss = float(metrics["loss"])
    _check(np.isfinite(loss), f"non-finite training loss: {loss}")
    del trainer, params, opt_state

    # ---- 2. data-sharded index search (flat + IVF) ---------------------------
    mesh1d = make_mesh((n_devices,), ("data",), devices=devs)
    d = 128
    x = rng.standard_normal((1024, d)).astype(np.float32)
    q = rng.standard_normal((8, d)).astype(np.float32)
    flat = FlatIndex(d, metric="ip", dtype="float32", mesh=mesh1d)
    tags = (np.arange(1024) % 4).astype(np.int32)
    flat.add(x, tags=tags)
    _, flat_ids = flat.search(q, k=5)
    _check((flat_ids[:, 0] >= 0).all(), "the sharded flat search found nothing")
    # the device-side filtered search masks correctly when sharded
    _, f_ids = flat.search(q, k=5, allow_tags=[2])
    _check((f_ids >= 0).all() and (tags[f_ids.ravel()] == 2).all(),
           "the sharded filtered search returned a row of another tag")
    ivf = IVFIndex(d, nlist=2 * n_devices, nprobe=2 * n_devices, metric="ip",
                   dtype="float32", mesh=mesh1d)
    ivf.add(x)
    _, ivf_ids = ivf.search(q, k=5)
    # the full probe agrees with the exact scan
    _check((ivf_ids[:, 0] == flat_ids[:, 0]).all(), "IVF disagrees with exact scan")
    # the batched dispatch agrees with per-batch search on the sharded mesh
    qs3 = torch.from_numpy(np.stack([q, q[::-1]])).to(mesh1d.home)
    _, bat_ids = ivf.search_device_batched(qs3, 5)
    _check((bat_ids[0, :, 0].cpu().numpy() == ivf_ids[:, 0]).all(),
           "batched dispatch disagrees with per-batch search")
    del flat, ivf

    # ---- 2b. DP x TP causal-LM training step + TP-sharded generation --------
    lm_cfg = DecoderConfig(vocab_size=258, hidden=64, layers=2, heads=2, mlp_dim=128,
                           max_len=64)
    lm_trainer = LMTrainer(lm_cfg, mesh2d)
    lm_params, lm_opt = lm_trainer.init_state(seed=0)
    lm_batch = {
        "ids": rng.integers(2, 258, (batch_size, 32)).astype(np.int32),
        "mask": np.ones((batch_size, 32), dtype=np.int32),
    }
    lm_params, lm_opt, lm_metrics = lm_trainer.train_step(lm_params, lm_opt, lm_batch)
    lm_loss = float(lm_metrics["loss"])
    _check(np.isfinite(lm_loss), f"non-finite LM loss: {lm_loss}")
    # KV-cache decode from the TP-sharded params: each model shard's cache
    # holds its own heads
    toks = generate_tokens(lm_trainer.decoder(lm_params), lm_batch["ids"][:4, :16],
                           lm_batch["mask"][:4, :16], max_new=4)
    _check(tuple(toks.shape) == (4, 4), f"decoded shape {tuple(toks.shape)}")
    del lm_trainer, lm_params, lm_opt

    # ---- 3. multi-host topology: 2-level (dcn, data) mesh --------------------
    # rows shard over hosts x devices; per-shard top-k merges the inner axis
    # first (int8 + fused f32 device rescore)
    if n_devices % 2 == 0 and n_devices >= 4:
        mesh2l = make_mesh((2, n_devices // 2), ("dcn", "data"), devices=devs)
        ivf2 = IVFIndex(d, nlist=2 * n_devices, nprobe=2 * n_devices, metric="ip",
                        dtype="int8", mesh=mesh2l)
        ivf2.add(x)
        _, ids2l = ivf2.search(q, k=5)
        _check((ids2l[:, 0] == flat_ids[:, 0]).all(),
               "2-level-mesh IVF disagrees with the exact scan")
    line = (
        f"dryrun_multichip ok: {n_devices} devices "
        f"(train mesh {data_par}x{model_par} dp x tp, encoder loss={loss:.4f},"
        f" lm loss={lm_loss:.4f} + sharded kv-cache decode; "
        f"index mesh {n_devices} shards; 2-level dcn x data mesh verified)"
    )
    print(line, flush=True)
    return line


def _check(ok, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


if __name__ == "__main__":
    dryrun_multichip(int(os.environ.get("DRYRUN_DEVICES", "8")))
