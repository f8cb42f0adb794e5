"""One run of a model cell: a mix whose ``"call"`` is ``generate_tokens``.

The configuration names two files of its own (``"program"``, ``"reference"``,
paths from the checkout's root), each loaded the way a metric's reader is:

- the program: ``build(cfg, weights, device)`` makes the port's model on the
  card from the benchmark's weights; ``generate(model, ids, mask, max_new)``
  is the timed call; ``eager(...)`` the same path untimed, returning the
  tokens and the logits each was chosen from; ``bucket(cfg, n, max_new)``
  the prompt bucket the provider pads ``n`` tokens to;
- the plain reference: ``weight_specs(cfg)`` (every weight's name, shape,
  served dtype and draw), ``logits_at(w, cfg, ids, mask, at)``, and the work
  a call needs, ``call_flops`` and ``decode_step_bytes``, from the
  configuration and the mix alone.

Set-up draws the weights on the card from ``--seed`` (one ``normal_`` a
group of like draws, in the dtypes they are served in), builds the model,
makes the prompt pool and warms the mix's one shape: batch, bucket and
``max_new`` (the first call captures the decode graph). The window drives
``generate`` in a closed loop, as ``harness.client_loop`` drives a search;
a call ends when its tokens are on the host. With ``--trace 1`` the
profiler holds ``trace_calls`` whole calls from a third into the window.

After the window (the device's peak read) the program runs the prompts of
``eager_batches`` pool batches, drawn from the seed, once more through its
eager path (at the timed batch, bucket and ``max_new``); then it is freed,
the weights are drawn again from the seed, and the reference runs teacher
forced over each prompt with the tokens served for it. The numbers
(``CHECKS``), each held to ``limits/<workload>.json``:

- ``failed``: rows of calls that raised, and rows that are not
  ``max_new`` ids in ``[0, vocab)``;
- ``token_gap``: over every served token of the window, the reference's top
  logit less its logit for the served token, over the standard deviation of
  the reference's logits at that position (a bf16 greedy decode may take a
  near-tie, nothing further);
- ``logit_err``: the eager path's logits against the reference's at the
  same positions, the widest gap over that standard deviation;
- ``graph_mismatch``: served rows of those batches whose tokens differ from
  the eager path's for the same prompt (the graph replays the eager step bit
  for bit).
"""

from __future__ import annotations

import gc
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import harness, roofline, spec
from .trace import Trace

CHECKS = ("failed", "token_gap", "logit_err", "graph_mismatch")
# a gap with nothing to read (no served row, an eager path that kept too
# few steps): larger than any limit, and still a number in the line
NO_READING = 1e9
WARM_CALLS = 3
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}
# streams keyed off one run seed
STREAMS = {"weights": 0, "prompts": 1, "sample": 2}


def checks_of(traffic: dict) -> tuple:
    return CHECKS


def derive(seed: int, stream: str) -> int:
    """A 63-bit seed for ``stream`` of run ``seed`` (any whole number)."""
    ss = np.random.SeedSequence([abs(int(seed)) % (1 << 128), int(seed) < 0, 100,
                                 STREAMS[stream]])
    return int(ss.generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))


def part(cell: spec.Cell, key: str):
    """The module of the configuration's file ``key`` (``program`` or
    ``reference``)."""
    path = cell.root / cell.config[key]
    return spec.load_file(path, f"perfbench_{key}_{path.stem}")


def make_weights(specs, cfg: dict, seed: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """Every weight of ``specs`` drawn from ``seed`` on ``device``: one
    ``normal_`` for each group of like draws (dtype, mean, std), each weight
    a view of its group's buffer, in the order of ``specs``."""
    gen = torch.Generator(device=device).manual_seed(derive(seed, "weights"))
    groups: Dict[tuple, list] = {}
    for name, shape, key, mean, std in specs:
        groups.setdefault((cfg[key], mean, std), []).append((name, shape))
    out = {}
    for (dtype, mean, std), members in groups.items():
        sizes = [int(np.prod(shape)) for _, shape in members]
        flat = torch.empty(sum(sizes), dtype=DTYPES[dtype], device=device)
        flat.normal_(mean, std, generator=gen)
        for (name, shape), piece in zip(members, flat.split(sizes)):
            out[name] = piece.view(shape)
    return {name: out[name] for name, *_ in specs}


@dataclass
class Pool:
    """The prompts: right-padded ids and masks (N, bucket) on the host, and
    each prompt's real length."""

    ids: torch.Tensor
    mask: torch.Tensor
    lens: np.ndarray

    def batch(self, b: int, size: int) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.ids[b * size:(b + 1) * size], self.mask[b * size:(b + 1) * size]


def make_pool(cfg: dict, traffic: dict, seed: int) -> Pool:
    """``pool`` prompts of ids uniform over the vocabulary. Their lengths are
    one fixed set, spread evenly over ``prompt_tokens`` [lo, hi], in an order
    drawn from the seed, so every seed asks for the same work."""
    n, (lo, hi) = int(traffic["pool"]), traffic["prompt_tokens"]
    bucket = int(traffic["bucket"])
    rng = np.random.default_rng(derive(seed, "prompts"))
    lens = lo + ((hi - lo) * (2 * np.arange(n) + 1)) // (2 * n)
    lens = rng.permutation(lens).astype(np.int64)
    ids = torch.from_numpy(rng.integers(0, int(cfg["vocab_size"]), (n, bucket)))
    pos = torch.arange(bucket)[None, :]
    mask = (pos < torch.from_numpy(lens)[:, None]).long()
    return Pool(ids * mask, mask, lens)


# -- one run -----------------------------------------------------------------


@dataclass
class Setup:
    model: object
    pool: Pool
    batches: list


def build(cell: spec.Cell, program, reference, seed: int, device: torch.device) -> Setup:
    cfg, traffic = cell.config, cell.traffic
    t0 = time.perf_counter()
    weights = make_weights(reference.weight_specs(cfg), cfg, seed, device)
    model = program.build(cfg, weights, device)
    del weights
    harness.sync(device)
    pool = make_pool(cfg, traffic, seed)
    b, max_new = int(traffic["batch"]), int(traffic["max_new"])
    want = program.bucket(cfg, int(pool.lens.max()), max_new)
    if want != int(traffic["bucket"]):
        raise ValueError(f"the provider pads these prompts to {want}; the mix "
                         f"states {traffic['bucket']}")
    batches = [pool.batch(i, b) for i in range(len(pool.lens) // b)]
    harness.log(f"weights and model ({sum(p.numel() for p in model.parameters())} "
                f"parameters) and a pool of {len(pool.lens)} prompts in "
                f"{time.perf_counter() - t0:.3f} s")
    return Setup(model, pool, batches)


def call_of(program, model, traffic: dict):
    max_new = int(traffic["max_new"])

    def call(batch):
        return program.generate(model, batch[0], batch[1], max_new).cpu()

    return call


def run_window(setup: Setup, call, traffic: dict, seconds: float, trace: bool,
               device: torch.device) -> harness.Window:
    """One closed-loop client for ``seconds`` (the mix's ``clients`` is 1)."""
    win = harness.Window(int(traffic["batch"]))
    t_start = time.perf_counter()
    tracer = (harness.Tracer(t_start, seconds, device, slice_s=0.0,
                             min_calls=int(traffic["trace_calls"]))
              if trace else None)
    harness.client_loop(call, setup.batches, 0, 1, t_start + seconds, win, tracer)
    harness.sync(device)
    win.seconds = time.perf_counter() - t_start
    if tracer is not None:
        win.trace = tracer.finish()
    return win


def eager_sample(traffic: dict, seed: int) -> List[int]:
    """The pool batches the eager path runs: ``eager_batches`` of them,
    drawn from the seed."""
    n = int(traffic["pool"]) // int(traffic["batch"])
    rng = np.random.default_rng(derive(seed, "sample"))
    return sorted(int(b) for b in rng.choice(n, int(traffic["eager_batches"]), replace=False))


def eager_run(program, setup: Setup, traffic: dict, batches: List[int]) -> dict:
    """The eager path over pool batches ``batches``: for each, its tokens
    (B, max_new) on the host and its logits on the device (None where the
    path kept fewer than ``max_new`` steps)."""
    max_new = int(traffic["max_new"])
    out = {}
    for b in batches:
        ids, mask = setup.batches[b]
        tok, lg = program.eager(setup.model, ids, mask, max_new)
        out[b] = (tok.cpu().numpy(), lg if lg.shape[1] == max_new else None)
    return out


# -- the check ---------------------------------------------------------------


@dataclass
class Served:
    """The window's rows: well-formed ones by prompt, and the count of the
    others."""

    prompt: np.ndarray   # (R,) pool index of each well-formed row
    tokens: np.ndarray   # (R, max_new)
    failed: int


def served_rows(win: harness.Window, vocab: int, max_new: int) -> Served:
    prompt, tokens, failed = [], [], 0
    for b, out in zip(win.batch_of, win.answers):
        if out is None:
            failed += win.batch
            continue
        t = out.numpy()
        if t.shape != (win.batch, max_new) or not np.issubdtype(t.dtype, np.integer):
            failed += win.batch
            continue
        ok = ((t >= 0) & (t < vocab)).all(axis=1)
        failed += int((~ok).sum())
        prompt.append(np.arange(b * win.batch, (b + 1) * win.batch)[ok])
        tokens.append(t[ok].astype(np.int64))
    if not prompt:
        return Served(np.zeros(0, np.int64), np.zeros((0, max_new), np.int64), failed)
    return Served(np.concatenate(prompt), np.concatenate(tokens), failed)


@dataclass
class Sequences:
    """Distinct (prompt, tokens) pairs, teacher-forced: ``ids`` and ``mask``
    (S, T) right-padded on the device, ``at`` (S, max_new) the positions
    whose logits chose each token, ``tokens`` (S, max_new); for each, the
    pool index of the eager row that served these tokens (-1 for none), and
    whether the window served them."""

    ids: torch.Tensor
    mask: torch.Tensor
    at: torch.Tensor
    tokens: torch.Tensor
    eager_of: np.ndarray
    served: np.ndarray


def sequences(pool: Pool, served: Served, eager: dict, batch: int,
              device: torch.device) -> Sequences:
    found: Dict[tuple, int] = {}
    keys, eager_of, is_served = [], [], []
    for b, (tokens, _) in sorted(eager.items()):
        for r, t in enumerate(tokens):
            found[(b * batch + r, t.tobytes())] = len(keys)
            keys.append((b * batch + r, t))
            eager_of.append(b * batch + r)
            is_served.append(False)
    for i, t in zip(served.prompt, served.tokens):
        k = (int(i), t.tobytes())
        if k in found:
            is_served[found[k]] = True
            continue
        found[k] = len(keys)
        keys.append((int(i), t))
        eager_of.append(-1)
        is_served.append(True)
    max_new = keys[0][1].shape[0]
    lens = pool.lens[[i for i, _ in keys]]
    width = int(lens.max()) + max_new
    ids = np.zeros((len(keys), width), np.int64)
    mask = np.zeros_like(ids)
    for r, ((i, t), n) in enumerate(zip(keys, lens)):
        ids[r, :n] = pool.ids[i, :n].numpy()
        ids[r, n:n + max_new] = t
        mask[r, :n + max_new] = 1
    at = lens[:, None] - 1 + np.arange(max_new)[None, :]

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return Sequences(dev(ids), dev(mask), dev(at), dev(np.stack([t for _, t in keys])),
                     np.asarray(eager_of), np.asarray(is_served))


def compare(reference, w, cfg: dict, seqs: Sequences, eager: dict, batch: int,
            controls: Optional[dict] = None, rows: int = 8) -> dict:
    """``token_gap`` over the served sequences and ``logit_err`` over the
    eager path's, each over the standard deviation of the reference's logits
    at the position; with ``controls`` (name -> ``operands`` of the reference,
    the control in the program's place), the same two numbers of each
    control's logits over every sequence: the gap of the token it puts first,
    and its widest distance from the reference."""
    gap, err = 0.0, 0.0
    ctl = {name: {"token_gap": 0.0, "logit_err": 0.0} for name in controls or {}}
    for lo in range(0, seqs.ids.shape[0], rows):
        hi = min(lo + rows, seqs.ids.shape[0])
        sl = slice(lo, hi)
        ref = reference.logits_at(w, cfg, seqs.ids[sl], seqs.mask[sl], seqs.at[sl])
        std = ref.std(dim=-1)
        top = ref.max(dim=-1).values

        def gap_of(tok):
            return (top - ref.gather(-1, tok[..., None])[..., 0]) / std

        served = torch.from_numpy(seqs.served[sl]).to(ref.device)
        if served.any():
            gap = max(gap, float(gap_of(seqs.tokens[sl])[served].max()))
        for r, i in enumerate(seqs.eager_of[sl]):
            if i < 0:
                continue
            got = eager[int(i) // batch][1]
            if got is None:
                err = NO_READING
                continue
            err = max(err, float(((got[i % batch] - ref[r]).abs().amax(dim=-1) / std[r]).max()))
        for name, operands in (controls or {}).items():
            c = reference.logits_at(w, cfg, seqs.ids[sl], seqs.mask[sl], seqs.at[sl],
                                    operands=operands)
            ctl[name]["token_gap"] = max(ctl[name]["token_gap"],
                                         float(gap_of(c.argmax(dim=-1)).max()))
            ctl[name]["logit_err"] = max(ctl[name]["logit_err"],
                                         float(((c - ref).abs().amax(dim=-1) / std).max()))
            del c
        del ref
    return {"token_gap": gap, "logit_err": err, "controls": ctl}


def judge(cell: spec.Cell, reference, seed: int, win: harness.Window, pool: Pool,
          eager: dict, device: torch.device, controls: Optional[dict] = None) -> dict:
    """The numbers of ``CHECKS`` (and of each control), with the program
    already freed: the weights are drawn again from the seed for the
    reference."""
    cfg, traffic = cell.config, cell.traffic
    max_new, batch = int(traffic["max_new"]), int(traffic["batch"])
    served = served_rows(win, int(cfg["vocab_size"]), max_new)
    mismatch = 0
    for i, t in zip(served.prompt, served.tokens):
        if i // batch in eager:
            mismatch += int((t != eager[i // batch][0][i % batch]).any())
    w = make_weights(reference.weight_specs(cfg), cfg, seed, device)
    seqs = sequences(pool, served, eager, batch, device)
    got = compare(reference, w, cfg, seqs, eager, batch, controls)
    numbers = {"failed": served.failed,
               "token_gap": got["token_gap"] if len(served.prompt) else NO_READING,
               "logit_err": got["logit_err"], "graph_mismatch": mismatch}
    return {"numbers": numbers, "controls": got["controls"], "rows": len(served.prompt),
            "sequences": int(seqs.ids.shape[0])}


# -- metrics -----------------------------------------------------------------


@dataclass
class ReadContext:
    """What a model cell's per-layer reader may read: the traced slice, the
    cell, each traced call's real prompt lengths, the reference's module
    (the work a call needs) and the peaks."""

    trace: Trace
    cell: spec.Cell
    lens: List[List[int]]
    counts: object
    roofline: object = roofline


def traced_lens(win: harness.Window, pool: Pool) -> List[List[int]]:
    if win.trace is None:
        return []
    b = win.batch
    return [[int(n) for n in pool.lens[win.batch_of[c] * b:(win.batch_of[c] + 1) * b]]
            for c in win.trace.calls]


def mfu(ctx: ReadContext) -> Optional[float]:
    """The traced calls' model operations (``call_flops``) over the slice's
    wall seconds times the card's dense bf16 peak, in percent."""
    if not ctx.trace.device_ops or ctx.trace.wall_s <= 0 or not ctx.lens:
        return None
    cfg, max_new = ctx.cell.config, int(ctx.cell.traffic["max_new"])
    flops = sum(ctx.counts.call_flops(cfg, lens, max_new) for lens in ctx.lens)
    return 100.0 * flops / (ctx.trace.wall_s * ctx.roofline.BF16_FLOPS_PER_S)


def decode_roofline(ctx: ReadContext) -> Optional[float]:
    """The least time of the traced calls' decode steps (the bytes each
    must read, ``decode_step_bytes``, at the card's bandwidth) over the
    device-busy time of the graph replays' operations, in percent; None
    unless every decode step of every traced call was one replay."""
    max_new = int(ctx.cell.traffic["max_new"])
    spent = ctx.trace.graphed_s()
    if spent <= 0 or not ctx.lens or ctx.trace.graph_launches != len(ctx.lens) * (max_new - 1):
        return None
    cfg = ctx.cell.config
    need = sum(ctx.counts.decode_step_bytes(cfg, lens, i)
               for lens in ctx.lens for i in range(1, max_new))
    return 100.0 * need / ctx.roofline.HBM_BYTES_PER_S / spent


def e2e_values(win: harness.Window, traffic: dict, setup_s: float) -> dict:
    done = sum(1 for a in win.answers if a is not None)
    return {"tokens_per_s": done * win.batch * int(traffic["max_new"]) / win.seconds,
            "p95_ms": float(np.percentile(np.asarray(win.latency_s), 95) * 1e3),
            "setup_s": setup_s}


def free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device: torch.device, t0: float) -> dict:
    """One run of a model cell; returns the result object, as
    ``harness.run_cell`` does for a search cell."""
    traffic = cell.traffic
    program, reference = part(cell, "program"), part(cell, "reference")
    setup = build(cell, program, reference, seed, device)
    call = call_of(program, setup.model, traffic)
    t_warm = time.perf_counter()
    for i in range(WARM_CALLS):
        call(setup.batches[i % len(setup.batches)])
    harness.sync(device)
    if trace:
        harness.Tracer.prime(device)
    setup_s = time.perf_counter() - t0
    harness.log(f"set-up {setup_s:.3f} s (warm-up {time.perf_counter() - t_warm:.3f} s); "
                f"window of {seconds} s")
    win = run_window(setup, call, traffic, seconds, trace, device)
    lat = np.asarray(win.latency_s)
    harness.log(f"window: {len(win.batch_of)} calls in {win.seconds:.3f} s; ms a call: "
                f"median {1e3 * float(np.median(lat)):.3f}, max {1e3 * float(lat.max()):.3f}")
    dev = harness.device_info(device, cell.chips)
    t_ref = time.perf_counter()
    eager = eager_run(program, setup, traffic, eager_sample(traffic, seed))
    harness.log(f"eager path over batches {sorted(eager)} in "
                f"{time.perf_counter() - t_ref:.3f} s")
    pool = setup.pool
    del setup, call
    free(device)
    judged = judge(cell, reference, seed, win, pool, eager, device)
    del eager
    free(device)
    harness.log(f"eager path, reference and check in {time.perf_counter() - t_ref:.3f} s: "
                f"{judged['rows']} served rows, {judged['sequences']} sequences")
    for err in sorted(set(win.errors))[:5]:
        harness.log(f"a call raised: {err}")
    numbers = judged["numbers"]
    result = {"correct": False, "attempted": len(win.batch_of) * win.batch,
              "failed": numbers["failed"]}
    if trace:
        metrics = {}
        if win.trace is not None:
            ctx = ReadContext(win.trace, cell, traced_lens(win, pool), reference)
            for m in cell.per_layer:
                value = cell.reader(m["name"])(ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            dev["busy_s"] = win.trace.busy_s()
            dev["window_s"] = win.trace.wall_s
            harness.log(f"traced calls {win.trace.calls}: {win.trace.graph_launches} graph "
                        f"launches, {len(win.trace.graphed)} of {len(win.trace.device_ops)} "
                        f"device operations graphed")
    else:
        values = e2e_values(win, traffic, setup_s)
        metrics = {m["name"]: {"value": values[m["name"].split(".")[0]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    result["metrics"] = metrics
    result["device"] = dev
    if trace and win.trace is not None:
        result["breakdown"] = win.trace.breakdown()
    checks = {name: {"value": numbers[name], "limit": cell.limits.get(name)}
              for name in CHECKS}
    result["correct"] = all(c["limit"] is not None and c["value"] <= c["limit"]
                            for c in checks.values()) and result["attempted"] > 0
    result["checks"] = checks
    return result
