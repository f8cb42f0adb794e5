"""The readings that a model cell's limits are set from: the program's
numbers and the controls', seed by seed.

    python -m perfbench.model_readings --workload gpt2l-answer1 \\
        --seeds 11,12,13 --seconds 8 [--fault cache_off_by_one]

For each seed the model is built and warmed, a window runs at the cell's
own load, and the run's check follows (``model.judge``). The controls are
the reference put in the program's place, judged by the same numbers at
every position of the same prompts and served tokens (the gap of the token
each puts first, and its widest distance from the reference):

- ``fp8``: every block product's operands rounded through
  ``float8_e4m3fn`` (the kernel with one scale, each activation row with
  its own), the step below the bf16 the configuration states;
- ``tf32``: every product's operands rounded to TF32, which the issue of
  this cell asked for: finer than bf16, so it is read, not held.

One JSON line a seed, with whether the program's numbers and each control's
pass the cell's limits. The benchmark's own runs never run the controls.

``--fault`` plants a fault in the program before it is built (FAULTS), so
the ``program`` readings are a broken program's.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from . import harness, model, reference as search_reference, spec

E4M3_MAX = 448.0


def e4m3(x: torch.Tensor, dim=None) -> torch.Tensor:
    """``x`` rounded through ``float8_e4m3fn`` with its largest magnitude
    (over ``dim``, or the whole tensor) scaled to the format's largest."""
    x = x.float()
    amax = x.abs().amax() if dim is None else x.abs().amax(dim=dim, keepdim=True)
    scale = amax.clamp(min=1e-30) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def fp8_operands(kind: str, a: torch.Tensor, b: torch.Tensor):
    if kind != "linear":
        return a, b
    return e4m3(a, dim=-1), e4m3(b)


def tf32_operands(kind: str, a: torch.Tensor, b: torch.Tensor):
    return search_reference.tf32(a.contiguous()), search_reference.tf32(b.contiguous())


CONTROLS = {"fp8": fp8_operands, "tf32": tf32_operands}


# -- faults planted in the program (the port's decoder module) ----------------


def _decoder():
    from semcode_tpu_torch.models import decoder

    return decoder


def _after_load(setattr_, change) -> None:
    """Apply ``change(model)`` to every decoder right after its weights load."""
    dec = _decoder()
    load = dec.CodeDecoder.load_state_dict

    def loaded(self, *args, **kwargs):
        out = load(self, *args, **kwargs)
        with torch.no_grad():
            change(self)
        return out

    setattr_(dec.CodeDecoder, "load_state_dict", loaded)


def fp8_weights(setattr_=setattr) -> None:
    """A precision fault: every block kernel rounded through float8_e4m3fn
    (one scale a kernel) where the configuration states bf16."""
    def change(m):
        for block in m.blocks:
            for dense in (block.c_attn, block.c_proj, block.c_fc, block.mlp_proj):
                dense.kernel.copy_(e4m3(dense.kernel).to(dense.kernel.dtype))

    _after_load(setattr_, change)


def dropped_block(setattr_=setattr) -> None:
    """A block left out: the middle one, in the prefill and every step."""
    def change(m):
        blocks = list(m.blocks)
        del blocks[len(blocks) // 2]
        m.blocks = torch.nn.ModuleList(blocks)

    _after_load(setattr_, change)


def cache_off_by_one(setattr_=setattr) -> None:
    """A cache fault: each decode step reads the cached keys one slot off
    their values (slot j's key is slot j - 1's). Shifting keys and values
    together moves whole pairs, and under a random init's soft attention
    only the few pairs at the ends change (PERF.md)."""
    dec = _decoder()

    def step(m, st, sample=dec._greedy):
        st.slot_mask.index_fill_(1, st.write, True)
        x = m.embed(st.tok, st.pos)[:, None]
        keep = st.slot_mask[:, None, None, :]
        for li, block in enumerate(m.blocks):
            q, k, v = block.qkv(x)
            kc, vc = st.k[li], st.v[li]
            kc.index_copy_(2, st.write, k)
            vc.index_copy_(2, st.write, v)
            x = block.attend(x, q, kc.roll(1, 2), vc, keep)
        nxt = sample(m.logits(x)[:, 0])
        st.out.index_copy_(1, st.col, nxt[:, None])
        st.tok.copy_(nxt)
        st.pos.add_(1)
        st.write.add_(1)
        st.col.add_(1)

    setattr_(dec, "decode_step", step)


def unchanged_step(setattr_=setattr) -> None:
    """A decode step that returns its state unchanged (CPU tests: a graph
    of it captures nothing)."""
    setattr_(_decoder(), "decode_step", lambda m, st, sample=None: None)


def _around_generate(setattr_, change) -> None:
    dec = _decoder()
    generate = dec.generate_tokens

    def changed(m, ids, mask, **kwargs):
        return change(generate, m, ids, mask, kwargs)

    setattr_(dec, "generate_tokens", changed)


def half_batch(setattr_=setattr) -> None:
    """Half of the batch left out: the first half generated, its tokens
    served for the second half too."""
    def change(generate, m, ids, mask, kwargs):
        h = ids.shape[0] // 2
        out = generate(m, ids[:h], mask[:h], **kwargs)
        return torch.cat([out, out])[: ids.shape[0]]

    _around_generate(setattr_, change)


def altered_token(setattr_=setattr) -> None:
    """A token altered where it is produced: each row's last served token
    replaced by the next id."""
    def change(generate, m, ids, mask, kwargs):
        out = generate(m, ids, mask, **kwargs).clone()
        out[:, -1] = (out[:, -1] + 1) % m.cfg.vocab_size
        return out

    _around_generate(setattr_, change)


FAULTS = {f.__name__: f for f in (fp8_weights, dropped_block, cache_off_by_one,
                                   unchanged_step, half_batch, altered_token)}


def passes(numbers: dict, limits: dict) -> bool:
    return all(name in limits and value <= limits[name] for name, value in numbers.items())


def readings(cell: spec.Cell, seeds, seconds: float, device: torch.device,
             controls: bool = True):
    """Yield one record a seed: the window's calls and rates, the
    program's numbers and, with ``controls``, each control's."""
    traffic = cell.traffic
    program, reference = model.part(cell, "program"), model.part(cell, "reference")
    for seed in seeds:
        t0 = time.perf_counter()
        setup = model.build(cell, program, reference, seed, device)
        call = model.call_of(program, setup.model, traffic)
        for i in range(model.WARM_CALLS):
            call(setup.batches[i % len(setup.batches)])
        harness.sync(device)
        win = model.run_window(setup, call, traffic, seconds, False, device)
        eager = model.eager_run(program, setup, traffic, model.eager_sample(traffic, seed))
        pool = setup.pool
        del setup, call
        model.free(device)
        judged = model.judge(cell, reference, seed, win, pool, eager, device,
                             CONTROLS if controls else None)
        del eager
        model.free(device)
        e2e = model.e2e_values(win, traffic, 0.0)
        del e2e["setup_s"]
        numbers = judged["numbers"]
        yield {"seed": seed, "workload": cell.name, "calls": len(win.batch_of),
               "rows": judged["rows"], "sequences": judged["sequences"], "e2e": e2e,
               "program": {**numbers, "passes": passes(numbers, cell.limits)},
               "controls": {name: {**c, "passes": passes(c, cell.limits)}
                            for name, c in judged["controls"].items()},
               "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m perfbench.model_readings")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--fault", choices=sorted(FAULTS))
    args = p.parse_args(argv)
    if args.fault:
        FAULTS[args.fault]()
    cell = spec.load(args.workload)
    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    seeds = [int(s) for s in args.seeds.split(",")]
    for rec in readings(cell, seeds, args.seconds, device, controls=not args.fault):
        rec["fault"] = args.fault
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
