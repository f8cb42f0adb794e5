"""The model cells' path at a size a test run holds: a tiny decoder cell
run by the harness from files and entries alone, the plain reference
against the port's decoder, the judge against the controls and faults, the
traced slice's graph replays, and the counts by hand."""

import hashlib
import json
import math
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest
import torch

from perfbench import harness, model, model_readings, roofline, spec, trace
from perfbench.tests.tiny_model import CONFIG, LIMITS, TRAFFIC, WORKLOAD, make_root

# GPT-2 large's widths at two layers and a small vocabulary: at width 64 a
# random init's attention is near uniform, so a cache read one slot off
# barely moves the logits; at 1280 it does, as in the benchmark's cell
WIDE = {**CONFIG, "name": "wide-lm", "n_embd": 1280, "n_head": 20}
# the program's widest logit gap at WIDE is ~0.05 of the logits' std, the
# fp8 control's ~0.45 (CPU runs)
WIDE_LIMITS = {**LIMITS, "token_gap": 0.15, "logit_err": 0.15}


def digests(base):
    return {p.relative_to(base): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in base.rglob("*") if p.is_file() and "__pycache__" not in p.parts
            and "tests" not in p.relative_to(base).parts}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two threads a test process: the wide model's runs on every core of
    each worker would leave the tiny cell's window a call or two."""
    was = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(was)


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    return spec.load(WORKLOAD, make_root(tmp_path_factory.mktemp("model")))


@pytest.fixture(scope="module")
def wide(tmp_path_factory):
    root = make_root(tmp_path_factory.mktemp("wide"), config=WIDE, limits=WIDE_LIMITS)
    return spec.load(WORKLOAD, root)


def line_of(capsys, result):
    harness.print_result(result)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_a_model_cell_is_added_by_files_and_entries_alone(tmp_path, capsys):
    before = digests(spec.PACKAGE)
    root = make_root(tmp_path)
    after = digests(root / "perfbench")
    assert {p: after[p] for p in before} == before
    cell = spec.load(WORKLOAD, root)
    assert [m["name"] for m in cell.end_to_end] == ["tokens_per_s.answer", "p95_ms.answer",
                                                    "setup_s"]
    assert set(harness.checks_of(cell.traffic)) == set(cell.limits) == set(model.CHECKS)
    line = line_of(capsys, harness.run(cell, 2**31 + 3, 0.5, False, torch.device("cpu"),
                                       time.perf_counter()))
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] % TRAFFIC["batch"] == 0 and line["attempted"] > 0
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert set(line["checks"]) == set(model.CHECKS)


def test_a_traced_model_run_carries_the_trace_keys(cell, capsys):
    line = line_of(capsys, harness.run(cell, 9, 3.0, True, torch.device("cpu"),
                                       time.perf_counter()))
    assert list(line)[-2:] == ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(line["device"])
    # a CPU run traces no device operation, so no per-layer metric is read
    assert line["metrics"] == {}
    assert line["correct"] is True


def test_the_search_cells_take_their_own_path(tmp_path):
    from perfbench.tests.tiny import make_root as search_root

    cell = spec.load("tiny-serve8", search_root(tmp_path))
    via = harness.run(cell, 2**31 + 5, 0.3, False, torch.device("cpu"), time.perf_counter())
    direct = harness.run_cell(cell, 2**31 + 5, 0.3, False, torch.device("cpu"),
                              time.perf_counter())
    assert list(via) == list(direct)
    assert {k: c["limit"] for k, c in via["checks"].items()} == \
        {k: c["limit"] for k, c in direct["checks"].items()}
    assert set(via["metrics"]) == set(direct["metrics"])
    assert via["correct"] is direct["correct"] is True


def test_the_pool_is_one_set_of_lengths_in_a_seeded_order():
    a, b = model.make_pool(CONFIG, TRAFFIC, 1), model.make_pool(CONFIG, TRAFFIC, 2**40)
    assert sorted(a.lens) == sorted(b.lens) and list(a.lens) != list(b.lens)
    lo, hi = TRAFFIC["prompt_tokens"]
    assert a.lens.min() >= lo and a.lens.max() <= hi
    assert (a.mask.sum(1).numpy() == a.lens).all()
    assert (a.ids[a.mask == 0] == 0).all()
    assert torch.equal(model.make_pool(CONFIG, TRAFFIC, 1).ids, a.ids)


def test_weights_come_from_the_seed_in_their_served_dtypes(cell):
    reference = model.part(cell, "reference")
    specs = reference.weight_specs(CONFIG)
    w = model.make_weights(specs, CONFIG, 5, torch.device("cpu"))
    again = model.make_weights(specs, CONFIG, 5, torch.device("cpu"))
    assert list(w) == [name for name, *_ in specs]
    assert all(torch.equal(w[k], again[k]) for k in w)
    assert w["h.0.attn.c_attn.weight"].dtype == torch.bfloat16
    assert w["wte"].dtype == torch.float32
    assert abs(float(w["h.1.ln_2.weight"].float().mean()) - 1.0) < 0.01
    assert abs(float(w["wte"].std()) - 0.02) < 0.001


@pytest.mark.parametrize("dtype, tol", [("float32", 1e-4), ("bfloat16", 0.05)])
def test_the_reference_agrees_with_the_ports_decoder(cell, dtype, tol):
    """Teacher-forced logits of the port's ``CodeDecoder`` and of the plain
    reference on the same weights, a right-padded row among them: float32
    to rounding, bf16 within a few hundredths of the logits' std."""
    from semcode_tpu_torch.models.decoder import forward_logits

    cfg = {**CONFIG, "dtype": dtype}
    program, reference = model.part(cell, "program"), model.part(cell, "reference")
    w = model.make_weights(reference.weight_specs(cfg), cfg, 7, torch.device("cpu"))
    port = program.build(cfg, w, torch.device("cpu"))
    ids = torch.randint(0, cfg["vocab_size"], (2, 40), generator=torch.Generator().manual_seed(1))
    mask = torch.ones_like(ids)
    mask[1, 30:] = 0
    got = forward_logits(port, ids, mask)
    at = torch.stack([torch.arange(40), torch.arange(40)])
    want = reference.logits_at(w, cfg, ids, mask, at)
    live = mask.bool()
    err = (got[live] - want[live]).abs().max() / want[live].std()
    assert err < tol, float(err)


def test_the_benchmarks_build_is_the_ports_own(cell):
    """``gpt2_port.build`` (the module made on the meta device and assigned
    the weights) holds and computes what the port's ``build_decoder`` makes
    of the same weights: every state and buffer bit for bit, the same
    logits and the same greedy tokens."""
    from semcode_tpu_torch.models import decoder as dec

    program, reference = model.part(cell, "program"), model.part(cell, "reference")
    w = model.make_weights(reference.weight_specs(CONFIG), CONFIG, 13, torch.device("cpu"))
    mine = program.build(CONFIG, w, torch.device("cpu"))
    tree = dec.decoder_state_to_jax(program.state_of(w))
    port = dec.build_decoder(tree, program.decoder_config(CONFIG), "cpu")
    for name, want in [*port.state_dict().items(), *port.named_buffers()]:
        got = dict(mine.state_dict()).get(name, dict(mine.named_buffers()).get(name))
        assert got is not None and got.dtype == want.dtype and torch.equal(got, want), name
    assert set(mine.state_dict()) == set(port.state_dict())
    pool = model.make_pool(CONFIG, TRAFFIC, 13)
    ids, mask = pool.batch(0, TRAFFIC["batch"])
    assert torch.equal(dec.forward_logits(mine, ids, mask), dec.forward_logits(port, ids, mask))
    assert torch.equal(program.generate(mine, ids, mask, TRAFFIC["max_new"]),
                       program.generate(port, ids, mask, TRAFFIC["max_new"]))


def test_the_program_passes_and_the_fp8_control_fails(wide):
    """Every seed: the program's numbers pass, the fp8 control fails
    ``logit_err``; the TF32 control reads below the program's bf16, so it
    could not fail a limit that the program passes."""
    recs = list(model_readings.readings(wide, [3, 2**31 + 4], 0.3, torch.device("cpu")))
    for rec in recs:
        assert rec["program"]["passes"], rec
        assert not rec["controls"]["fp8"]["passes"], rec
        assert rec["controls"]["fp8"]["logit_err"] > 3 * rec["program"]["logit_err"]
        assert rec["controls"]["tf32"]["logit_err"] < rec["program"]["logit_err"]


@pytest.mark.parametrize("fault, number", [
    ("fp8_weights", "logit_err"), ("dropped_block", "logit_err"),
    ("cache_off_by_one", "logit_err"), ("unchanged_step", "token_gap"),
    ("half_batch", "token_gap"), ("altered_token", "token_gap")])
def test_a_broken_program_is_not_correct(wide, monkeypatch, fault, number):
    model_readings.FAULTS[fault](monkeypatch.setattr)
    result = harness.run(wide, 2**31 + 21, 0.3, False, torch.device("cpu"), time.perf_counter())
    assert result["correct"] is False
    assert result["checks"][number]["value"] > WIDE_LIMITS[number], result["checks"]


def test_a_malformed_or_raised_call_counts_failed_rows():
    win = harness.Window(2)
    win.batch_of = [0, 1, 0]
    win.answers = [torch.tensor([[1, 2, 3], [4, 5, 6]]), None,
                   torch.tensor([[1, 2, 300], [4, 5, 6]])]
    served = model.served_rows(win, 300, 3)
    assert served.failed == 3
    assert served.prompt.tolist() == [0, 1, 1]
    win.answers = [torch.zeros(2, 2, dtype=torch.long)] * 3
    assert model.served_rows(win, 300, 3).failed == 6


def test_the_eager_sample_is_drawn_from_the_seed():
    t = {**TRAFFIC, "pool": 64, "batch": 8, "eager_batches": 2}
    a = model.eager_sample(t, 11)
    assert a == model.eager_sample(t, 11) and len(set(a)) == 2
    assert all(0 <= b < 8 for b in a)
    assert len({tuple(model.eager_sample(t, s)) for s in range(20)}) > 1


# -- the traced slice and its readers -------------------------------------------


def kineto(name, start, end, device="CPU", corr=0, annotation=False):
    from torch.autograd import DeviceType

    return SimpleNamespace(name=lambda: name, start_ns=lambda: start * 1000,
                           end_ns=lambda: end * 1000,
                           device_type=lambda: getattr(DeviceType, device),
                           is_user_annotation=lambda: annotation,
                           correlation_id=lambda: corr)


def test_the_trace_ties_graph_replays_to_their_kernels():
    events = [kineto(trace.SPAN, 0, 100),
              kineto("aten::mm", 1, 5, corr=1), kineto("cudaLaunchKernel", 2, 3, corr=2),
              kineto("gemm", 6, 10, "CUDA", corr=2),
              kineto(trace.GRAPH_LAUNCH, 11, 12, corr=3),
              kineto("graph_gemm", 13, 20, "CUDA", corr=3),
              kineto("graph_add", 19, 25, "CUDA", corr=3),
              kineto(trace.GRAPH_LAUNCH, 26, 27, corr=4),
              kineto("graph_gemm", 30, 40, "CUDA", corr=4),
              kineto("annotation", 0, 50, "CUDA", annotation=True)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    t = trace.from_profile(prof, [0], 1e-4)
    assert t.graph_launches == 2
    assert len(t.device_ops) == 4 and len(t.spans) == 1
    assert t.graphed_s() == pytest.approx((12 + 10) / 1e6)
    assert t.busy_s() == pytest.approx((4 + 12 + 10) / 1e6)


def test_the_counts_by_hand():
    """GPT-2 at n_embd 4, 1 layer, 2 heads, vocab 10, MLP 16, one row of a
    3-token prompt and 2 new tokens, bf16 blocks and a float32 head."""
    cfg = {"n_embd": 4, "n_layer": 1, "n_head": 2, "vocab_size": 10, "n_positions": 8,
           "layer_norm_epsilon": 1e-5, "dtype": "bfloat16", "head_dtype": "float32"}
    ref = spec.load_file(spec.PACKAGE / "models" / "gpt2_reference.py", "ref_by_hand")
    blocks = 3 * 16 + 16 + 4 * 16 + 16 * 4  # c_attn, c_proj, c_fc, mlp c_proj
    assert ref.matrix_params(cfg) == (blocks, 40)
    # tokens processed: 3 + 2 - 1 = 4 at contexts 1..4; the head twice
    flops = 2 * blocks * 4 + 2 * 40 * 2 + 4 * 4 * (1 + 2 + 3 + 4)
    assert ref.call_flops(cfg, [3], 2) == flops
    # weights as served: bf16 kernels and biases, f32 LayerNorms, tied head
    held = 2 * (blocks + 12 + 4 + 16 + 4) + 4 * (4 * 4 + 2 * 4) + 4 * 40
    assert ref.weight_bytes(cfg) == held
    # step 1: two embedding rows in bf16; K and V of 3 + 1 live slots
    assert ref.decode_step_bytes(cfg, [3], 1) == held + 2 * 4 * 2 + 2 * 1 * 4 * 2 * 4


def test_the_readers_divide_the_counts_by_the_trace(cell):
    reference = model.part(cell, "reference")
    lens = [[110, 120, 100, 128]] * 3
    max_new = TRAFFIC["max_new"]
    trace = SimpleNamespace(device_ops=[(0, 1, "k")], wall_s=2.0, graph_launches=3 * (max_new - 1),
                            graphed_s=lambda: 0.5)
    ctx = model.ReadContext(trace, cell, lens, reference)
    flops = 3 * reference.call_flops(CONFIG, lens[0], max_new)
    assert model.mfu(ctx) == pytest.approx(100 * flops / (2.0 * roofline.BF16_FLOPS_PER_S))
    need = 3 * sum(reference.decode_step_bytes(CONFIG, lens[0], i) for i in range(1, max_new))
    assert model.decode_roofline(ctx) == pytest.approx(100 * need / roofline.HBM_BYTES_PER_S / 0.5)
    trace.graph_launches -= 1  # a step that was not one replay: nothing to read
    assert model.decode_roofline(ctx) is None
    assert math.isfinite(model.mfu(ctx))


def test_a_fresh_process_running_a_model_cell_loads_no_jax(tmp_path):
    code = (
        "import json, sys, time\n"
        "t0 = time.perf_counter()\n"
        "import torch\n"
        "from pathlib import Path\n"
        "from perfbench import harness, spec\n"
        "from perfbench.tests.tiny_model import WORKLOAD, make_root\n"
        f"root = make_root(Path({str(tmp_path)!r}))\n"
        "r = harness.run(spec.load(WORKLOAD, root), 7, 0.5, False, torch.device('cpu'), t0)\n"
        "print(json.dumps({'correct': r['correct'], 'found': harness.forbidden_modules(),"
        " 'port': 'semcode_tpu_torch' in sys.modules}))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(spec.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=str(tmp_path), timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last == {"correct": True, "found": [], "port": True}
