"""A tiny model cell for the harness's CPU tests: a GPT-2 of a few small
layers, its mix and limits written into a copy of the benchmark as new
files and entries, so that nothing in the repository is edited."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from perfbench import spec

CONFIG = {
    "name": "tiny-lm", "source": "test", "n_embd": 64, "n_layer": 2, "n_head": 4,
    "n_positions": 160, "vocab_size": 300, "layer_norm_epsilon": 1e-5,
    "dtype": "bfloat16", "head_dtype": "float32",
    "program": "perfbench/models/gpt2_port.py",
    "reference": "perfbench/models/gpt2_reference.py", "reduced": [],
}
TRAFFIC = {"name": "tiny-answer4", "call": "generate_tokens", "loop": "closed",
           "clients": 1, "batch": 4, "prompt_tokens": [100, 128], "bucket": 128,
           "max_new": 12, "pool": 8, "trace_calls": 3, "eager_batches": 1}
# bf16 at two layers of width 64 lies a few hundredths of the logits' std
# from the float32 reference
LIMITS = {"failed": 0, "token_gap": 0.25, "logit_err": 0.25, "graph_mismatch": 0}
WORKLOAD = "tiny-answer4"
METRICS = ("tokens_per_s.answer", "p95_ms.answer", "setup_s", "mfu.answer",
           "decode_roofline.answer", "idle_share.answer")


def make_root(tmp: Path, config: dict = CONFIG, traffic: dict = TRAFFIC,
              limits: dict = LIMITS) -> Path:
    """A copy of BENCHMARK.json and perfbench/ under ``tmp`` with the tiny
    model configuration, its mix and the cell WORKLOAD added as new files and
    entries; the cell reports the model cells' metrics."""
    root = tmp / "bench"
    shutil.copytree(spec.PACKAGE, root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": config["name"], "source": "test",
                             "file": f"perfbench/configs/{config['name']}.json",
                             "reduced": [], "why": "CPU tests"})
    bench["workloads"].append({"name": WORKLOAD, "config": config["name"],
                               "traffic": traffic["name"], "chips": 1, "why": "CPU tests"})
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            if m["name"] in METRICS and "workloads" in m:
                m["workloads"].append(WORKLOAD)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "perfbench" / "configs" / f"{config['name']}.json").write_text(json.dumps(config))
    (root / "perfbench" / "traffic" / f"{traffic['name']}.json").write_text(json.dumps(traffic))
    (root / "perfbench" / "limits" / f"{WORKLOAD}.json").write_text(
        json.dumps({"limits": limits}))
    return root
