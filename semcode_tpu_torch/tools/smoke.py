"""End-to-end smoke of the PyTorch engine's CLI: ingest -> incremental
re-ingest (0 embedded) -> filtered query -> chunks listing -> compact ->
stats, in a fresh temporary workspace.

Counterpart of the JAX package's ``tools/smoke.py`` (``make smoke``). It
runs on CUDA unless ``SEMCODE_TORCH_DEVICE=cpu`` asks for the CPU:

    SEMCODE_TORCH_DEVICE=cpu python -m semcode_tpu_torch.tools.smoke

Run it from the repository root (it ingests ``semcode_tpu/index``), in a
fresh process: the workspace is chosen through ``SEMCODE_WORKSPACE_ROOT``
before the engine's settings load.
"""

from __future__ import annotations

import os
import sys
import tempfile

STEPS = [
    ["ingest", "--name", "self", "--include", "semcode_tpu/index",
     "--root", ".", "--yes"],
    ["ingest", "--name", "self", "--include", "semcode_tpu/index",
     "--root", ".", "--yes"],  # incremental: 0 embedded
    ["query", "lock-free device snapshot", "--repo", "self", "--top-k", "3"],
    ["chunks", "--repo", "self", "--limit", "5"],
    ["compact"],
    ["stats"],
]


def main() -> int:
    with tempfile.TemporaryDirectory(prefix="semcode_smoke_") as workspace:
        os.environ["SEMCODE_WORKSPACE_ROOT"] = workspace
        from ..cli import main as cli_main

        for args in STEPS:
            rc = cli_main(args)
            if rc != 0:
                print(f"SMOKE FAILED at {args[:2]} rc={rc}", file=sys.stderr)
                return rc
    print("SMOKE OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
