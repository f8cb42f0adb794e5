"""The benchmark of the PyTorch and CUDA port (``semcode_tpu_torch``).

Run one cell once with ``python -m perfbench --workload <name> --seed <n>
--seconds <s> --trace <0|1>``; ``harness.py`` says what a run does and
``spec.py`` how a cell's files are found. Nothing here imports JAX or the
JAX package.
"""
