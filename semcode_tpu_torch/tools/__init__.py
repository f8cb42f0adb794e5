"""Kernel-measurement tools, one module each, run as

    python -m semcode_tpu_torch.tools.<name> [arguments]

Counterparts of the JAX package's ``tools/dot_pallas.py``, ``dot_rate.py``,
``scan_ab.py``, ``scan_profile.py`` and ``scan_tune.py``: the same
environment variables and arguments, one JSON line per configuration. They
run on CUDA unless ``SEMCODE_TORCH_DEVICE=cpu`` asks for the CPU, and every
line names the device it was measured on (a CPU run's times are the CPU's).
"""
