"""Carry flat-index state between the JAX package and this one.

An index has no weights: its state is the index itself, and both packages
describe it with the same ``state_dict`` (``kind``, ``dim``, ``metric``,
``size`` and the host-authoritative ``vectors``/``alive``/``tags`` arrays,
``semcode_tpu/index/flat.py:643-680``). Device tensors are derived from it.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .flat import FlatIndex


def flat_from_jax_state(state: Dict[str, np.ndarray], **kwargs) -> FlatIndex:
    """A FlatIndex from the output of the JAX ``FlatIndex.state_dict()``;
    ``kwargs`` are FlatIndex options (dtype, scan_impl, device, ...)."""
    if str(state.get("kind", "flat")) != "flat":
        raise ValueError(f"not a flat-index state: kind={state.get('kind')}")
    return FlatIndex.from_state(state, **kwargs)


def flat_to_jax_state(index: FlatIndex) -> Dict[str, np.ndarray]:
    """The state dict the JAX ``FlatIndex.from_state`` takes."""
    return index.state_dict()
