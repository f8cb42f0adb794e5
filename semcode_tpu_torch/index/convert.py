"""Carry index state between the JAX package and this one.

An index has no weights: its state is the index itself, and both packages
describe it with the same ``state_dict``. Device tensors are derived from it.

- flat: ``kind``, ``dim``, ``metric``, ``size`` and the host-authoritative
  ``vectors``/``alive``/``tags`` arrays (``semcode_tpu/index/flat.py:643-680``);
- ivf: ``kind``, ``dim``, ``metric``, ``nlist``, ``nprobe``, the
  ``centroids`` and the live rows' ``vectors``, ``assignments``, ``rows`` and
  ``tags`` (``semcode_tpu/index/ivf.py:1505-1546``). Loading re-adds the
  vectors under the given centroids, so a cross-loaded index has the
  source's cluster layout; live rows renumber densely in saved order.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .flat import FlatIndex
from .ivf import IVFIndex


def flat_from_jax_state(state: Dict[str, np.ndarray], **kwargs) -> FlatIndex:
    """A FlatIndex from the output of the JAX ``FlatIndex.state_dict()``;
    ``kwargs`` are FlatIndex options (dtype, scan_impl, device, ...)."""
    if str(state.get("kind", "flat")) != "flat":
        raise ValueError(f"not a flat-index state: kind={state.get('kind')}")
    return FlatIndex.from_state(state, **kwargs)


def flat_to_jax_state(index: FlatIndex) -> Dict[str, np.ndarray]:
    """The state dict the JAX ``FlatIndex.from_state`` takes."""
    return index.state_dict()



def ivf_from_jax_state(state: Dict[str, np.ndarray], **kwargs) -> IVFIndex:
    """An IVFIndex from the output of the JAX ``IVFIndex.state_dict()``;
    ``kwargs`` are IVFIndex options (dtype, use_pallas, device, ...)."""
    if str(state.get("kind", "ivf")) != "ivf":
        raise ValueError(f"not an ivf-index state: kind={state.get('kind')}")
    return IVFIndex.from_state(state, **kwargs)


def ivf_to_jax_state(index: IVFIndex) -> Dict[str, np.ndarray]:
    """The state dict the JAX ``IVFIndex.from_state`` takes."""
    return index.state_dict()
