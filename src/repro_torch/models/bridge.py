"""Weights and caches across the package boundary, as numpy arrays.

``jax.random`` and ``torch.Generator`` draw different numbers from one
seed, so a parity test initializes the reference's parameter (or cache)
tree, converts it leaf by leaf with ``np.asarray``, and loads it here into
tensors under the same dict paths and dtypes. This module imports neither
JAX nor the reference package: its input is numpy only.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.modules import PyTree, tree_map


def _tensor(a) -> torch.Tensor:
    a = np.array(a)                    # a writable copy torch may own
    if a.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16 is no dtype torch.from_numpy knows: move the
        # bits as uint16 and reinterpret them
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def tree_from_numpy(tree: PyTree, device) -> PyTree:
    """A tree of numpy arrays (dicts and lists of them) -> the same tree of
    torch tensors on ``device``, dtypes kept (bf16 included)."""
    return tree_map(lambda a: _tensor(a).to(device), tree,
                    is_leaf=lambda x: isinstance(x, np.ndarray)
                    or np.isscalar(x))
