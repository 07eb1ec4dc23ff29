"""Carry parameters between the JAX package and the port.

The reference's parameters are nested dicts of arrays; the port's are
nested dicts of tensors with the same keys and the same layout (dense
``w`` is ``[n_in, n_out]``, conv kernels HWIO), so the carry-over is
the identity on arrays. The reference side hands over numpy arrays
(``np.asarray`` of each leaf), so this module needs no JAX.
"""
from __future__ import annotations

from typing import Any, Dict, Union

import numpy as np
import torch

from repro_torch.tree import Tree, tree_map

NumpyTree = Union[np.ndarray, Dict[str, "NumpyTree"]]


def params_from_numpy(tree: Any,
                      device: Union[str, torch.device] = "cpu") -> Tree:
    """A nested dict of arrays -> the same dict of tensors on ``device``."""
    return tree_map(lambda x: torch.from_numpy(np.array(x)).to(device), tree)


def params_to_numpy(tree: Tree) -> NumpyTree:
    """A nested dict of tensors -> the same dict of numpy arrays."""
    return tree_map(lambda x: x.detach().cpu().numpy(), tree)
