"""Carry parameters between the JAX package and the port.

The reference's parameters are nested dicts of arrays; the port's are
nested dicts of tensors with the same keys and the same layout (dense
``w`` is ``[n_in, n_out]``, conv kernels HWIO, a transformer's
``blocks`` leaves stacked on a leading ``[L]`` axis), so the carry-over
is the identity on arrays. The reference side hands over numpy arrays
(``np.asarray`` of each leaf), so this module needs no JAX.

bfloat16 crosses bit for bit without ``ml_dtypes``: numpy has no
bfloat16 of its own, so a JAX bf16 leaf arrives as an array whose
``dtype.name`` is ``"bfloat16"`` (``ml_dtypes``'s type), which
``torch.from_numpy`` refuses. Its 16-bit patterns are reinterpreted as
``np.uint16`` and then as ``torch.bfloat16``; going out, a bf16 tensor
leaves as the ``np.uint16`` array of the same bits.
"""
from __future__ import annotations

from typing import Any, Dict, Union

import numpy as np
import torch

from repro_torch.tree import Tree, tree_map

NumpyTree = Union[np.ndarray, Dict[str, "NumpyTree"]]


def _leaf_from_numpy(x: Any, device: Union[str, torch.device]
                     ) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.uint16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr)).to(device)


def _leaf_to_numpy(x: torch.Tensor) -> np.ndarray:
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        return x.contiguous().view(torch.int16).numpy().view(np.uint16)
    return x.numpy()


def params_from_numpy(tree: Any,
                      device: Union[str, torch.device] = "cpu") -> Tree:
    """A nested dict of arrays -> the same dict of tensors on ``device``.

    A bfloat16 leaf (``dtype.name == "bfloat16"``) becomes a
    ``torch.bfloat16`` tensor with the same bits."""
    return tree_map(lambda x: _leaf_from_numpy(x, device), tree)


def params_to_numpy(tree: Tree) -> NumpyTree:
    """A nested dict of tensors -> the same dict of numpy arrays.

    A ``torch.bfloat16`` leaf comes back as an ``np.uint16`` array of
    its bit patterns (numpy has no bfloat16); viewing it as
    ``ml_dtypes.bfloat16`` gives the values back exactly."""
    return tree_map(_leaf_to_numpy, tree)
