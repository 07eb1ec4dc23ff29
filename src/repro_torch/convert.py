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
leaves as the ``np.uint16`` array of the same bits. The two float8
types cross the same way as ``np.uint8`` bits.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from repro_torch.tree import Tree, tree_map

NumpyTree = Union[np.ndarray, Dict[str, "NumpyTree"]]


#: narrow floats numpy has no type of its own for: the torch dtype, the
#: unsigned numpy view that carries the bits, and the torch view of it
BIT_VIEWS = {"bfloat16": (torch.bfloat16, np.uint16, torch.int16),
             "float8_e4m3fn": (torch.float8_e4m3fn, np.uint8, torch.uint8),
             "float8_e5m2": (torch.float8_e5m2, np.uint8, torch.uint8)}


def dtype_name(x: torch.Tensor) -> str:
    """The numpy (and ``ml_dtypes``) name of a tensor's dtype."""
    return str(x.dtype).removeprefix("torch.")


def _leaf_from_numpy(x: Any, device: Union[str, torch.device],
                     name: Optional[str] = None) -> torch.Tensor:
    """An array -> a tensor on ``device``. A narrow float arrives either
    typed (``dtype.name`` in :data:`BIT_VIEWS`) or as its unsigned bits
    with ``name`` naming the type."""
    arr = np.asarray(x)
    name = name or arr.dtype.name
    if name in BIT_VIEWS:
        dtype, bits_np, _ = BIT_VIEWS[name]
        bits = np.ascontiguousarray(arr).view(bits_np).copy()
        return torch.from_numpy(bits).view(dtype).to(device)
    return torch.from_numpy(np.array(arr)).to(device)


def _leaf_to_numpy(x: torch.Tensor) -> np.ndarray:
    x = x.detach().cpu()
    name = dtype_name(x)
    if name in BIT_VIEWS:
        _, bits_np, bits_t = BIT_VIEWS[name]
        return x.contiguous().view(bits_t).numpy().view(bits_np)
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
