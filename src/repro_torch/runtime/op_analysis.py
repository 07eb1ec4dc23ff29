"""Cost analysis of an executed step: FLOPs, bytes and collectives.

Counterpart of the JAX package's ``repro/runtime/hlo_analysis.py``.
The reference parses the optimized HLO text of a compiled step and
multiplies while-loop bodies by their trip counts. PyTorch has no HLO
text: the step runs eagerly, so every loop trip, every rematerialized
forward and every nested loop is executed, and an analysis that counts
the ops as they run counts them all. :class:`OpAnalysis` does so while
a step runs (on real tensors or on ``meta`` ones, where the ops compute
shapes only):

* FLOPs through ``torch.utils.flop_counter.FlopCounterMode``: matmuls,
  convolutions and attention by their formulas (2 x M x N x K for a
  matmul);
* bytes through a ``TorchDispatchMode``: every op that is not a view
  counts its tensor operands read and its results written, unfused
  (``bytes``); copies, dtype conversions and clones count as
  ``layout_bytes``, as the reference's layout-only fusions do;
* collectives: counts by op through
  ``torch.distributed.tensor.debug.CommDebugMode`` (DTensor's
  redistributions), and, from the same dispatch mode, each collective's
  operand bytes and process-group size (the MAR rounds' own
  ``all_reduce`` calls and DTensor's gathers alike);
* with ``track_memory``, the peak of the bytes alive in storages that
  the step allocated (freed when their last tensor dies).

``FlopCounterMode`` may route an op to another kernel than a plain run
takes, so an analysed step can differ from a plain one in the last
bits: analyse an extra step, not one whose values are checked.

Ops that do not go through the dispatcher are not seen: the port's
hand-written kernels, launched through ``ctypes``, add no FLOPs or bytes
here (the dry run runs on ``meta``, where the plain versions run).

``analyze`` returns the reference ``analyze_text`` keys that keep a
meaning (``flops``, ``bytes``, ``layout_bytes``, ``collective_bytes``,
``collective_by_op``, ``collective_counts``); ``unknown_trip_whiles``
has none here (no loop is left uncounted).
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "ragged-all-to-all", "collective-permute", "broadcast")

#: c10d and functional-collective op names -> the reference's op keys
_COLLECTIVE_OPS = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "all_to_all_single": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "broadcast_": "broadcast", "broadcast": "broadcast",
}

#: ops that only move or re-type values already read elsewhere
_LAYOUT_OPS = {"_to_copy", "copy_", "clone", "contiguous", "expand_copy",
               "_unsafe_view", "permute_copy", "transpose_copy"}


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _group_size(args) -> int:
    """The size of the process group a collective op was given: a c10d
    op carries the group object, a functional collective its name."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    for a in args:
        if isinstance(a, torch.ScriptObject):
            return dist.ProcessGroup.unbox(a).size()
        if isinstance(a, dist.ProcessGroup):
            return a.size()
    for a in args:
        if isinstance(a, str):
            return _resolve_process_group(a).size()
    return 0


class _Counter(TorchDispatchMode):
    """Bytes, collectives and (optionally) live storage bytes of every op
    dispatched while it is active."""

    def __init__(self, track_memory: bool):
        super().__init__()
        from torch.utils.weak import WeakIdKeyDictionary

        self.bytes = 0.0
        self.layout_bytes = 0.0
        self.collectives: List[Tuple[str, int, int]] = []
        self.track_memory = track_memory
        self._seen = WeakIdKeyDictionary()
        self.live = 0
        self.peak = 0

    def _free(self, n: int) -> None:
        self.live -= n

    def _track(self, outs) -> None:
        import weakref

        for t in _tensors(outs):
            st = t.untyped_storage()
            if st in self._seen:
                continue
            n = st.nbytes()
            self._seen[st] = n
            weakref.finalize(st, self._free, n)
            self.live += n
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        if ns in ("c10d", "_c10d_functional"):
            op = _COLLECTIVE_OPS.get(name)
            if op is not None:
                nb = sum(_nbytes(t) for t in _tensors((args, kwargs)))
                self.collectives.append((op, nb, _group_size(args)))
            if self.track_memory:
                self._track(out)
            return out
        if func.is_view or ns == "prim":
            return out
        nb = sum(_nbytes(t) for t in _tensors((args, kwargs))) \
            + sum(_nbytes(t) for t in _tensors(out))
        if name in _LAYOUT_OPS:
            self.layout_bytes += nb
        else:
            self.bytes += nb
        if self.track_memory:
            self._track(out)
        return out


class OpAnalysis:
    """A context manager that counts what runs inside it::

        with OpAnalysis() as a:
            step(state, batch)
        a.analyze()     # {"flops": ..., "bytes": ..., ...}
    """

    def __init__(self, track_memory: bool = False):
        from torch.distributed.tensor.debug import CommDebugMode
        from torch.utils.flop_counter import FlopCounterMode

        self._flops = FlopCounterMode(display=False)
        self._comm = CommDebugMode()
        self._counter = _Counter(track_memory)

    def __enter__(self) -> "OpAnalysis":
        self._flops.__enter__()
        self._comm.__enter__()
        self._counter.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self._counter.__exit__(*exc)
        self._comm.__exit__(*exc)
        self._flops.__exit__(*exc)

    @property
    def collectives(self) -> List[Tuple[str, int, int]]:
        """(op, operand bytes, group size) of every collective, in order."""
        return list(self._counter.collectives)

    @property
    def peak_bytes(self) -> int:
        """Peak bytes alive in storages the step allocated (with
        ``track_memory``)."""
        return self._counter.peak

    def comm_counts(self) -> Dict[str, int]:
        """CommDebugMode's counts, under the reference's op keys."""
        out = {c: 0 for c in _COLLECTIVES}
        for op, n in self._comm.get_comm_counts().items():
            key = _COLLECTIVE_OPS.get(str(op).split(".")[-1])
            if key is not None:
                out[key] += n
        return out

    def analyze(self) -> Dict[str, Any]:
        by_op = {c: 0.0 for c in _COLLECTIVES}
        for op, nb, _ in self._counter.collectives:
            by_op[op] += nb
        return {
            "flops": float(self._flops.get_total_flops()),
            "bytes": self._counter.bytes,
            "layout_bytes": self._counter.layout_bytes,
            "collective_bytes": sum(by_op.values()),
            "collective_by_op": by_op,
            "collective_counts": {k: float(v)
                                  for k, v in self.comm_counts().items()},
        }

