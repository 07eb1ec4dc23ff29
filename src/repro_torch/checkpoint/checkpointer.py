"""Fault-tolerant checkpointing for federation, training and serving state.

Port of the JAX package's ``repro/checkpoint/checkpointer.py`` over
nested dicts (and tuples) of tensors, with the same on-disk layout, so a
directory either package wrote restores bit for bit in the other:

* **Atomic**: ``<dir>/.tmp-<step>`` is written, then renamed to
  ``step_XXXXXXXXXX``, so a crashed writer never corrupts the latest
  checkpoint.
* **Self-describing**: ``manifest.json`` holds ``step``, ``treedef``
  (the string ``str(jax.tree.structure(tree))`` gives), ``keys``,
  ``shapes``, ``dtypes`` and the caller's ``metadata``; the arrays go to
  one ``arrays.npz``, keyed by the leaf's path joined by ``/`` (a tuple
  index is its decimal string), leaves visited in sorted-key order.
  bfloat16 and the float8 types are stored as same-width unsigned views
  (``convert.BIT_VIEWS``), the manifest naming the type.
* **Keep-last-k** retention, never deleting the newest.
* **Elastic**: when the saved ``n_peers`` differs from the requested
  one, peer-stacked leaves are remapped (``restore(like=)`` through
  ``core.replan.resize_peer_axis``; :meth:`Checkpointer.restore_elastic`
  by first-N' / cyclic growth).
* **Async**: ``save(..., blocking=False)`` copies the tree to the host
  at once and writes it on one daemon thread (at most one outstanding
  write).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.convert import (BIT_VIEWS, _leaf_from_numpy,
                                 _leaf_to_numpy, dtype_name)
from repro_torch.core.replan import resize_peer_axis
from repro_torch.models.model import resolve_device
from repro_torch.tree import Tree

_SEP = "/"


def _children(node: Any) -> Optional[List[Tuple[str, Any]]]:
    """(path entry, child) pairs of a tree node in the order
    ``jax.tree`` visits them; None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, (tuple, list)):
        return [(str(i), c) for i, c in enumerate(node)]
    return None


def _leaves_with_paths(tree: Any, prefix: Tuple[str, ...] = ()
                       ) -> List[Tuple[str, Any]]:
    kids = _children(tree)
    if kids is None:
        return [(_SEP.join(prefix), tree)]
    return [kv for key, child in kids
            for kv in _leaves_with_paths(child, prefix + (key,))]


def treedef_str(tree: Any) -> str:
    """``str(jax.tree.structure(tree))`` for a tree of dicts, tuples and
    lists, e.g. ``PyTreeDef({'a': *, 'b': (*,)})``."""
    def node(t):
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {node(t[k])}"
                                   for k in sorted(t)) + "}"
        if isinstance(t, tuple):
            inner = ", ".join(node(c) for c in t)
            return f"({inner},)" if len(t) == 1 else f"({inner})"
        if isinstance(t, list):
            return "[" + ", ".join(node(c) for c in t) + "]"
        return "*"
    return f"PyTreeDef({node(tree)})"


def _to_host(leaf: Any) -> Tuple[np.ndarray, str]:
    """A host copy of a leaf as the npz stores it (narrow floats as their
    bits) and the dtype name the manifest records. The copy shares no
    memory with the leaf, so an asynchronous write saves the values of
    the moment of the call (``.numpy()`` of a CPU tensor is a view)."""
    if isinstance(leaf, torch.Tensor):
        arr = _leaf_to_numpy(leaf)
        return (arr.copy() if leaf.device.type == "cpu" else arr,
                dtype_name(leaf))
    arr = np.array(leaf)
    name = arr.dtype.name
    if name in BIT_VIEWS:
        arr = arr.view(BIT_VIEWS[name][1])
    return arr, name


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._pending: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Tree,
             metadata: Optional[Dict[str, Any]] = None,
             blocking: bool = True) -> str:
        """Snapshot ``tree``: the copy to the host happens now, the write
        to disk on a thread when ``blocking`` is False."""
        arrays = [(k, *_to_host(leaf))
                  for k, leaf in _leaves_with_paths(tree)]
        manifest = {
            "step": int(step),
            "treedef": treedef_str(tree),
            "keys": [k for k, _, _ in arrays],
            "shapes": {k: list(a.shape) for k, a, _ in arrays},
            "dtypes": {k: name for k, _, name in arrays},
            "metadata": metadata or {},
        }

        def write():
            tmp = os.path.join(self.dir, f".tmp-{step}")
            final = os.path.join(self.dir, f"step_{step:010d}")
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "arrays.npz"),
                     **{k: a for k, a, _ in arrays})
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f, indent=1)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()

        self.wait()        # one outstanding write; it may share .tmp-<step>
        if blocking:
            write()
        else:
            with self._lock:
                self._pending = threading.Thread(target=write, daemon=True)
                self._pending.start()
        return os.path.join(self.dir, f"step_{step:010d}")

    def wait(self) -> None:
        with self._lock:
            t, self._pending = self._pending, None
        if t is not None:
            t.join()

    # ------------------------------------------------------------------
    def steps(self) -> List[int]:
        return sorted(int(name.split("_")[1]) for name in os.listdir(self.dir)
                      if name.startswith("step_"))

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def poll(self, since: Optional[int] = None) -> Optional[int]:
        """Newest step strictly newer than ``since`` (None if nothing
        new): the serving engine's hot-swap watcher calls it between
        decode steps with the step of the weights it holds."""
        latest = self.latest_step()
        if latest is None or (since is not None and latest <= since):
            return None
        return latest

    def restore(self, step: Optional[int] = None, like: Optional[Tree] = None,
                device: Any = None) -> Tuple[Tree, Dict[str, Any]]:
        """Returns (tree, metadata). With ``like``, the tree has ``like``'s
        structure and each leaf ``like``'s dtype and device; without it,
        a nested dict keyed by path of tensors on ``device`` (CUDA by
        default, raising where there is none).

        When the manifest's ``n_peers`` differs from the leading axis of
        ``like``'s leaves, peer-stacked leaves are remapped through
        ``core.replan.resize_peer_axis``: survivors bit-exact, joiners
        from the f32 mean.
        """
        self.wait()
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(path, "arrays.npz")) as npz:
            blobs = {k: npz[k] for k in manifest["keys"]}

        def load(key, dev):
            return _leaf_from_numpy(blobs[key], dev, manifest["dtypes"][key])

        if like is None:
            dev = resolve_device(device)
            tree: Dict[str, Any] = {}
            for key in manifest["keys"]:
                node = tree
                parts = key.split(_SEP)
                for p in parts[:-1]:
                    node = node.setdefault(p, {})
                node[parts[-1]] = load(key, dev)
            return tree, manifest["metadata"]

        old_n = manifest["metadata"].get("n_peers")
        remapped = 0

        def fill(node, prefix):
            nonlocal remapped
            kids = _children(node)
            if kids is None:
                x = load(_SEP.join(prefix), node.device)
                if (old_n is not None and x.dim() >= 1 and node.dim() >= 1
                        and x.shape[0] == old_n and node.shape[0] != old_n
                        and x.shape[1:] == node.shape[1:]):
                    x = resize_peer_axis(x, old_n, node.shape[0])
                    remapped += 1
                return x.to(node.dtype)
            sub = [fill(c, prefix + (k,)) for k, c in kids]
            if isinstance(node, dict):
                return dict(zip(sorted(node), sub))
            return type(node)(sub)

        tree = fill(like, ())
        if remapped:
            print(f"[checkpoint] step {step}: remapped {remapped} "
                  f"peer-stacked leaves from {old_n} saved peers to the "
                  f"requested axis (survivors exact, joiners group-mean)")
        return tree, manifest["metadata"]

    # ------------------------------------------------------------------
    def restore_elastic(self, n_peers: int, step: Optional[int] = None,
                        like: Optional[Tree] = None, device: Any = None
                        ) -> Tuple[Tree, Dict[str, Any]]:
        """Restore a peer-stacked tree onto another peer count: shrinking
        keeps the first ``n_peers``, growing repeats the saved peers
        cyclically. With ``like``, leaves are matched by path and take
        its dtypes and devices; a path the checkpoint lacks keeps
        ``like``'s value. The device defaults to ``like``'s, else CUDA."""
        if device is None and like is not None:
            device = next(iter(_leaves_with_paths(like)))[1].device
        tree, meta = self.restore(step, like=None, device=device)
        old_n = meta.get("n_peers")

        def remap(node):
            if isinstance(node, dict):
                return {k: remap(v) for k, v in node.items()}
            if (old_n is None or node.dim() == 0 or node.shape[0] != old_n
                    or old_n == n_peers):
                return node
            if n_peers < old_n:
                return node[:n_peers]
            reps = -(-n_peers // old_n)
            return torch.cat([node] * reps, dim=0)[:n_peers]

        tree = remap(tree)
        if like is not None:
            def match(node, found):
                kids = _children(node)
                if kids is None:
                    if isinstance(found, torch.Tensor):
                        return found.to(device=node.device, dtype=node.dtype)
                    return node
                sub = [match(c, found.get(k) if isinstance(found, dict)
                             else None) for k, c in kids]
                if isinstance(node, dict):
                    return dict(zip(sorted(node), sub))
                return type(node)(sub)
            tree = match(like, tree)
        return tree, dict(meta, n_peers=n_peers)

    def _gc(self) -> None:
        for s in self.steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)
