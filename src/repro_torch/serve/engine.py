"""Continuous-batching decode service over the paged KV pool.

Port of the JAX package's ``repro/serve/engine.py``: one model replica
decodes many interactive sessions at once, and fresh weights can be
swapped in between steps without dropping in-flight sessions.

* :class:`DecodeServer` — the continuous-batching engine. Admission is
  FIFO with head-of-line blocking (a session is admitted the moment a
  batch row AND its full worst-case block budget are both available, so
  a running session can never hit pool exhaustion mid-flight). Prefill
  runs the whole right-padded prompt in one forward pass (the flash
  kernel on the card) and scatters its KV straight into the session's
  pages; decode assembles every running session into one fixed-width
  batched step against the shared pool (the paged kernel on the card).
  Finished sessions are evicted between steps and their blocks
  reclaimed. There is no ``jax.jit``: the prefill and decode bodies are
  plain methods run under ``torch.inference_mode()``, and the pool is
  updated in place.
* :func:`run_sequential` — the pre-engine serve loop (one session at a
  time, dense cache, plain attention in decode), the baseline the
  engine's greedy streams must equal, and the only path of the
  recurrent families (ssm, hybrid: the SSD-scan kernel in every
  prefill on the card).
* Hot-swap — ``swap_params`` installs new weights between steps;
  ``serving_params_from_checkpoint`` folds a peer-stacked FL checkpoint
  into serving weights (the peer mean); ``attach_checkpointer`` polls
  a ``Checkpointer`` between steps and swaps in every newer step.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.models import transformer as T
from repro_torch.models.model import Model
from repro_torch.serve.paged_cache import (SCRATCH_BLOCK, BlockAllocator,
                                           session_table,
                                           write_prefill_to_pages)
from repro_torch.tree import Tree, tree_leaves

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Config / session bookkeeping
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Static engine geometry."""
    max_batch: int = 8          # decode rows assembled per step
    block_size: int = 16        # KV positions per page
    num_blocks: int = 257       # pool size incl. the scratch page 0
    pad_len: int = 64           # prompts are right-padded to this length
    max_new: int = 32           # per-session generation cap (upper bound)
    eos_id: Optional[int] = None

    @property
    def table_width(self) -> int:
        """Block-table columns: worst-case session footprint, plus the
        prefill's padded overhang (pad KV beyond a session's own blocks
        lands on the scratch page)."""
        need = -(-(self.pad_len + self.max_new) // self.block_size)
        pref = -(-self.pad_len // self.block_size)
        return max(need, pref)


@dataclasses.dataclass
class Session:
    sid: int
    prompt: np.ndarray                       # [plen] int32
    max_new: int
    blocks: List[int] = dataclasses.field(default_factory=list)
    row: int = -1
    generated: List[int] = dataclasses.field(default_factory=list)
    state: str = "queued"                    # queued -> running -> done
    token_times: List[float] = dataclasses.field(default_factory=list)
    t_enqueue: float = 0.0
    t_done: float = 0.0

    @property
    def plen(self) -> int:
        return int(self.prompt.shape[0])

    def blocks_needed(self, block_size: int) -> int:
        return -(-(self.plen + self.max_new) // block_size)


# ---------------------------------------------------------------------------
# Checkpoint -> serving weights
# ---------------------------------------------------------------------------

def serving_params_from_checkpoint(state: Any, template: Tree) -> Tree:
    """Fold a restored checkpoint into serving params shaped, typed and
    placed like ``template`` (``model.init(...)``).

    Accepts either raw params or a full FL state dict (``{"params":
    ..., "momentum": ...}``) of tensors or numpy arrays; leaves carrying
    a peer axis (ndim == template ndim + 1) are averaged over it in f32.
    """
    if isinstance(state, dict) and "params" in state:
        state = state["params"]

    def fold(node: Any, like: Tree) -> Tree:
        if isinstance(like, dict):
            return {key: fold(node[key], like[key]) for key in like}
        arr = torch.as_tensor(node)
        if arr.dim() == like.dim() + 1:
            arr = arr.float().mean(dim=0)
        return arr.to(device=like.device, dtype=like.dtype)

    return fold(state, template)


# ---------------------------------------------------------------------------
# Continuous-batching engine
# ---------------------------------------------------------------------------

class DecodeServer:
    """Greedy continuous-batching decode over a paged KV pool.

    Drive with :meth:`enqueue` + :meth:`run` (or :meth:`step` for
    external control loops). Finished sessions accumulate in
    ``self.finished``; no session is ever dropped — a prompt that can
    never fit (``plen > pad_len`` or a footprint larger than the whole
    pool) is rejected at enqueue instead of deadlocking the queue. The
    pool lives on the parameters' device.
    """

    def __init__(self, model: Model, params: Tree, cfg: ServeConfig):
        T.check_supported(model.cfg)
        if model.cfg.family not in T.PAGED_FAMILIES:
            raise ValueError(
                f"paged serving supports KV-cache families, "
                f"got {model.cfg.family}")
        self.model = model
        self.params = params
        self.cfg = cfg
        self.device = tree_leaves(params)[0].device
        with torch.inference_mode():
            self.pages = model.init_paged_cache(cfg.num_blocks,
                                                cfg.block_size, self.device)
        self.alloc = BlockAllocator(cfg.num_blocks)
        self.queue: List[Session] = []
        self.running: List[Session] = []
        self.finished: List[Session] = []
        self.engine_step = 0
        self.prefill_count = 0
        self.decode_steps = 0
        self.swap_log: List[Dict[str, Any]] = []
        self._watch: Optional[Dict[str, Any]] = None

        mb, tw = cfg.max_batch, cfg.table_width
        self._free_rows = list(range(mb - 1, -1, -1))
        self._tok = np.zeros((mb,), np.int32)
        self._pos = np.zeros((mb,), np.int32)
        self._bt = np.full((mb, tw), SCRATCH_BLOCK, np.int32)

    def _to_device(self, arr: np.ndarray) -> Tensor:
        return torch.as_tensor(arr).to(self.device)

    # -- prefill and decode bodies ---------------------------------------
    @torch.inference_mode()
    def _prefill(self, tokens: np.ndarray, length: int,
                 block_table: List[int]) -> int:
        """tokens [1, pad_len] (right-padded); ``length`` real tokens.
        One forward pass writes the whole prompt's KV into the session's
        pages (in place) and returns the first generated token."""
        logits, _, cache = self.model.forward(
            self.params, self._to_device(tokens), collect_cache=True)
        write_prefill_to_pages(self.pages, cache["k"], cache["v"],
                               self._to_device(np.asarray([block_table],
                                                          np.int32)))
        return int(logits[0, length - 1].argmax())

    @torch.inference_mode()
    def _decode(self) -> np.ndarray:
        logits, self.pages = self.model.paged_decode_step(
            self.params, self.pages, self._to_device(self._bt),
            self._to_device(self._pos), self._to_device(self._tok))
        return logits.argmax(dim=-1).to(torch.int32).cpu().numpy()

    # -- session lifecycle ----------------------------------------------
    def enqueue(self, prompt: Sequence[int], max_new: Optional[int] = None,
                sid: Optional[int] = None) -> Session:
        prompt = np.asarray(prompt, np.int32)
        max_new = self.cfg.max_new if max_new is None else max_new
        if prompt.shape[0] > self.cfg.pad_len:
            raise ValueError(
                f"prompt len {prompt.shape[0]} > pad_len {self.cfg.pad_len}")
        if not (1 <= max_new <= self.cfg.max_new):
            raise ValueError(f"max_new {max_new} outside [1, "
                             f"{self.cfg.max_new}]")
        sess = Session(
            sid=len(self.queue) + len(self.running) + len(self.finished)
            if sid is None else sid,
            prompt=prompt, max_new=max_new, t_enqueue=time.perf_counter())
        need = sess.blocks_needed(self.cfg.block_size)
        if need > self.alloc.num_blocks - 1:
            raise ValueError(f"session needs {need} blocks; pool has "
                             f"{self.alloc.num_blocks - 1}")
        self.queue.append(sess)
        return sess

    def _admit(self) -> None:
        """FIFO admission with head-of-line blocking: stop at the first
        session that doesn't fit — later arrivals must not overtake it
        (fairness over packing)."""
        while self.queue and self._free_rows:
            sess = self.queue[0]
            need = sess.blocks_needed(self.cfg.block_size)
            if not self.alloc.can_alloc(need):
                return
            self.queue.pop(0)
            t0 = time.perf_counter()
            sess.blocks = self.alloc.alloc(need)
            sess.row = self._free_rows.pop()
            table = session_table(sess.blocks, self.cfg.table_width)
            toks = np.zeros((1, self.cfg.pad_len), np.int32)
            toks[0, :sess.plen] = sess.prompt
            first = self._prefill(toks, sess.plen, table)
            sess.generated.append(first)
            sess.token_times.append(time.perf_counter() - t0)
            sess.state = "running"
            self.prefill_count += 1
            self._bt[sess.row] = table
            self._tok[sess.row] = first
            self._pos[sess.row] = sess.plen
            self.running.append(sess)
            if self._is_finished(sess, first):
                self._evict(sess)

    def _is_finished(self, sess: Session, tok: int) -> bool:
        return (len(sess.generated) >= sess.max_new
                or (self.cfg.eos_id is not None and tok == self.cfg.eos_id))

    def _evict(self, sess: Session) -> None:
        self.alloc.free(sess.blocks)
        sess.blocks = []
        self._free_rows.append(sess.row)
        self._bt[sess.row] = SCRATCH_BLOCK
        self._tok[sess.row] = 0
        self._pos[sess.row] = 0
        sess.row = -1
        sess.state = "done"
        sess.t_done = time.perf_counter()
        self.running.remove(sess)
        self.finished.append(sess)

    # -- checkpoint hot-swap ---------------------------------------------
    def swap_params(self, params: Tree, tag: str = "manual") -> None:
        """Install new weights; takes effect on the next decode step.
        In-flight sessions keep their KV pages and positions — the cache
        holds context tokens, not weight state, so generation simply
        continues under the new model."""
        self.params = params
        self.swap_log.append({
            "engine_step": self.engine_step, "tag": tag,
            "in_flight": [s.sid for s in self.running]})

    def attach_checkpointer(self, ckpt: Any, template: Tree,
                            every: int = 8) -> None:
        """Poll ``ckpt`` (a ``Checkpointer``) every ``every`` engine
        steps; any newer step is restored, peer-folded onto
        ``template``'s device and dtypes, and swapped in."""
        self._watch = {"ckpt": ckpt, "template": template, "every": every,
                       "seen": ckpt.latest_step()}

    def _maybe_swap(self) -> None:
        w = self._watch
        if w is None or self.engine_step % w["every"]:
            return
        step = w["ckpt"].poll(w["seen"])
        if step is None:
            return
        # restored on the host, where the arrays arrive from disk; the
        # fold moves each leaf to the template's device
        state, _ = w["ckpt"].restore(step, device="cpu")
        self.swap_params(
            serving_params_from_checkpoint(state, w["template"]),
            tag=f"ckpt:{step}")
        w["seen"] = step

    # -- engine loop -----------------------------------------------------
    def step(self) -> bool:
        """Admit, run one batched decode step, evict finished sessions.
        Returns False once the engine is fully drained."""
        self._maybe_swap()
        self._admit()
        if not self.running:
            return bool(self.queue)
        t0 = time.perf_counter()
        ntok = self._decode()
        dt = time.perf_counter() - t0
        self.decode_steps += 1
        for sess in list(self.running):
            tok = int(ntok[sess.row])
            sess.generated.append(tok)
            sess.token_times.append(dt)
            self._tok[sess.row] = tok
            self._pos[sess.row] += 1
            if self._is_finished(sess, tok):
                self._evict(sess)
        self.engine_step += 1
        return True

    def run(self, max_steps: Optional[int] = None) -> List[Session]:
        steps = 0
        while self.step():
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return self.finished

    def assert_quiescent(self) -> None:
        """Invariant check after a drain: every block reclaimed, every
        row free, nothing in flight."""
        assert not self.queue and not self.running, \
            (len(self.queue), len(self.running))
        free = self.alloc.free_blocks
        assert free == self.alloc.num_blocks - 1, \
            f"block leak: {self.alloc.num_blocks - 1 - free} unreclaimed"
        assert len(self._free_rows) == self.cfg.max_batch

    def stats(self) -> Dict[str, float]:
        times = [t for s in self.finished for t in s.token_times[1:]]
        ttft = [s.token_times[0] for s in self.finished]
        toks = sum(len(s.generated) for s in self.finished)
        return {
            "sessions": len(self.finished),
            "tokens": toks,
            "decode_steps": self.decode_steps,
            "prefills": self.prefill_count,
            "p50_tok_s": float(np.percentile(times, 50)) if times else 0.0,
            "p99_tok_s": float(np.percentile(times, 99)) if times else 0.0,
            "p50_ttft_s": float(np.percentile(ttft, 50)) if ttft else 0.0,
            "swaps": len(self.swap_log),
        }


# ---------------------------------------------------------------------------
# Sequential baseline (pre-engine serve loop)
# ---------------------------------------------------------------------------

@torch.inference_mode()
def run_sequential(model: Model, params: Tree,
                   prompts: Sequence[Sequence[int]], max_new: int,
                   pad_len: int) -> List[Session]:
    """One session at a time against a dense cache (or the recurrent
    families' states), with the decode-ready prefill handoff (no prompt
    replay). The baseline: identical greedy tokens to the engine, none
    of the batching; the only serving path of the recurrent families,
    whose state cannot be paged. Their prompts must be exactly
    ``pad_len`` long (the state would absorb pad tokens)."""
    if model.has_frontend:
        raise ValueError("run_sequential takes token prompts only")
    T.check_supported(model.cfg)
    recurrent = model.cfg.family in T.RECURRENT_FAMILIES
    device = tree_leaves(params)[0].device
    max_len = pad_len + max_new
    out = []
    for sid, prompt in enumerate(prompts):
        prompt = np.asarray(prompt, np.int32)
        if prompt.shape[0] > pad_len:
            raise ValueError(f"prompt len {prompt.shape[0]} > {pad_len}")
        if recurrent and prompt.shape[0] != pad_len:
            # recurrent state absorbs pad tokens — exact length only
            raise ValueError(
                f"{model.cfg.family} prompts must be exactly pad_len="
                f"{pad_len} (got {prompt.shape[0]})")
        sess = Session(sid=sid, prompt=prompt, max_new=max_new,
                       t_enqueue=time.perf_counter())
        toks = np.zeros((1, pad_len), np.int32)
        toks[0, :sess.plen] = prompt
        t0 = time.perf_counter()
        logits, _, cache = model.forward(
            params, torch.as_tensor(toks).to(device), collect_cache=True)
        cache = model.prefill_cache_to_decode(
            cache, max_len, pad_len,
            lengths=torch.full((1,), sess.plen, dtype=torch.int32,
                               device=device))
        tok = logits[:, sess.plen - 1].argmax(dim=-1).to(torch.int32)
        sess.generated.append(int(tok[0]))
        sess.token_times.append(time.perf_counter() - t0)
        while len(sess.generated) < max_new:
            t0 = time.perf_counter()
            logits, cache = model.decode_step(params, cache, tok)
            tok = logits.argmax(dim=-1).to(torch.int32)
            sess.generated.append(int(tok[0]))
            sess.token_times.append(time.perf_counter() - t0)
        sess.state = "done"
        sess.t_done = time.perf_counter()
        out.append(sess)
    return out
