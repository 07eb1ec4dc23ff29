"""Paged KV cache: host-side block allocator + device scatter helpers.

Port of the JAX package's ``repro/serve/paged_cache.py``. The serving
pool is one tensor pair per model (``transformer.init_paged_cache``):
``[L, num_blocks, block_size, kvh, hd]``. Sessions own disjoint sets of
physical blocks; a per-session *block table* row lists them in
logical-position order, so position ``p`` lives at page ``table[p //
block_size]`` slot ``p % block_size``. Block 0 is the scratch page:
inactive batch rows (and table columns beyond a session's allocation)
point there, so padded decode steps always have a legal write target —
scratch contents are garbage by design and masked out of every
attention read by the per-session lengths.

The allocator is host-side Python (like vLLM's): block churn is a
handful of ints per admit/evict next to the device work per decode step.
The pool is written in place (``index_put_``); JAX had to return a new
pool from every scatter.
"""
from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

SCRATCH_BLOCK = 0


class BlockAllocator:
    """Fixed pool of KV blocks; block 0 is never handed out (scratch)."""

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is scratch)")
        self.num_blocks = num_blocks
        # pop() from the end -> blocks hand out in ascending order
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self._owned: set = set()

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def alloc(self, n: int) -> List[int]:
        """Take ``n`` blocks; raises if the pool can't cover them (the
        engine checks ``can_alloc`` at admission, so a raise here means a
        scheduler bug, not load)."""
        if n > len(self._free):
            raise RuntimeError(
                f"allocator exhausted: want {n}, have {len(self._free)}")
        out = [self._free.pop() for _ in range(n)]
        self._owned.update(out)
        return out

    def free(self, blocks: List[int]) -> None:
        for b in blocks:
            if b not in self._owned:
                raise RuntimeError(f"double free of block {b}")
            self._owned.discard(b)
            self._free.append(b)


def session_table(blocks: List[int], width: int) -> List[int]:
    """A session's block-table row, padded to the engine's fixed table
    width with the scratch page."""
    if len(blocks) > width:
        raise ValueError(f"{len(blocks)} blocks > table width {width}")
    return list(blocks) + [SCRATCH_BLOCK] * (width - len(blocks))


def write_prefill_to_pages(pages: Dict[str, Tensor], k: Tensor, v: Tensor,
                           block_tables: Tensor) -> Dict[str, Tensor]:
    """Scatter a prefill KV cache (``forward(collect_cache=True)``:
    k/v ``[L, b, s, kvh, hd]``) into the paged pool, in place, through
    the block tables — position ``p`` of row ``i`` lands at page
    ``block_tables[i, p // bs]`` slot ``p % bs``. Returns ``pages``.

    ``s`` may overhang the last block; the overhang (and any pad tokens
    inside ``s``) writes garbage into blocks the session already owns —
    or the scratch page where the table runs out — and is masked by
    lengths on every read. Rows of different sessions never share a
    non-scratch page, so scatter collisions only hit scratch.
    """
    bs = pages["k_pages"].shape[2]
    n_layers, b, s = k.shape[0], k.shape[1], k.shape[2]
    nblk = -(-s // bs)
    if block_tables.shape[1] < nblk:
        raise ValueError(
            f"table width {block_tables.shape[1]} < {nblk} blocks for s={s}")
    s_pad = nblk * bs
    if s_pad != s:
        pad = (0, 0, 0, 0, 0, s_pad - s)       # the seq axis of [L,b,s,..]
        k, v = F.pad(k, pad), F.pad(v, pad)
    bt = block_tables[:, :nblk].long()
    pages["k_pages"][:, bt] = k.reshape(n_layers, b, nblk, bs, *k.shape[3:])
    pages["v_pages"][:, bt] = v.reshape(n_layers, b, nblk, bs, *v.shape[3:])
    return pages


def gather_session_cache(pages: Dict[str, Tensor],
                         table: List[int]) -> Dict[str, Tensor]:
    """Debug/test helper: materialize one session's dense KV view
    ``[L, 1, nblk*bs, kvh, hd]`` from its block-table row."""
    bt = torch.as_tensor(table, dtype=torch.long,
                         device=pages["k_pages"].device)
    k = pages["k_pages"][:, bt]            # [L, nblk, bs, kvh, hd]
    v = pages["v_pages"][:, bt]
    n_layers, nblk, bsz = k.shape[0], k.shape[1], k.shape[2]
    return {"k": k.reshape(n_layers, 1, nblk * bsz, *k.shape[3:]),
            "v": v.reshape(n_layers, 1, nblk * bsz, *v.shape[3:])}
