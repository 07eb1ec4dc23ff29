"""Model facade: one object per architecture config.

Port of the JAX package's ``repro/models/model.py`` for the families
the port takes (dense, moe, ssm, hybrid; see
``transformer.check_supported``).
``Model.init`` runs on CUDA unless the caller asks for another device,
and raises where there is no GPU. Caches are made on the device the
caller names (the serving engine passes its parameters' device).
``batch_specs`` and ``input_specs`` wait for the dry-run tooling
(ROADMAP.md, Queue 1 item 15).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.tree import Tree

Device = Union[None, str, torch.device]


def resolve_device(device: Device) -> torch.device:
    """``None`` means CUDA, and raises where there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the model runs on CUDA by default and no CUDA device is "
                "available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def init(self, seed: int = 0, device: Device = None) -> Tree:
        """Random parameters from ``torch.Generator(device).manual_seed(
        seed)``, made on ``device`` (CUDA by default)."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        return T.init_params(self.cfg, gen)

    def forward(self, params: Tree, tokens: torch.Tensor, **kw):
        return T.forward(params, tokens, self.cfg, **kw)

    @property
    def has_frontend(self) -> bool:
        return self.cfg.frontend != "none"

    def init_cache(self, batch: int, max_len: int,
                   device: Device = None) -> Tree:
        return T.init_cache(self.cfg, batch, max_len, resolve_device(device))

    def decode_step(self, params: Tree, cache: Tree, token: torch.Tensor
                    ) -> Tuple[torch.Tensor, Tree]:
        return T.decode_step(params, cache, token, self.cfg)

    def prefill_cache_to_decode(self, cache: Tree, max_len: int,
                                seq_len: int,
                                lengths: Optional[torch.Tensor] = None
                                ) -> Tree:
        return T.prefill_cache_to_decode(cache, self.cfg, max_len, seq_len,
                                         lengths)

    def init_paged_cache(self, num_blocks: int, block_size: int,
                         device: Device = None) -> Dict[str, torch.Tensor]:
        return T.init_paged_cache(self.cfg, num_blocks, block_size,
                                  resolve_device(device))

    def paged_decode_step(self, params: Tree,
                          pages: Dict[str, torch.Tensor],
                          block_tables: torch.Tensor, pos: torch.Tensor,
                          token: torch.Tensor
                          ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        return T.paged_decode_step(params, pages, block_tables, pos, token,
                                   self.cfg)
