"""Model facade: one object per architecture config.

Port of the JAX package's ``repro/models/model.py``: init, loss,
forward and decode for every family of the ten architectures. The
modality frontends (pixtral, musicgen) are stubs as in the reference: a
batch carries precomputed patch or frame embeddings ``prefix_embeds``
[b, P, d_model] that feed the backbone.
``Model.init`` runs on CUDA unless the caller asks for another device,
and raises where there is no GPU. Caches are made on the device the
caller names (the serving engine passes its parameters' device).
``init_shape`` and ``cache_shape`` lay their trees out on the ``meta``
device (shapes and dtypes, no storage), where the reference returns
``jax.eval_shape``'s ShapeDtypeStructs; ``batch_specs`` and
``input_specs`` give the dry run (``launch/dryrun.py``) every input of
a step the same way.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import transformer as T
from repro_torch.models.transformer import PREFIX_LEN
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


class _MetaGenerator(torch.Generator):
    """A CPU generator that names the ``meta`` device, so
    ``transformer.init_params`` lays out every leaf there (shapes and
    dtypes, no storage)."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def init(self, seed: int = 0, device: Device = None) -> Tree:
        """Random parameters from ``torch.Generator(device).manual_seed(
        seed)``, made on ``device`` (CUDA by default)."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        return T.init_params(self.cfg, gen)

    def init_shape(self) -> Tree:
        """The parameters as tensors on the ``meta`` device, without
        allocating."""
        return T.init_params(self.cfg, _MetaGenerator())

    def loss(self, params: Tree, batch: Dict[str, torch.Tensor]
             ) -> torch.Tensor:
        """Next-token cross entropy (+ MoE aux) of ``batch`` (``tokens``,
        ``labels``, optional ``prefix_embeds`` and ``loss_mask``)."""
        return T.lm_loss(params, batch, self.cfg)

    def forward(self, params: Tree, tokens: torch.Tensor, **kw):
        return T.forward(params, tokens, self.cfg, **kw)

    @property
    def has_frontend(self) -> bool:
        return self.cfg.frontend != "none"

    def init_cache(self, batch: int, max_len: int,
                   device: Device = None) -> Tree:
        return T.init_cache(self.cfg, batch, max_len, resolve_device(device))

    def cache_shape(self, batch: int, max_len: int) -> Tree:
        """The decode cache as tensors on the ``meta`` device."""
        return T.init_cache(self.cfg, batch, max_len, torch.device("meta"))

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


# ---------------------------------------------------------------------------
# input specs (meta tensors; the dry run never allocates)
# ---------------------------------------------------------------------------

def _meta(shape: Tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: ShapeConfig,
                n_peers: int = 1, local_steps: int = 1,
                n_micro: int = 1) -> Dict[str, torch.Tensor]:
    """Train or prefill batch stand-ins on the ``meta`` device.

    Train batches carry the FL structure [n_peers, local_steps, n_micro,
    micro_batch, seq]: B local Momentum-SGD steps per peer (Alg. 1), each
    accumulating over n_micro microbatches.
    """
    gb, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        if gb % (n_peers * local_steps * n_micro):
            raise ValueError(f"global batch {gb} does not split into "
                             f"{n_peers} peers x {local_steps} steps x "
                             f"{n_micro} microbatches")
        mb = gb // (n_peers * local_steps * n_micro)
        lead = (n_peers, local_steps, n_micro, mb)
    else:  # prefill: flat per-request batch
        lead = (gb,)
    s_text = s
    specs = {}
    if cfg.frontend != "none":
        p = PREFIX_LEN[cfg.frontend]
        s_text = s - p
        specs["prefix_embeds"] = _meta(lead + (p, cfg.d_model),
                                       torch.float32)
    specs["tokens"] = _meta(lead + (s_text,), torch.int32)
    if shape.kind == "train":
        specs["labels"] = _meta(lead + (s_text,), torch.int32)
    return specs


def input_specs(cfg: ModelConfig, shape: ShapeConfig, n_peers: int = 1,
                local_steps: int = 1, n_micro: int = 1) -> Dict[str, Any]:
    """Every input of one (arch x shape) cell's step, on ``meta``.

    * train   -> {"batch": ...} for ``fl_train_step`` (the state comes
                 from ``fl_device.fl_state_shape``)
    * prefill -> {"batch": ...} for ``prefill_step``
    * decode / long_decode -> {"token": [b], "cache": ...} for
      ``serve_step``; the cache covers ``seq_len`` of history (window and
      state caches of the hybrid and ssm families are O(window) / O(1)).
    """
    if shape.kind == "train":
        return {"batch": batch_specs(cfg, shape, n_peers, local_steps,
                                     n_micro)}
    if shape.kind == "prefill":
        return {"batch": batch_specs(cfg, shape)}
    b = shape.global_batch
    return {"token": _meta((b,), torch.int32),
            "cache": Model(cfg).cache_shape(b, shape.seq_len)}
