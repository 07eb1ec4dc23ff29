"""The published Zamba2 (Zyphra, arXiv:2411.15242), trained through the
port's normal path: ``Model.init``, ``Model.loss`` and ``Model.forward``
dispatch here for ``family == "zamba2"``.

The equations are those of Zamba2-2.7B as transformers' ``Zamba2ForCausalLM``
states them (``models/zamba2/modeling_zamba2.py``, its torch path):

* token embedding ``e`` (row ``pad_token_id`` takes no gradient from the
  lookup); the hidden state starts as ``h = e``;
* each of ``num_layers`` layers is a Mamba2 layer,
  ``h = h + mixer(rmsnorm(h + t))``, where ``t`` is 0 in a ``"mamba"``
  layer and, in a ``"hybrid"`` layer, the output of a shared block and
  the layer's own linear;
* the shared block (``num_mem_blocks`` of them, applied in turn: the
  j-th hybrid layer applies block ``j % num_mem_blocks``) reads
  ``concat(h, e)``: RMSNorm over the 2d features, attention with
  ``num_heads`` heads of ``attention_head_dim`` scaled by
  ``(attention_head_dim / 2) ** -0.5``, ``o_proj`` 2d -> d, RMSNorm, and a
  gated-GELU MLP (exact erf GELU) whose ``gate_up`` product carries a
  rank-``adapter_rank`` adapter of the j-th application's own; no
  residual inside the block; then the j-th layer's linear d -> d;
* the mixer: ``in_proj`` -> (z, xBC, dt); a depthwise causal conv with
  bias, then SiLU; dt = max(softplus(dt + dt_bias), time_step_min); the
  SSD scan with the D skip, B and C one group shared by the heads
  (``ssm.mamba_ssd``); the gated RMSNorm ``rmsnorm(y silu(z))``
  (``ssm.gated_rmsnorm``); ``out_proj``;
* final RMSNorm, the tied unembedding, next-token cross entropy
  (``transformer.token_nll_mean``, honouring ``loss_mask``).

Parameters (every stack on a leading axis, as the other families):
``embedding.tok`` [V, d]; ``mamba.*`` [num_layers, ...] (``norm``,
``in_proj``, ``conv_w`` [d_conv, conv_dim], ``conv_b``, ``a_log``,
``dt_bias``, ``d_skip``, ``gate_norm``, ``out_proj``); ``shared.*``
[num_mem_blocks, ...] (``norm1``, ``wq``, ``wk``, ``wv``, ``wo``,
``norm2``, ``gate_up`` [d, 2 ff] (gate, then up), ``down``);
``adapters.*`` [hybrid layers, ...] (``mlp_a`` [d, r], ``mlp_b`` [r, 2
ff], ``linear`` [d, d]); ``final_norm`` [d].

The published 2.7B's flags are constants here, as ``Zamba2Config``
checks: one Mamba group, a conv bias, no rotary positions, no attention
adapters, tied embeddings (the 7B's two groups and rotary positions
would need their own code and a cell that runs it).

With ``cfg.remat == "block"`` each layer is recomputed in the backward,
a hybrid layer's shared block and linear with it (``model.recompute``).
Every application of a shared block, with its linear, runs under the
``torch.profiler`` label ``zamba2.shared_block``, in the forward and in
the recompute. Decode and serving of this family are out of scope:
``transformer.check_supported`` refuses it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.attention_flash import FlashAttention
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.tree import Tree, tree_leaves

Tensor = torch.Tensor

FAMILY = "zamba2"
#: profiler label of one shared-block application (concat, attention,
#: MLP with its adapter, the layer's linear), forward and recompute
SPAN_SHARED_BLOCK = "zamba2.shared_block"
#: ``Zamba2Config``'s default ``layers_block_type``: 54 layers, hybrid at
#: 6, 12, ..., 42, 47, 51
PUBLISHED_LAYERS: Tuple[str, ...] = (
    ("mamba",) + (("mamba",) * 5 + ("hybrid",)) * 7 + ("mamba",) * 4
    + ("hybrid",) + ("mamba",) * 3 + ("hybrid",) + ("mamba",) * 2)
#: the published 2.7B's flags, the only values the port builds
PUBLISHED_FLAGS = {"mamba_ngroups": 1, "mamba_conv_bias": True,
                   "use_mem_rope": False,
                   "use_shared_attention_adapter": False,
                   "tie_embeddings": True}


@dataclasses.dataclass(frozen=True)
class Zamba2Config(ModelConfig):
    """A Zamba2 configuration: ``ModelConfig``'s sizes (``d_ff`` the shared
    MLP's width, ``ssm_state`` the Mamba2 state, ``ssm_conv_width`` its
    conv, ``ssm_expand`` its expansion) and Zamba2's own. Zero widths are
    derived as ``transformers.Zamba2Config`` derives them. The flags from
    ``mamba_ngroups`` to ``tie_embeddings`` take only the published
    2.7B's values (``PUBLISHED_FLAGS``)."""

    layers_block_type: Tuple[str, ...] = PUBLISHED_LAYERS
    num_mem_blocks: int = 2
    adapter_rank: int = 128
    attention_hidden_size: int = 0       # 0 -> 2 d_model
    attention_head_dim: int = 0          # 0 -> attention_hidden_size / heads
    mamba_heads: int = 0                 # 0 -> expand d_model / head dim
    mamba_head_dim: int = 64
    mamba_ngroups: int = 1
    mamba_conv_bias: bool = True
    use_mem_rope: bool = False
    use_shared_attention_adapter: bool = False
    time_step_min: float = 1e-3
    pad_token_id: Optional[int] = 0
    tie_embeddings: bool = True

    def __post_init__(self):
        d = self.d_model
        if not self.attention_hidden_size:
            object.__setattr__(self, "attention_hidden_size", 2 * d)
        if not self.attention_head_dim:
            object.__setattr__(self, "attention_head_dim",
                               self.attention_hidden_size // self.num_heads)
        if not self.mamba_heads:
            object.__setattr__(self, "mamba_heads",
                               self.ssm_expand * d // self.mamba_head_dim)
        if not self.head_dim:
            object.__setattr__(self, "head_dim", self.attention_head_dim)
        super().__post_init__()
        problems = []
        if self.family != FAMILY:
            problems.append(f"family {self.family!r}")
        if len(self.layers_block_type) != self.num_layers \
                or set(self.layers_block_type) - {"mamba", "hybrid"}:
            problems.append(f"layers_block_type of {self.num_layers} "
                            f"'mamba'/'hybrid' entries")
        a = self.attention_hidden_size
        if self.head_dim != self.attention_head_dim \
                or self.num_kv_heads != self.num_heads \
                or self.num_heads * self.head_dim != a or a != 2 * d:
            problems.append("heads (as many k and v heads) x head dim == "
                            "attention_hidden_size == 2 d_model")
        if self.mamba_heads * self.mamba_head_dim != self.ssm_expand * d:
            problems.append("mamba heads x head dim == expand x d_model")
        flags = {k: getattr(self, k) for k in PUBLISHED_FLAGS}
        if flags != PUBLISHED_FLAGS:
            problems.append(f"the published flags {PUBLISHED_FLAGS}, not "
                            f"{flags}")
        if self.attn_impl != "flash" or self.frontend != "none":
            problems.append("attn_impl 'flash' and no frontend")
        if problems:
            raise ValueError(f"{self.name}: Zamba2Config needs "
                             + "; ".join(problems))

    @property
    def hybrid_layer_ids(self) -> Tuple[int, ...]:
        return tuple(i for i, k in enumerate(self.layers_block_type)
                     if k == "hybrid")

    @property
    def mamba_inner(self) -> int:
        return self.mamba_heads * self.mamba_head_dim

    @property
    def conv_dim(self) -> int:
        """The conv's channels: x, then B and C."""
        return self.mamba_inner + 2 * self.ssm_state

    def block_pattern(self) -> Tuple[str, ...]:
        return tuple(self.layers_block_type)

    def param_count(self) -> int:
        from repro_torch.models.model import _MetaGenerator
        return sum(math.prod(x.shape) for x in tree_leaves(init_params(
            self, _MetaGenerator())))


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def dt_bias_init(gen: torch.Generator, n: int, lo: float = 1e-3,
                 hi: float = 1e-1, floor: float = 1e-4) -> Tensor:
    """softplus^-1 of dt drawn log-uniform in [lo, hi] (at least
    ``floor``), as the published initialization sets ``dt_bias``."""
    u = torch.rand((n,), generator=gen, dtype=torch.float32,
                   device=gen.device)
    dt = torch.exp(u * (math.log(hi) - math.log(lo)) + math.log(lo))
    dt = torch.clamp(dt, min=floor)
    return dt + torch.log(-torch.expm1(-dt))


def _mamba_init(gen: torch.Generator, cfg: Zamba2Config) -> Dict[str, Tensor]:
    dt, d, dev = L.torch_dtype(cfg), cfg.d_model, gen.device
    inner, nh, cdim = cfg.mamba_inner, cfg.mamba_heads, cfg.conv_dim
    width, like = cfg.ssm_conv_width, dict(dtype=dt, device=dev)
    return {"norm": L.rmsnorm_init(d, dt, dev),
         "in_proj": L.dense_init(gen, d, inner + cdim + nh, dt),
         # the std of a Conv1d's default U(+-1/sqrt(width))
         "conv_w": (torch.randn((width, cdim), generator=gen,
                                dtype=torch.float32, device=dev)
                    / math.sqrt(3 * width)).to(dt),
         "a_log": torch.log(torch.arange(1, nh + 1, device=dev,
                                         dtype=torch.float32)).to(dt),
         "dt_bias": dt_bias_init(gen, nh).to(dt),
         "d_skip": torch.ones((nh,), **like),
         "gate_norm": L.rmsnorm_init(inner, dt, dev),
         "conv_b": torch.zeros((cdim,), **like),
         "out_proj": L.dense_init(gen, inner, d, dt)}


def _shared_init(gen: torch.Generator, cfg: Zamba2Config) -> Dict[str, Tensor]:
    dt, d, dev = L.torch_dtype(cfg), cfg.d_model, gen.device
    a, ff = cfg.attention_hidden_size, cfg.d_ff
    return {"norm1": L.rmsnorm_init(a, dt, dev),
            "wq": L.dense_init(gen, a, a, dt),
            "wk": L.dense_init(gen, a, a, dt),
            "wv": L.dense_init(gen, a, a, dt),
            "wo": L.dense_init(gen, a, d, dt),
            "norm2": L.rmsnorm_init(d, dt, dev),
            "gate_up": L.dense_init(gen, d, 2 * ff, dt),
            "down": L.dense_init(gen, ff, d, dt)}


def _adapter_init(gen: torch.Generator, cfg: Zamba2Config
                  ) -> Dict[str, Tensor]:
    dt, d, r = L.torch_dtype(cfg), cfg.d_model, cfg.adapter_rank
    return {"mlp_a": L.dense_init(gen, d, r, dt),
            "mlp_b": L.dense_init(gen, r, 2 * cfg.d_ff, dt),
            "linear": L.dense_init(gen, d, d, dt)}


def init_params(cfg: Zamba2Config, gen: torch.Generator) -> Dict[str, Tree]:
    """Random parameters drawn from ``gen`` on its device, every leaf in
    ``cfg.dtype``: normal over sqrt(fan-in) for dense weights, 0.02 for
    the embedding, ones for norms and D, zeros for the conv bias, a_log =
    log(1..heads), dt_bias from :func:`dt_bias_init`."""
    return {
        "embedding": L.embedding_init(gen, cfg),
        "mamba": T._stack(cfg.num_layers, lambda: _mamba_init(gen, cfg)),
        "shared": T._stack(cfg.num_mem_blocks,
                           lambda: _shared_init(gen, cfg)),
        "adapters": T._stack(len(cfg.hybrid_layer_ids),
                             lambda: _adapter_init(gen, cfg)),
        "final_norm": L.rmsnorm_init(cfg.d_model, L.torch_dtype(cfg),
                                     gen.device),
    }


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def mamba_layer(mp: Dict[str, Tensor], h: Tensor, t: Optional[Tensor],
                cfg: Zamba2Config) -> Tensor:
    """``h + mixer(rmsnorm(h + t))``; ``t`` None in a ``"mamba"`` layer."""
    x = L.rmsnorm(h if t is None else h + t, mp["norm"], cfg.norm_eps)
    inner, cdim = cfg.mamba_inner, cfg.conv_dim
    z, xbc, dt_raw = torch.split(x @ mp["in_proj"],
                                 [inner, cdim, cfg.mamba_heads], dim=-1)
    xbc = S.causal_conv(xbc, mp["conv_w"], bias=mp["conv_b"])
    y, _ = S.mamba_ssd(xbc, dt_raw, -torch.exp(mp["a_log"].float()), mp,
                       cfg, cfg.mamba_heads, cfg.mamba_head_dim,
                       cfg.time_step_min)
    y = S.gated_rmsnorm(y, z, mp["gate_norm"])
    return h + y @ mp["out_proj"]


def _attention(bp: Dict[str, Tensor], x: Tensor, cfg: Zamba2Config
               ) -> Tensor:
    b, s, _ = x.shape
    h, hd = cfg.num_heads, cfg.head_dim
    q, k, v = ((x @ bp[f"w{name}"]).reshape(b, s, h, hd) for name in "qkv")
    o = FlashAttention.apply(q, k, v, True, cfg.attn_q_chunk,
                             cfg.attn_kv_chunk, (hd / 2) ** -0.5)[0]
    return o.reshape(b, s, h * hd) @ bp["wo"]


def shared_block(bp: Dict[str, Tensor], ap: Dict[str, Tensor], h: Tensor,
                 e: Tensor, cfg: Zamba2Config) -> Tensor:
    """One application: the shared block on ``concat(h, e)``, its MLP's
    adapter and the layer's linear (``ap``) -> the ``t`` its Mamba2
    layer adds to its input."""
    with record_function(SPAN_SHARED_BLOCK):
        x = L.rmsnorm(torch.cat([h, e], dim=-1), bp["norm1"], cfg.norm_eps)
        x = L.rmsnorm(_attention(bp, x, cfg), bp["norm2"], cfg.norm_eps)
        gate, up = (x @ bp["gate_up"]
                    + (x @ ap["mlp_a"]) @ ap["mlp_b"]).chunk(2, dim=-1)
        return ((F.gelu(gate) * up) @ bp["down"]) @ ap["linear"]


def forward(params: Tree, tokens: Tensor, cfg: Zamba2Config, **kw
            ) -> Tuple[Tensor, Tensor, None]:
    """tokens [b, s] -> (logits [b, s, V] f32, aux 0, no cache), the
    return of ``transformer.forward``."""
    if kw.get("prefix_embeds") is not None or kw.get("collect_cache"):
        raise ValueError("the zamba2 family has no frontend and no decode "
                         "cache")
    e = F.embedding(tokens.long(), params["embedding"]["tok"],
                    padding_idx=cfg.pad_token_id)

    def hybrid(mp, bp, ap, h, e):
        return mamba_layer(mp, h, shared_block(bp, ap, h, e, cfg), cfg)

    mamba = T._maybe_remat(lambda mp, h: mamba_layer(mp, h, None, cfg), cfg)
    hybrid = T._maybe_remat(hybrid, cfg)
    shared, adapters = T.layers(params["shared"]), T.layers(params["adapters"])
    h, j = e, 0
    for kind, mp in zip(cfg.layers_block_type, T.layers(params["mamba"])):
        if kind == "hybrid":
            h = hybrid(mp, shared[j % cfg.num_mem_blocks], adapters[j], h, e)
            j += 1
        else:
            h = mamba(mp, h)
    h = L.rmsnorm(h, params["final_norm"], cfg.norm_eps)
    logits = L.unembed(params["embedding"], h, cfg)
    return logits, torch.zeros((), dtype=torch.float32, device=h.device), None


def lm_loss(params: Tree, batch: Dict[str, Tensor], cfg: Zamba2Config
            ) -> Tensor:
    """Next-token cross entropy of ``batch`` (``tokens``, ``labels``,
    optional ``loss_mask``)."""
    logits, _, _ = forward(params, batch["tokens"], cfg,
                           prefix_embeds=batch.get("prefix_embeds"))
    return T.token_nll_mean(logits, batch["labels"], batch.get("loss_mask"))
