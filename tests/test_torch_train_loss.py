"""The port's LM loss and its gradients against the JAX package's.

``Model.loss`` (``transformer.lm_loss``: next-token cross entropy plus
0.01 x the MoE aux, the mean over the positions ``loss_mask`` keeps)
and its gradient with respect to every parameter, against
``jax.value_and_grad(Model.loss)`` on the reference's weights carried
across by ``repro_torch.convert``: the smoke config of one architecture
per family, in f32 (``dataclasses.replace``), with remat ("block",
``torch.utils.checkpoint`` where the reference has ``jax.checkpoint``)
and without. The frontend families (vlm, audio) carry prefix embeddings
and a loss mask. The reference runs its flash attention (blockwise
XLA, custom VJP); the port its flash path's plain forward and the
blockwise recompute backward.

Tolerances: the loss within 1e-5, every gradient leaf within 1e-4 of
its largest magnitude (the same f32 math summed in other orders,
through up to 6 layers of backward).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as ref_smoke_config
from repro.models.model import Model as RefModel

from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import transformer as T
from repro_torch.models.model import Model
from repro_torch.tree import tree_leaves
from test_torch_federation import one_torch_thread  # noqa: F401

#: one architecture per family
FAMILY_ARCHS = {"dense": "starcoder2-3b", "vlm": "pixtral-12b",
                "audio": "musicgen-medium", "moe": "moonshot-v1-16b-a3b",
                "ssm": "xlstm-350m", "hybrid": "zamba2-2.7b"}


def _batch(cfg, seed, b=2, s=16):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    if cfg.frontend != "none":
        batch["prefix_embeds"] = rng.normal(
            size=(b, T.PREFIX_LEN[cfg.frontend], cfg.d_model)
        ).astype(np.float32)
        batch["loss_mask"] = (rng.random((b, s)) < 0.7).astype(np.float32)
    return batch


@pytest.mark.parametrize("remat", ["block", "none"])
@pytest.mark.parametrize("family", sorted(FAMILY_ARCHS))
def test_loss_and_grads_match_reference(family, remat):
    arch = FAMILY_ARCHS[family]
    kw = dict(dtype="float32", remat=remat)
    rcfg = dataclasses.replace(ref_smoke_config(arch), **kw)
    cfg = dataclasses.replace(get_smoke_config(arch), **kw)
    assert cfg.family == family
    ref = RefModel(rcfg)
    ref_params = ref.init(jax.random.PRNGKey(1))
    params = convert.params_from_numpy(jax.tree.map(np.asarray, ref_params))
    batch = _batch(cfg, seed=len(family))
    want_loss, want_grads = jax.value_and_grad(ref.loss)(
        ref_params, jax.tree.map(jnp.asarray, batch))
    leaves = [x.requires_grad_() for x in tree_leaves(params)]
    loss = Model(cfg).loss(params, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    assert abs(float(loss.detach()) - float(want_loss)) <= 1e-5
    want_leaves = jax.tree.leaves(want_grads)
    assert len(want_leaves) == len(grads)
    for got, want in zip(grads, want_leaves):
        want = np.asarray(want)
        # a parameter the loss does not reach has no torch gradient and
        # a zero JAX one
        got = np.zeros_like(want) if got is None else got.numpy()
        scale = max(float(np.abs(want).max()), 1e-12)
        assert float(np.abs(got - want).max()) <= 1e-4 * scale


def test_loss_mask_selects_positions():
    """With a loss mask the loss is the mean over the kept positions
    only; an all-zero mask gives 0 (plus the aux), not a division by
    zero."""
    cfg = dataclasses.replace(get_smoke_config("starcoder2-3b"),
                              dtype="float32", num_layers=1)
    params = Model(cfg).init(seed=0, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 2).items()}
    mask = torch.zeros(batch["tokens"].shape)
    mask[0, :5] = 1.0
    logits, _, _ = Model(cfg).forward(params, batch["tokens"])
    nll = torch.logsumexp(logits, -1) - logits.gather(
        -1, batch["labels"].long()[..., None])[..., 0]
    got = Model(cfg).loss(params, {**batch, "loss_mask": mask})
    assert torch.allclose(got, nll[0, :5].mean(), atol=1e-6)
    zero = Model(cfg).loss(params, {**batch,
                                    "loss_mask": torch.zeros_like(mask)})
    assert float(zero) == 0.0


@pytest.mark.parametrize("remat,per_layer", [("block", 2), ("none", 1)])
def test_remat_recomputes_each_attention_layer_once(monkeypatch, remat,
                                                    per_layer):
    """A training step's forward runs the flash forward once per layer,
    and with remat the backward runs it once more per layer when it
    recomputes the block: the count the card's launch gate derives."""
    calls = []
    real = fa.flash_attention_fwd

    def counting(*args):
        calls.append(1)
        return real(*args)

    monkeypatch.setattr(fa, "flash_attention_fwd", counting)
    cfg = dataclasses.replace(get_smoke_config("musicgen-medium"),
                              dtype="float32", remat=remat)
    params = Model(cfg).init(seed=0, device="cpu")
    leaves = [x.requires_grad_() for x in tree_leaves(params)]
    batch = {k: torch.from_numpy(v)
             for k, v in _batch(cfg, 3).items() if k != "prefix_embeds"}
    loss = Model(cfg).loss(params, batch)
    assert len(calls) == cfg.num_layers
    torch.autograd.grad(loss, leaves, allow_unused=True)
    assert len(calls) == per_layer * cfg.num_layers
