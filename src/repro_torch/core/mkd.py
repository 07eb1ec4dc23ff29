"""Moshpit Knowledge Distillation (paper Alg. 2 + Alg. 3).

MKD reuses MAR's group formation: in MKD round ``g`` each peer's
candidate teachers ``C_g`` are its round-``g`` MAR group mates. The peer
(1) rates every candidate by the KL divergence between the candidate's
and its own *softened* output distributions on its local minibatches
(Alg. 3, the Shao et al. 2024 non-iid guard), (2) keeps the top-l
(l = ceil(rho_l * |C_g|)) lowest-KL teachers, (3) averages their logits
and distills for E epochs with the Hinton loss

    L = (1 - alpha) CE(y, softmax(s)) + alpha tau^2 KL(p_z || p_s),
    alpha = lambda = max(0, 1 - (t-1)/K)   (linear anneal, §A.1).

Port of the JAX package's ``repro/core/mkd.py``. The reference
double-vmaps over peers and candidates; here the round's partner matrix
gathers the N x M teacher parameter sets onto one ``[N*M, ...]`` peer
axis, so the batched ``apply_fn`` runs every teacher on its student's
inputs in one call. Students train by one backward of the sum of the
per-peer mean losses, as ``Federation._local_update`` does: the peers'
parameters are disjoint, so each gets its own gradient. Dropped peers
(a_mask = 0) are excluded from candidate sets but still distill.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.mar_allreduce import round_index
from repro_torch.optim.sgdm import momentum_sgd_step
from repro_torch.tree import Tree, tree_leaves, tree_map


def softened(logits: torch.Tensor, tau: float) -> torch.Tensor:
    return torch.softmax(logits / tau, dim=-1)


def kl_divergence(p: torch.Tensor, q: torch.Tensor,
                  eps: float = 1e-9) -> torch.Tensor:
    """KL(p || q) over the last axis."""
    p = torch.clamp(p, eps, 1.0)
    q = torch.clamp(q, eps, 1.0)
    return torch.sum(p * (torch.log(p) - torch.log(q)), dim=-1)


def student_loss(student_logits: torch.Tensor,
                 teacher_logits: torch.Tensor, labels: torch.Tensor,
                 tau: float, alpha: float) -> torch.Tensor:
    """Alg. 2 line 8: weighted CE + tau^2-scaled KL to the teacher mix.

    Logits ``[..., B, C]``, labels ``[..., B]``; the loss is the mean
    over ``B``, one value per leading index (a scalar for one peer)."""
    logp = torch.log_softmax(student_logits, dim=-1)
    ce = -logp.gather(-1, labels.unsqueeze(-1)).squeeze(-1).mean(dim=-1)
    p_z = softened(teacher_logits, tau)
    p_s = softened(student_logits, tau)
    lkl = kl_divergence(p_z, p_s).mean(dim=-1)
    return (1.0 - alpha) * ce + alpha * (tau ** 2) * lkl


def select_teachers(my_logits: torch.Tensor, cand_logits: torch.Tensor,
                    cand_mask: torch.Tensor, tau: float,
                    rho: float) -> torch.Tensor:
    """Alg. 3: weights [..., M] — 1/l for the top-l lowest-KL candidates.

    my_logits: [..., B*, C]; cand_logits: [..., M, B*, C]; cand_mask:
    [..., M] (0 = the candidate dropped or is the student itself).
    Masked candidates rate ``inf``; ranks come from stable sorts, so
    ties go to the lower index, as ``jnp.argsort`` orders them.
    """
    m = cand_logits.shape[-3]
    p_s = softened(my_logits, tau)
    p_c = softened(cand_logits, tau)
    div = kl_divergence(p_c, p_s.unsqueeze(-3)).mean(dim=-1)    # [..., M]
    avail = cand_mask > 0
    div = torch.where(avail, div, torch.full_like(div, float("inf")))
    n_avail = avail.sum(dim=-1)
    l = torch.clamp(torch.ceil(rho * n_avail).to(torch.int64), 1, m)
    order = torch.argsort(div, dim=-1, stable=True)             # asc
    rank = torch.argsort(order, dim=-1, stable=True)            # rank of each
    chosen = (rank < l.unsqueeze(-1)) & avail
    denom = torch.clamp(chosen.sum(dim=-1, keepdim=True), min=1)
    return chosen.float() / denom                               # [..., M]


def mkd_rounds(fed, params: Tree, momentum: Tree, a_mask: torch.Tensor,
               kd_indices: torch.Tensor, kd_lambda: float
               ) -> Tuple[Tree, Tree]:
    """All G MKD rounds of one FL iteration (sim backend).

    ``fed`` is the :class:`~repro_torch.core.federation.Federation`
    (grid plan, apply_fn, data, hyperparameters); ``kd_indices``
    ``[N, local_batches * batch_size]`` picks each peer's fixed
    distillation rows for this iteration.
    """
    cfg = fed.cfg
    plan = fed.plan
    rows = fed._peer_rows
    bx = fed.data_x[rows, kd_indices]                           # [N, B*, D]
    by = fed.data_y[rows, kd_indices]                           # [N, B*]
    rounds = cfg.mar_rounds if cfg.mar_rounds is not None else plan.depth
    for g in range(rounds):
        params, momentum = _mkd_one_round(
            fed, params, momentum, a_mask, bx, by, g % plan.depth,
            kd_lambda)
    return params, momentum


def _mkd_one_round(fed, params, momentum, a_mask, bx, by, g, kd_lambda):
    cfg = fed.cfg
    n = cfg.n_peers
    tau, rho = cfg.kd_temperature, cfg.kd_selection_ratio
    dev = bx.device

    # candidate teachers = round-g MAR group mates (virtual slots as 0)
    ri = round_index(fed.plan, g, dev)
    pmat = ri.partners                                          # [N, M]
    m = pmat.shape[1]
    # candidate mask: group mate joins aggregation, is real, and is not
    # the student itself
    cand_mask = a_mask[pmat] * ri.real                          # [N, M]

    # teacher logits: every student's M candidates on one peer axis
    t_params = tree_map(
        lambda x: x[pmat].reshape((n * m,) + tuple(x.shape[1:])), params)
    x_rep = bx.unsqueeze(1).expand((n, m) + tuple(bx.shape[1:])) \
        .reshape((n * m,) + tuple(bx.shape[1:]))
    cand_logits = fed.apply_fn(t_params, x_rep)
    cand_logits = cand_logits.reshape((n, m) + tuple(cand_logits.shape[1:]))
    my_logits = fed.apply_fn(params, bx)                        # [N, B*, C]
    w = select_teachers(my_logits, cand_logits, cand_mask, tau, rho)
    zbar = torch.einsum("nm,nmbc->nbc", w, cand_logits)         # [N, B*, C]

    p, mom = params, momentum
    for _ in range(cfg.kd_epochs):
        leaves = tree_map(lambda t: t.detach().requires_grad_(), p)
        with torch.enable_grad():
            loss = student_loss(fed.apply_fn(leaves, bx), zbar, by, tau,
                                kd_lambda).sum()
            grads = iter(torch.autograd.grad(loss, tree_leaves(leaves)))
        grads = tree_map(lambda _: next(grads), leaves)
        p, mom = momentum_sgd_step(p, mom, grads, cfg.lr, cfg.momentum)

    # a peer with zero available teachers keeps its pre-MKD state
    has_teacher = cand_mask.sum(dim=1) > 0
    mix = lambda new, old: torch.where(  # noqa: E731
        has_teacher.reshape((-1,) + (1,) * (new.dim() - 1)), new, old)
    return tree_map(mix, p, params), tree_map(mix, mom, momentum)
