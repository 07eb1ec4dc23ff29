"""The paper's federation in plain PyTorch: N peers of the text model
(``relu(x W1 + b1) W2 + b2`` on 768 features, 20 classes), each with its
own rows (``data.py``).

One iteration: every peer takes ``local_batches`` damped momentum-SGD
steps on the mean cross entropy of its batch (float32, TF32 off), then
MAR over the grid (``mar.py``). Each round every peer sends its theta
and m, float32, to the other members of its group, so an iteration moves
``sum_r (dims[r] - 1) * N * 2 * 4 * params`` bytes.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence

import torch
import torch.nn.functional as F

from portbench import check, gen, weights
from portbench.reference import data, mar
from portbench.reference.precision import exact_float32, matmul_for

Tensor = torch.Tensor


def iteration_bytes(cfg: Dict[str, Any], dims: Sequence[int],
                    n_peers: int) -> int:
    params = sum(_numel(shape) for _, shape, *_ in weights.mlp_leaves(cfg))
    return sum(m - 1 for m in dims) * n_peers * 2 * 4 * params


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


class Federation:
    def __init__(self, cfg: Dict[str, Any], mix: Dict[str, Any], seed: int,
                 device: torch.device, precision: str = "float32"):
        self.cfg, self.mix, self.device = cfg, mix, device
        self.mm = matmul_for(precision)
        n = mix["peers"]
        x, y = data.peer_rows(cfg, n, mix["batch_size"], seed)
        self.x = torch.as_tensor(x, device=device)
        self.y = torch.as_tensor(y, device=device)
        self.rows = torch.arange(n, device=device)[:, None]
        self.theta = {p: t.unsqueeze(0).repeat(n, *([1] * t.dim()))
                      for p, t in weights.draw(cfg, seed, device).items()}
        self.m = {p: torch.zeros_like(t) for p, t in self.theta.items()}

    @property
    def n_rows(self) -> int:
        return self.x.shape[1]

    def _logits(self, W: Dict[str, Tensor], bx: Tensor) -> Tensor:
        h = torch.relu(self.mm(bx, W["fc1.w"]) + W["fc1.b"][:, None, :])
        return self.mm(h, W["fc2.w"]) + W["fc2.b"][:, None, :]

    def step(self, idx: Tensor) -> int:
        """One iteration on rows ``idx`` [N, local_batches, batch];
        returns its bytes."""
        lr, mu = self.cfg["lr"], self.cfg["momentum"]
        n, _, b = idx.shape
        for j in range(idx.shape[1]):
            bx = self.x[self.rows, idx[:, j]]
            by = self.y[self.rows, idx[:, j]]
            W = {p: t.detach().clone().requires_grad_()
                 for p, t in self.theta.items()}
            logits = self._logits(W, bx)
            nll = F.cross_entropy(logits.reshape(n * b, -1), by.reshape(-1),
                                  reduction="none").view(n, b)
            grads = torch.autograd.grad(nll.mean(dim=1).sum(),
                                        list(W.values()))
            for (p, t), g in zip(W.items(), grads):
                self.m[p] = mu * self.m[p] + (1.0 - mu) * g
                self.theta[p] = self.theta[p] - lr * self.m[p]
        mar.aggregate_(self.theta, self.mix["grid"])
        mar.aggregate_(self.m, self.mix["grid"])
        return iteration_bytes(self.cfg, self.mix["grid"], n)


def readings(cfg: Dict[str, Any], mix: Dict[str, Any], seed: int,
             device: torch.device, steps: int,
             precision: str = "float32") -> Dict[str, Any]:
    """The check steps' readings (``check.py``), the same rows as the
    port's set-up drew."""
    with exact_float32():
        fed = Federation(cfg, mix, seed, device, precision)
        out: Dict[str, Any] = {"loss": None, "bytes": []}
        for k in range(steps):
            idx = gen.batch_indices(mix, fed.n_rows, seed, gen.CHECK, k,
                                    device)
            with torch.enable_grad():
                out["bytes"].append(fed.step(idx))
            if k == 0:
                out["grad"] = check.grad_norms(fed.m, cfg["momentum"])
        out["change"] = check.change_norms(fed.theta, cfg, seed)
        out["n_rows"] = fed.n_rows
    return out
