"""The SSD scan's backward, and the recurrent families' training through
it, against the JAX package.

The Pallas ``ssd_scan_fwd`` has no backward: the reference trains the
ssm and hybrid families through ``jax.vjp`` of its jnp
``chunked_linear_scan``. The port's ``_SsdScanFn`` launches the CUDA
kernel forward and takes that same VJP backward
(``kernels/ref.ssd_scan_bwd``). Here, on the CPU:

* ``ssd_scan_bwd`` against ``jax.vjp`` of the reference's
  ``chunked_linear_scan``, f32, within 1e-5 of each gradient's largest
  magnitude: Mamba2's layout (B and C broadcast over the heads at head
  stride 0), mLSTM's (dv = dk + 1), a nonzero h0, both cotangents, S not
  a multiple of the chunk (one chunk of S) and S = 512 (two chunks).
* ``_SsdScanFn`` itself, its launch replaced by the plain sequential scan
  (the only thing the CPU cannot run), against autograd of that scan:
  gradients within 1e-5, in the inputs' dtypes and shapes, a missing
  cotangent taken as zero, Mamba2's B and C saved as views.
* ``Model.loss`` of the ssm (xlstm-350m) and hybrid (zamba2-2.7b) smoke
  configs through the Function, against ``jax.value_and_grad`` of the
  reference's loss on the weights ``convert`` carries across, with remat
  and without: loss within 1e-5, each gradient leaf within 1e-4 of its
  largest magnitude (the tolerance of ``test_torch_train_loss.py``), and
  the forward launched once per scan layer, twice with remat.
* every leaf of ``mamba_block`` and ``mlstm_block`` gets a nonzero
  gradient through the Function under ``torch.utils.checkpoint``,
  ``a_log`` and ``dt_bias`` through log_a and ``d_skip`` included.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as ref_smoke_config
from repro.models.model import Model as RefModel
from repro.models.ssm import chunked_linear_scan as j_chunked

from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ssd_scan
from repro_torch.kernels.ref import ssd_scan_bwd, ssd_scan_ref
from repro_torch.models import ssm
from repro_torch.models.model import Model
from repro_torch.tree import tree_leaves
from test_torch_federation import one_torch_thread  # noqa: F401
from test_torch_train_loss import _batch


def _inputs(layout: str, s: int, seed: int):
    """numpy (q, k, v, log_a, h0, dy, dh) in the layer's layout: mamba
    draws one [b, 1, S, dk] B and C (broadcast over the heads by the
    caller); mlstm has dv = dk + 1."""
    rng = np.random.default_rng(seed)
    b, nh, dk = 2, 3, 8
    dv = dk if layout == "mamba" else dk + 1
    qk_heads = 1 if layout == "mamba" else nh
    f = lambda *sh: rng.normal(size=sh).astype(np.float32)  # noqa: E731
    q, k = f(b, qk_heads, s, dk), f(b, qk_heads, s, dk)
    v = f(b, nh, s, dv)
    log_a = -np.abs(f(b, nh, s)) * 0.3
    h0 = f(b, nh, dk, dv) * 0.5
    dy, dh = f(b, nh, s, dv), f(b, nh, dk, dv)
    return q, k, v, log_a, h0, dy, dh, nh


def _expand(t, nh):
    return t.expand(t.shape[0], nh, *t.shape[2:])


@pytest.mark.parametrize("s", [40, 512])
@pytest.mark.parametrize("layout", ["mamba", "mlstm"])
def test_ssd_scan_bwd_matches_jax_vjp(layout, s):
    q, k, v, log_a, h0, dy, dh, nh = _inputs(layout, s, seed=s)
    jq, jk = (jnp.broadcast_to(jnp.asarray(x), (x.shape[0], nh)
                               + x.shape[2:]) for x in (q, k))
    _, vjp = jax.vjp(j_chunked, jq, jk, jnp.asarray(v),
                     jnp.asarray(log_a), jnp.asarray(h0))
    want = vjp((jnp.asarray(dy), jnp.asarray(dh)))
    tq, tk = (_expand(torch.from_numpy(x), nh) for x in (q, k))
    assert tq.stride(1) == 0 or layout == "mlstm"
    got = ssd_scan_bwd(tq, tk, *map(torch.from_numpy, (v, log_a, h0, dy,
                                                      dh)))
    for name, g, w in zip(("dq", "dk", "dv", "dlog_a", "dh0"), got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        scale = max(float(np.abs(w).max()), 1e-12)
        err = float(np.abs(g.numpy() - w).max())
        assert err <= 1e-5 * scale, (name, err, scale)


@pytest.fixture
def cpu_launch(monkeypatch):
    """Route CPU tensors through ``_SsdScanFn`` with the plain sequential
    scan standing in for the kernel launch; the list counts launches."""
    calls = []

    def launch(q, k, v, log_a, h0):
        calls.append(tuple(q.shape))
        with torch.no_grad():
            return ssd_scan_ref(q, k, v, log_a, h0)

    monkeypatch.setattr(ssd_scan, "_launch", launch)
    monkeypatch.setattr(ssd_scan, "ssd_scan_fwd",
                        lambda *a: ssd_scan._SsdScanFn.apply(*a))
    return calls


@pytest.mark.parametrize("cotangents", ["both", "y_only", "h_only"])
@pytest.mark.parametrize("layout", ["mamba", "mlstm"])
def test_function_grads_match_autograd_of_plain_scan(cpu_launch, layout,
                                                     cotangents):
    q, k, v, log_a, h0, dy, dh, nh = _inputs(layout, 24, seed=5)
    base = [torch.from_numpy(x) for x in (q, k, v, log_a, h0)]

    def grads(fn):
        leaves = [x.clone().requires_grad_() for x in base]
        qq, kk = (_expand(x, nh) if layout == "mamba" else x
                  for x in leaves[:2])
        y, h = fn(qq, kk, *leaves[2:])
        outs = {"both": [(y, dy), (h, dh)], "y_only": [(y, dy)],
                "h_only": [(h, dh)]}[cotangents]
        got = torch.autograd.grad(
            [o for o, _ in outs], leaves,
            [torch.from_numpy(c) for _, c in outs], allow_unused=True)
        # h_final does not reach q: the plain scan leaves it None
        return [torch.zeros_like(x) if g is None else g
                for g, x in zip(got, leaves)]

    got = grads(ssd_scan.ssd_scan_fwd)
    want = grads(ssd_scan_ref)
    assert len(cpu_launch) == 1
    for g, w, x in zip(got, want, base):
        assert g.shape == x.shape and g.dtype == x.dtype
        scale = max(float(w.abs().max()), 1e-12)
        assert float((g - w).abs().max()) <= 1e-5 * scale


def test_function_saves_inputs_as_given_and_keeps_dtypes(cpu_launch):
    """Mamba2's stride-0 B and C are saved as the views they are, and a
    bf16 call's gradients come back in bf16 (log_a and h0 in f32)."""
    q, k, v, log_a, h0, _, _, nh = _inputs("mamba", 16, seed=9)
    bq, bk, bv = (torch.from_numpy(x).bfloat16().requires_grad_()
                  for x in (q, k, v))
    la, hh = (torch.from_numpy(x).requires_grad_() for x in (log_a, h0))
    qq, kk = _expand(bq, nh), _expand(bk, nh)
    y, h = ssd_scan.ssd_scan_fwd(qq, kk, bv, la, hh)
    saved = y.grad_fn.saved_tensors
    assert saved[0].stride(1) == 0 and saved[0].data_ptr() == bq.data_ptr()
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    (y.float().sum() + h.sum()).backward()
    assert bq.grad.dtype == bk.grad.dtype == bv.grad.dtype == torch.bfloat16
    assert la.grad.dtype == hh.grad.dtype == torch.float32
    assert all(bool(torch.isfinite(x.grad.float()).all())
               for x in (bq, bk, bv, la, hh))


@pytest.mark.parametrize("remat", ["block", "none"])
@pytest.mark.parametrize("arch", ["xlstm-350m", "zamba2-2.7b"])
def test_model_loss_grads_through_the_function_match_reference(
        cpu_launch, arch, remat):
    kw = dict(dtype="float32", remat=remat)
    rcfg = dataclasses.replace(ref_smoke_config(arch), **kw)
    cfg = dataclasses.replace(get_smoke_config(arch), **kw)
    ref = RefModel(rcfg)
    ref_params = ref.init(jax.random.PRNGKey(2))
    params = convert.params_from_numpy(jax.tree.map(np.asarray, ref_params))
    batch = _batch(cfg, seed=11)
    want_loss, want_grads = jax.value_and_grad(ref.loss)(
        ref_params, jax.tree.map(jnp.asarray, batch))
    leaves = [x.requires_grad_() for x in tree_leaves(params)]
    loss = Model(cfg).loss(params, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
    forward_launches = len(cpu_launch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    # one launch per Mamba2 / mLSTM layer, again in each remat recompute
    assert forward_launches > 0
    assert len(cpu_launch) == forward_launches * (2 if remat == "block"
                                                  else 1)
    assert abs(float(loss.detach()) - float(want_loss)) <= 1e-5
    want_leaves = jax.tree.leaves(want_grads)
    assert len(want_leaves) == len(grads)
    for got, want in zip(grads, want_leaves):
        want = np.asarray(want)
        got = np.zeros_like(want) if got is None else got.numpy()
        scale = max(float(np.abs(want).max()), 1e-12)
        assert float(np.abs(got - want).max()) <= 1e-4 * scale


@pytest.mark.parametrize("block", ["mamba", "mlstm"])
def test_every_block_leaf_gets_a_gradient_under_checkpoint(cpu_launch,
                                                           block):
    arch = "zamba2-2.7b" if block == "mamba" else "xlstm-350m"
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    gen = torch.Generator().manual_seed(3)
    init = ssm.mamba_init if block == "mamba" else ssm.mlstm_init
    params = init(gen, cfg)
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    x = torch.randn((2, 12, cfg.d_model), generator=gen)

    def run(p, x):
        fn = ssm.mamba_block if block == "mamba" else ssm.mlstm_block
        return fn(p, x, cfg)[0]

    y = torch.utils.checkpoint.checkpoint(run, leaves, x,
                                          use_reentrant=False)
    grads = torch.autograd.grad(y.square().sum(), list(leaves.values()))
    assert len(cpu_launch) == 2          # the forward and the recompute
    for name, g in zip(leaves, grads):
        assert g is not None and bool(torch.isfinite(g).all()), name
        assert float(g.abs().max()) > 0, name
    if block == "mamba":
        assert {"a_log", "dt_bias", "d_skip"} <= set(leaves)
    # and each equals the plain scan's gradient (attn_impl "xla": the
    # chunked scan, differentiated by autograd)
    plain = dataclasses.replace(cfg, attn_impl="xla")
    fn = ssm.mamba_block if block == "mamba" else ssm.mlstm_block
    want = torch.autograd.grad(fn(leaves, x, plain)[0].square().sum(),
                               list(leaves.values()))
    for name, g, w in zip(leaves, grads, want):
        scale = max(float(w.abs().max()), 1e-12)
        assert float((g - w).abs().max()) <= 1e-5 * scale, name
