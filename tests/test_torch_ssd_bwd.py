"""The SSD scan's backward kernel (``kernels/ssd_scan.py``,
``csrc/ssd_scan.cu``, kernels ``ssd_bwd_*``).

On the CPU:

* which calls ``_bwd_takes_kernel`` sends to the kernel (stand-ins,
  without a launch): bf16 with dk and dv multiples of 8 up to 64 on a
  CUDA device; f32, xlstm's dk 512 / dv 513, the CPU and ``meta`` stay
  plain;
* the CPU route is unchanged: autograd of ``ssd_scan_ref`` agrees with
  ``ssd_scan_bwd``, and no backward kernel is asked for;
* the Function hands the kernel's route its None cotangents as None and
  asks for dh0 only where h0 needs a gradient (the kernel's launch
  replaced by the plain backward); an input that needs no gradient gets
  None;
* the trainer's v and dy (``ssm.mamba_ssd``'s layouts) reach the kernel
  as they are, B and C at head stride 0, with no copy;
* no ``__global__`` of the backward has ``ssd_scan_`` in its name,
  template or argument list (``ssd_scan_fwd_roofline`` reads that stem);
* the kernel's decomposition, modelled in f32 (``_plan``, a test aid):
  the states at each 64-step chunk's start and the cotangents at its
  end, the chunk-local products, and dlog_a from each chunk alone
  (exp(total) <H, dH> carrying the rest of the sequence) equal
  ``ssd_scan_bwd`` within 1e-4 of each gradient's peak (two f32 sums in
  other orders over up to 300 steps); with the kernel's roundings (bf16
  inputs as they are, every f32 operand of a product split into bf16 hi
  + lo) within 1e-3 of each head's peak, well under the card's gates.
  The route tests take decays of at most ~-1 a step: under Mamba2's
  ~-80 the sequential and the chunked f32 VJPs part by ~1e-5 of
  dlog_a's peak, which is not what they check;
* ``chip_smoke.py``'s counts of the backward kernel's launches, and
  ``_build.build_all(force=True)`` reporting a library already built
  (the smoke's spill gate of the ``ssd_bwd_`` kernels reads its log).

On the card (marked ``cuda``; they skip without one), the kernel against
``ssd_scan_bwd`` on the same bf16 inputs: dq, dk and dv within 8e-3 of
each (batch, head)'s own peak (a one-ulp bf16 flip is at most 2^-7 of
it), dlog_a within 2e-3 of its whole peak, dh0 within 1e-4 of its peak,
at S below one chunk, ragged S, stride-0 q and k, nonzero h0 and
dh_final given or not. Without dy, dh_final reaches dlog_a only through
the decays, so that case takes slow ones (at Mamba2's ~-80 a step it
would leave dlog_a ~1e-10, all of it below the rounding of the f32
sums). This file imports no JAX:
``python -m pytest -m cuda tests/test_torch_ssd_bwd.py``.
"""
import re
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import get_smoke_config
from repro_torch.kernels import _build
from repro_torch.kernels import ssd_scan as ss
from repro_torch.kernels.ref import ssd_scan_bwd, ssd_scan_ref
from repro_torch.models import ssm

CHUNK = ss.BWD_CHUNK


def _inputs(b, nh, s, dk, dv, seed, dtype=torch.float32, h0_scale=0.5,
            broadcast=True, device="cpu", a_max=80.0):
    """Mamba2-like inputs: B and C one [b, 1, S, dk] draw broadcast over
    the heads (head stride 0), v = x dt, log_a = dt A with A = -(1..nh)
    scaled to reach about -``a_max`` dt at the last head; dy [b, nh, S,
    dv] in v's dtype and dh [b, nh, dk, dv] in f32."""
    g = torch.Generator().manual_seed(seed)
    f = lambda *sh: torch.randn(sh, generator=g)  # noqa: E731
    if broadcast:
        q, k = (x.expand(b, nh, s, dk) for x in (f(b, 1, s, dk),
                                                   f(b, 1, s, dk)))
    else:
        q, k = f(b, nh, s, dk), f(b, nh, s, dk)
    dt = F.softplus(f(b, nh, s))
    a = -torch.arange(1, nh + 1, dtype=torch.float32) * (a_max / nh)
    log_a = dt * a[None, :, None]
    v = f(b, nh, s, dv) * dt[..., None]
    h0 = f(b, nh, dk, dv) * h0_scale
    dy, dh = f(b, nh, s, dv), f(b, nh, dk, dv)
    to = lambda x: x.to(dtype).to(device)  # noqa: E731
    return (to(q), to(k), to(v), log_a.to(device), h0.to(device), to(dy),
            dh.to(device))


# ---------------------------------------------------------------------------
# the route
# ---------------------------------------------------------------------------

def _stand_in(shape, dtype=torch.bfloat16, device="cuda"):
    return SimpleNamespace(shape=shape, dtype=dtype,
                           device=torch.device(device))


def _route(dk=64, dv=64, dtype=torch.bfloat16, device="cuda",
           a_dtype=torch.float32, h_dtype=torch.float32):
    q = _stand_in((1, 80, 4096, dk), dtype, device)
    v = _stand_in((1, 80, 4096, dv), dtype, device)
    return ss._bwd_takes_kernel(q, v, _stand_in((1, 80, 4096), a_dtype),
                                _stand_in((1, 80, dk, dv), h_dtype))


@pytest.mark.parametrize("kw,takes", [
    ({}, True),                                 # zamba2's Mamba2 scans
    ({"dk": 16, "dv": 64}, True),               # the smoke configs'
    ({"dk": 128, "dv": 128}, False),            # one tiling: <64, 64>
    ({"dk": 8, "dv": 8}, True),
    ({"dk": 64, "dv": 120}, False),
    ({"dk": 512, "dv": 513}, False),            # xlstm's mLSTM
    ({"dk": 512, "dv": 512}, False),
    ({"dk": 136, "dv": 64}, False),
    ({"dk": 64, "dv": 12}, False),
    ({"dk": 20, "dv": 64}, False),
    ({"dtype": torch.float32}, False),
    ({"dtype": torch.float16}, False),
    ({"device": "cpu"}, False),
    ({"device": "meta"}, False),
    ({"a_dtype": torch.bfloat16}, False),
    ({"h_dtype": torch.bfloat16}, False),
])
def test_backward_takes_the_kernel_only_where_it_can(kw, takes):
    assert _route(**kw) is takes


def test_backward_route_keeps_real_cpu_and_meta_tensors_plain():
    for device in ("cpu", "meta"):
        q = torch.zeros(1, 2, 8, 64, dtype=torch.bfloat16, device=device)
        assert not ss._bwd_takes_kernel(q, q, torch.zeros(1, 2, 8),
                                        torch.zeros(1, 2, 64, 64))


def test_cpu_route_is_the_plain_vjp_and_asks_for_no_kernel(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the CPU route asked for the backward kernel")

    monkeypatch.setattr(ss, "_bwd_launch", refuse)
    before = ss.backward_launches
    q, k, v, log_a, h0, dy, dh = _inputs(2, 3, 70, 16, 8, seed=1,
                                         a_max=1.0)
    leaves = [x.clone().requires_grad_() for x in (q, k, v, log_a, h0)]
    y, h = ss.ssd_scan_fwd(*leaves)
    got = torch.autograd.grad((y, h), leaves, (dy, dh))
    want = ssd_scan_bwd(q, k, v, log_a, h0, dy, dh)
    assert ss.backward_launches == before
    for name, g, w in zip(("dq", "dk", "dv", "dlog_a", "dh0"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        scale = max(float(w.abs().max()), 1e-12)
        assert float((g - w).abs().max()) <= 1e-5 * scale, name


@pytest.fixture
def kernel_route(monkeypatch):
    """CPU tensors through ``_SsdScanFn`` as on the card: the forward
    launch replaced by the plain scan, the backward's predicate true and
    its launch by the plain backward. Returns the launches' records."""
    calls = []

    def launch(q, k, v, log_a, h0):
        with torch.no_grad():
            return ssd_scan_ref(q, k, v, log_a, h0)

    def bwd_launch(q, k, v, log_a, h0, dy, dh_final, want_dh0):
        calls.append({"dy": dy is not None, "dh": dh_final is not None,
                      "want_dh0": want_dh0, "v_as_is":
                      ss._copyable16(v) is v,
                      "dy_as_is": dy is None or ss._copyable16(dy) is dy,
                      "qk_head_stride": (q.stride(1), k.stride(1))})
        dq, dk, dv, dla, dh0 = ssd_scan_bwd(q, k, v, log_a, h0, dy,
                                            dh_final)
        return dq, dk, dv, dla, dh0 if want_dh0 else None

    monkeypatch.setattr(ss, "_launch", launch)
    monkeypatch.setattr(ss, "_bwd_takes_kernel", lambda *a: True)
    monkeypatch.setattr(ss, "_bwd_launch", bwd_launch)
    monkeypatch.setattr(ss, "ssd_scan_fwd",
                        lambda *a: ss._SsdScanFn.apply(*a))
    return calls


@pytest.mark.parametrize("h0_grad", [True, False])
@pytest.mark.parametrize("cotangents", ["both", "y_only", "h_only"])
def test_function_passes_none_cotangents_and_needs_input_grad(
        kernel_route, cotangents, h0_grad):
    q, k, v, log_a, h0, dy, dh = _inputs(1, 3, 40, 16, 8, seed=2,
                                         a_max=1.0)

    def grads(fn):
        leaves = [x.clone().requires_grad_()
                  for x in (q[:, :1], k[:, :1], v, log_a)]
        hh = h0.clone().requires_grad_(h0_grad)
        y, h = fn(leaves[0].expand(q.shape), leaves[1].expand(k.shape),
                  *leaves[2:], hh)
        outs = {"both": [(y, dy), (h, dh)], "y_only": [(y, dy)],
                "h_only": [(h, dh)]}[cotangents]
        inputs = leaves + ([hh] if h0_grad else [])
        got = torch.autograd.grad([o for o, _ in outs], inputs,
                                  [c for _, c in outs], allow_unused=True)
        return [torch.zeros_like(x) if g is None else g
                for g, x in zip(got, inputs)]

    got = grads(ss.ssd_scan_fwd)
    want = grads(ssd_scan_ref)
    assert kernel_route == [{
        "dy": cotangents != "h_only", "dh": cotangents != "y_only",
        "want_dh0": h0_grad, "v_as_is": True, "dy_as_is": True,
        "qk_head_stride": (0, 0)}]
    for g, w in zip(got, want):
        scale = max(float(w.abs().max()), 1e-12)
        assert float((g - w).abs().max()) <= 1e-5 * scale


def test_trainer_layouts_reach_the_kernel_without_a_copy(kernel_route):
    """``ssm.mamba_ssd`` as the published Zamba2 runs it (bf16, 64-wide
    heads and state, B and C one group): v and the dy its autograd hands
    back are read as they are, B and C at head stride 0, and h0 (zeros,
    no gradient) gets no dh0."""
    cfg = get_smoke_config("zamba2-2.7b")
    assert cfg.attn_impl == "flash" and cfg.dtype == "bfloat16"
    nh, hd, n, s = 4, 64, 64, 24
    g = torch.Generator().manual_seed(3)
    conv = torch.randn((1, s, nh * hd + 2 * n), generator=g).bfloat16()
    dt_raw = torch.randn((1, s, nh), generator=g)
    params = {"dt_bias": torch.zeros(nh), "d_skip": torch.ones(nh)}
    conv.requires_grad_()
    y, _ = ssm.mamba_ssd(conv, dt_raw, -torch.arange(1.0, nh + 1), params,
                         cfg, nh, hd)
    y.float().square().sum().backward()
    assert kernel_route == [{"dy": True, "dh": False, "want_dh0": False,
                             "v_as_is": True, "dy_as_is": True,
                             "qk_head_stride": (0, 0)}]


def _global_kernels(src: str):
    """(name, template head, parameter list) of every ``__global__``."""
    out = []
    for m in re.finditer(r"((?:template\s*<[^>]*>\s*)?)__global__\s+void\s+"
                         r"(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*"
                         r"\(([^)]*)\)", src):
        out.append((m.group(2), m.group(1), m.group(3)))
    return out


def test_backward_kernel_names_hold_no_forward_stem():
    src = (_build.CSRC / "ssd_scan.cu").read_text()
    kernels = _global_kernels(src)
    bwd = [k for k in kernels if "bwd" in k[0]]
    fwd = [k for k in kernels if "bwd" not in k[0]]
    assert {name for name, _, _ in bwd} == {
        "ssd_bwd_states_kernel", "ssd_bwd_chunk_kernel"}
    assert fwd and all(name.startswith("ssd_scan_") for name, _, _ in fwd)
    for name, template, params in bwd:
        assert "ssd_scan_" not in name + template + params, name
        # the argument types named in the list, and their namespaces
        for word in re.findall(r"\w+", template + params):
            assert "ssd_scan" not in word, (name, word)
    for space in re.findall(r"namespace\s+(\w+)", src):
        assert "ssd_scan" not in space
    assert "int ssd_bwd_bf16(" in src


# ---------------------------------------------------------------------------
# the kernel's decomposition, modelled in f32
# ---------------------------------------------------------------------------

def _bf(x):
    return x.to(torch.bfloat16).float()


def _plan(q, k, v, log_a, h0, dy, dh, rounding):
    """The backward as the kernel computes it (a test aid in f32, not a
    mirror of its code): 64-step chunks; pass 1 the state H at each
    chunk's start (forward from h0: H' = exp(total) H + k^T (w o v)) and
    the cotangent dH at each chunk's end (back from dh: dH = exp(total)
    dH' + q^T (e o dy)); pass 2 each chunk's dq, dk, dv and dlog_a. With
    ``rounding``, every f32 operand of a product (w o v, e o dy, H, dH,
    dP o gate, G) is split into bf16 hi + lo, the bf16 inputs go in as
    they are. dy and dh may be None."""
    def hl(x):
        if not rounding:
            return x
        hi = _bf(x)
        return hi + _bf(x - hi)

    b, nh, s, dk = q.shape
    dv = v.shape[-1]
    nc = -(-s // CHUNK)
    pad = nc * CHUNK - s
    dy = torch.zeros(v.shape) if dy is None else dy

    def chunks(x):
        return F.pad(x.float(), (0, 0, 0, pad)).reshape(b, nh, nc, CHUNK, -1)

    Q, K, V, DY = (chunks(x) for x in (q, k, v, dy))
    cum = F.pad(log_a.float(), (0, pad)).reshape(b, nh, nc, CHUNK).cumsum(-1)
    total = cum[..., -1]
    e, w = torch.exp(cum), torch.exp(total[..., None] - cum)
    h, hs = h0.float(), []
    for c in range(nc):
        hs.append(h)
        h = torch.exp(total[:, :, c])[..., None, None] * h + torch.einsum(
            "bhjd,bhjv->bhdv", K[:, :, c], hl(w[:, :, c, :, None]
                                              * V[:, :, c]))
    d_h = torch.zeros_like(h) if dh is None else dh.float()
    dhs = [None] * nc
    for c in reversed(range(nc)):
        dhs[c] = d_h
        d_h = torch.exp(total[:, :, c])[..., None, None] * d_h + torch.einsum(
            "bhid,bhiv->bhdv", Q[:, :, c], hl(e[:, :, c, :, None]
                                              * DY[:, :, c]))
    H, dH = hl(torch.stack(hs, 2)), hl(torch.stack(dhs, 2))
    causal = torch.ones(CHUNK, CHUNK, dtype=torch.bool).tril()
    gate = torch.where(causal, torch.exp(torch.clamp(
        cum[..., :, None] - cum[..., None, :], max=0.0)), 0.0)
    S = torch.einsum("bhcid,bhcjd->bhcij", Q, K)
    dP_raw = torch.einsum("bhciv,bhcjv->bhcij", DY, V)
    G, dP = S * gate, dP_raw * gate
    dq_inter = e[..., None] * torch.einsum("bhciv,bhcdv->bhcid", DY, H)
    dk_inter = w[..., None] * torch.einsum("bhcjv,bhcdv->bhcjd", V, dH)
    dv_inter = w[..., None] * torch.einsum("bhcjd,bhcdv->bhcjv", K, dH)
    dq = dq_inter + torch.einsum("bhcij,bhcjd->bhcid", hl(dP), K)
    dk = dk_inter + torch.einsum("bhcij,bhcid->bhcjd", hl(dP), Q)
    dvv = dv_inter + torch.einsum("bhcij,bhciv->bhcjv", hl(G), DY)
    M = G * dP_raw * (1.0 - torch.eye(CHUNK))        # the diagonal left out
    x = M.sum(-1) - M.sum(-2) + (Q * dq_inter).sum(-1)
    y = (K * dk_inter).sum(-1)
    carry = torch.exp(total) * (H * dH).sum((-2, -1))
    dla = (x.flip(-1).cumsum(-1).flip(-1) + y.cumsum(-1) - y
           + carry[..., None]).reshape(b, nh, -1)[..., :s]

    def unchunk(x):
        return x.reshape(b, nh, nc * CHUNK, -1)[:, :, :s]

    return unchunk(dq), unchunk(dk), unchunk(dvv), dla, d_h


PLAN_CASES = [  # (S, dk, dv, h0_scale, cotangents)
    (40, 16, 8, 0.5, "both"),                   # below one chunk
    (64, 16, 16, 0.5, "both"),
    (130, 32, 16, 0.5, "both"),                 # ragged, three chunks
    (300, 16, 24, 0.0, "y_only"),
    (129, 8, 16, 0.5, "h_only"),
]


@pytest.mark.parametrize("s,dk,dv,h0_scale,cot", PLAN_CASES)
def test_decomposition_is_the_chunked_vjp(s, dk, dv, h0_scale, cot):
    q, k, v, log_a, h0, dy, dh = _inputs(2, 3, s, dk, dv, seed=s,
                                         h0_scale=h0_scale, a_max=4.0)
    dy = None if cot == "h_only" else dy
    dh = None if cot == "y_only" else dh
    got = _plan(q, k, v, log_a, h0, dy, dh, rounding=False)
    want = ssd_scan_bwd(q, k, v, log_a, h0, dy, dh)
    for name, g, w in zip(("dq", "dk", "dv", "dlog_a", "dh0"), got, want):
        assert g.shape == w.shape, name
        scale = max(float(w.abs().max()), 1e-12)
        assert float((g - w).abs().max()) <= 1e-4 * scale, name


def _head_rel(got, want):
    """The largest error of any (batch, head) over that head's peak."""
    err = (got - want).abs().flatten(2).amax(-1)
    return float((err / want.abs().flatten(2).amax(-1).clamp_min(1e-30))
                 .max())


def test_rounding_plan_stays_under_the_gates():
    """bf16 inputs at zamba2's widths (dk = dv = 64, Mamba2's decays up
    to ~-80 a step), eight chunks: each bf16 gradient in f32, before its
    own rounding, within 1e-3 of its head's peak of the f32 backward (a
    one-ulp bf16 flip of the output, 2^-7, is what the card's 8e-3 gate
    leaves room for); dlog_a and dh0 within 1e-3 of their peaks (the
    card's gate on dlog_a: 2e-3)."""
    q, k, v, log_a, h0, dy, dh = _inputs(1, 8, 512, 64, 64, seed=7,
                                         dtype=torch.bfloat16)
    got = _plan(q, k, v, log_a, h0, dy, dh, rounding=True)
    want = ssd_scan_bwd(q.float(), k.float(), v.float(), log_a, h0,
                        dy.float(), dh)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert _head_rel(g, w) <= 1e-3, name
    for name, g, w in zip(("dlog_a", "dh0"), got[3:], want[3:]):
        assert float((g - w).abs().max()) <= 1e-3 * float(w.abs().max()), \
            name


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel runs only on the card")
    return torch.device("cuda")


CARD_CASES = [  # (b, nh, S, dk, dv, h0_scale, cotangents, broadcast, a_max)
    (1, 4, 40, 64, 64, 0.5, "both", True, 80.0),      # below one chunk
    (2, 3, 200, 64, 64, 0.5, "both", True, 80.0),     # ragged
    (1, 4, 129, 64, 64, 0.0, "y_only", True, 80.0),   # as the trainer
    (1, 3, 65, 16, 64, 0.5, "h_only", True, 2.0),     # the smoke dk
    (2, 2, 150, 64, 64, 0.5, "both", False, 80.0),
    (1, 2, 100, 32, 64, 0.5, "both", True, 80.0),
    (1, 2, 70, 64, 48, 0.5, "both", True, 2.0),
    (1, 2, 1, 64, 64, 0.5, "both", True, 80.0),
    (1, 2, 64, 24, 40, 0.5, "both", False, 80.0),     # padded widths
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,nh,s,dk,dv,h0_scale,cot,broadcast,a_max",
                         CARD_CASES)
def test_kernel_matches_the_plain_backward(cuda, b, nh, s, dk, dv, h0_scale,
                                           cot, broadcast, a_max):
    q, k, v, log_a, h0, dy, dh = _inputs(
        b, nh, s, dk, dv, seed=s + dk, dtype=torch.bfloat16,
        h0_scale=h0_scale, broadcast=broadcast, device=cuda, a_max=a_max)
    dy = None if cot == "h_only" else dy
    dh = None if cot == "y_only" else dh
    assert ss._bwd_takes_kernel(q, v, log_a, h0)
    before = ss.backward_launches
    got = ss._bwd_launch(q, k, v, log_a, h0, dy, dh, True)
    want = ssd_scan_bwd(q, k, v, log_a, h0, dy, dh)
    torch.cuda.synchronize()
    assert ss.backward_launches == before + 2
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert bool(torch.isfinite(g.float()).all()), name
        assert _head_rel(g.float(), w.float()) <= 8e-3, name
    for name, g, w, tol in (("dlog_a", got[3], want[3], 2e-3),
                            ("dh0", got[4], want[4], 1e-4)):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        peak = max(float(w.abs().max()), 1e-30)
        assert float((g - w).abs().max()) <= tol * peak, name


@pytest.mark.cuda
def test_function_on_the_card_routes_by_dtype(cuda):
    """A bf16 call's backward is the kernel (two launches); an f32 call's
    is the plain VJP; h0 that needs no gradient gets none."""
    for dtype, launched in ((torch.bfloat16, 2), (torch.float32, 0)):
        q, k, v, log_a, h0, dy, _ = _inputs(1, 2, 96, 64, 64, seed=4,
                                            dtype=dtype, device=cuda)
        leaves = [x.detach().clone().requires_grad_()
                  for x in (q[:, :1], k[:, :1], v, log_a)]
        before = ss.backward_launches
        y, _ = ss.ssd_scan_fwd(leaves[0].expand(q.shape),
                               leaves[1].expand(k.shape), *leaves[2:], h0)
        got = torch.autograd.grad(y, leaves, dy)
        torch.cuda.synchronize()
        assert ss.backward_launches == before + launched
        assert all(g is not None and g.dtype == x.dtype
                   for g, x in zip(got, leaves))


def test_chip_smoke_counts_one_backward_a_layer_and_peer(monkeypatch):
    """``chip_smoke.py``'s train_zamba2 and train_recurrent hold the card
    to one backward call, two launches, a Mamba2 layer and peer a step
    (as many as the forward's, which remat repeats); xlstm's mLSTM takes
    none; its profiles name the backward's kernels among the port's
    own."""
    import os
    import sys

    from portbench import spec

    monkeypatch.syspath_prepend(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    z, port_kernels = chip_smoke.ZAMBA2_PUBLISHED, chip_smoke.PORT_KERNELS
    recurrent = chip_smoke.TRAIN_RECURRENT
    sys.modules.pop("chip_smoke", None)
    bench = spec.Bench()
    cfg = bench.entry("fl_train_zamba2").port_config(
        bench.config(z["config"]))
    assert z["ssd_bwd_per_step"] == 2 * z["peers"] * cfg.num_layers == 216
    assert z["ssd_bwd_per_step"] == z["ssd_per_step"]
    assert (recurrent["zamba2-2.7b"]["ssd_bwd_per_step"]
            == recurrent["zamba2-2.7b"]["ssd_per_step"] == 360)
    assert recurrent["xlstm-350m"]["ssd_bwd_per_step"] == 0
    assert "ssd_bwd_" in port_kernels and "ssd_scan_" in port_kernels


def test_forced_build_reports_a_library_already_built(monkeypatch, tmp_path):
    """``build_all`` skips a library that is there and reports nothing
    of it; with ``force`` it compiles it again and reports its ptxas log
    (``chip_smoke.py``'s spill gate of the ``ssd_bwd_`` kernels reads
    that log)."""
    from repro_torch.kernels import _build

    class FakeNvcc:
        def __init__(self, cmd, **kw):
            Path(cmd[cmd.index("-o") + 1]).write_bytes(b"lib")
            self.returncode = 0

        def communicate(self):
            return "ptxas info    : Used 64 registers", None

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", FakeNvcc)
    assert set(_build.build_all(["ssd_scan"])) == {"ssd_scan"}
    assert _build.build_all(["ssd_scan"]) == {}
    report = _build.build_all(["ssd_scan"], force=True)
    assert "Used 64 registers" in report["ssd_scan"]["log"]
    assert [p.name for p in tmp_path.iterdir()] == [
        _build._library_path("ssd_scan").name]
