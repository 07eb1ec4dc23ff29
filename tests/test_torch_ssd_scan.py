"""The port's SSD scan (plain versions, wrapper, layout checks) against the
JAX package's.

On the CPU the port's ``ops.ssd_scan`` runs the kernel's plain version,
the sequential ``ref.ssd_scan_ref``; the prefill's ``"xla"`` path runs
``models.ssm.chunked_linear_scan``. Both are held against the
reference's sequential oracle (``repro.kernels.ref.ssd_scan_ref``) and
its Pallas kernel through ``repro.kernels.ops.ssd_scan`` (interpret
mode on the CPU, as the reference's own tests run it), on the same
numpy-made inputs: the reference's sweep (``tests/test_kernels.py``)
plus a ragged S, S=1, an odd dv (mLSTM's appended ones column) and q, k
broadcast over the heads with a head stride of 0 (Mamba2's B and C).
The CUDA kernel itself is held against the same plain version on the
card by ``chip_smoke.py``; here its layout contract is checked against
the scan inputs every ssm and hybrid config makes, and an f32 model of
its bf16 rounding points (the gated scores and w o v rounded to bf16,
H split into bf16 hi + lo for q . H) is held against the sequential scan
at both families' widths and decay rates.

Tolerances: f32 1e-5 against the reference's same-order oracle (both
scan step by step in f32); 1e-4 against its chunked paths (the
reference's own bound between its chunked paths and its oracle);
bf16 the reference's ``_tol(bfloat16) * 8`` (0.16 absolute, 0.08
relative): the inputs round to bf16 identically on both sides, y
rounds once more. The rounding model: within 5e-3 of the largest |y|
and |h| (a quarter of ``chip_smoke.py``'s 2e-2 bf16 gate, which also
has to cover y's own rounding to bf16, up to 2^-7 of an element).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.ssm import chunked_linear_scan as j_chunked

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import ssd_scan as ss
from repro_torch.models import ssm
from repro_torch.models.ssm import chunked_linear_scan

BF16_ATOL, BF16_RTOL = 2e-2 * 8, 2e-2 * 4


def _inputs(rng, b, nh, s, dk, dv, dtype, h0_scale=0.1, shared_qk=False):
    """(torch inputs, JAX inputs): q, k ~ N(0,1) and N(0, 0.3²), v ~
    N(0,1), log_a in -[0.01, 0.5], h0 ~ N(0, h0_scale²). With
    ``shared_qk`` q and k are one [b, 1, s, dk] draw broadcast over the
    heads (a head stride of 0 on the torch side)."""
    qk_heads = 1 if shared_qk else nh
    q = rng.normal(size=(b, qk_heads, s, dk)).astype(np.float32)
    k = (rng.normal(size=(b, qk_heads, s, dk)) * 0.3).astype(np.float32)
    v = rng.normal(size=(b, nh, s, dv)).astype(np.float32)
    a = -rng.uniform(0.01, 0.5, size=(b, nh, s)).astype(np.float32)
    h0 = (rng.normal(size=(b, nh, dk, dv)) * h0_scale).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tq, tk = (torch.from_numpy(x).to(tdt).expand(b, nh, s, dk)
              for x in (q, k))
    jq, jk = (jnp.broadcast_to(jnp.asarray(x).astype(jdt), (b, nh, s, dk))
              for x in (q, k))
    return ((tq, tk, torch.from_numpy(v).to(tdt), torch.from_numpy(a),
             torch.from_numpy(h0)),
            (jq, jk, jnp.asarray(v).astype(jdt), jnp.asarray(a),
             jnp.asarray(h0)))


def _close(got, want, atol, rtol=None):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=atol if rtol is None else rtol)


def _check_pair(got, want, dtype, f32_tol):
    (y, h), (yr, hr) = got, want
    assert y.shape == tuple(yr.shape) and h.shape == tuple(hr.shape)
    assert h.dtype == torch.float32
    if dtype == "float32":
        _close(y, yr, f32_tol)
        _close(h, hr, f32_tol)
    else:
        _close(y, yr, BF16_ATOL, BF16_RTOL)
        _close(h, hr, BF16_ATOL, BF16_RTOL)


SWEEP = [(2, 3, 128, 16, 32), (1, 2, 64, 8, 8), (2, 1, 96, 32, 16)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,nh,s,dk,dv", SWEEP)
def test_ssd_scan_sweep(b, nh, s, dk, dv, dtype):
    """The reference's sweep: the port's oracle and its chunked path
    against the reference's oracle and its Pallas kernel."""
    rng = np.random.default_rng(42)
    t_in, j_in = _inputs(rng, b, nh, s, dk, dv, dtype)
    y, h = ops.ssd_scan(*t_in)
    assert y.dtype == t_in[2].dtype
    j_ref = jref.ssd_scan_ref(*j_in)
    j_pallas = jops.ssd_scan(*j_in)
    _check_pair((y, h), j_ref, dtype, 1e-5)
    _check_pair((y, h), j_pallas, dtype, 1e-4)
    _check_pair(chunked_linear_scan(*t_in), j_pallas, dtype, 1e-4)
    _check_pair(chunked_linear_scan(*t_in), j_ref, dtype, 1e-4)


@pytest.mark.parametrize("case,b,nh,s,dk,dv,shared", [
    ("ragged", 1, 2, 100, 16, 8, False),     # Pallas halves its chunk to 4
    ("s1", 2, 2, 1, 8, 8, False),
    ("dv_odd", 1, 2, 40, 16, 17, False),     # mLSTM: hd + 1 columns
    ("broadcast_qk", 2, 5, 48, 16, 8, True),  # Mamba2: B, C over heads
])
def test_ssd_scan_edge_cases(case, b, nh, s, dk, dv, shared):
    rng = np.random.default_rng(7)
    t_in, j_in = _inputs(rng, b, nh, s, dk, dv, "float32", h0_scale=0.5,
                         shared_qk=shared)
    if shared:
        assert t_in[0].stride(1) == 0 and t_in[1].stride(1) == 0
    got = ops.ssd_scan(*t_in)
    _check_pair(got, jref.ssd_scan_ref(*j_in), "float32", 1e-5)
    _check_pair(got, jops.ssd_scan(*j_in), "float32", 1e-4)
    _check_pair(chunked_linear_scan(*t_in), jref.ssd_scan_ref(*j_in),
                "float32", 1e-4)


def test_chunked_scan_matches_reference_chunked_at_a_small_chunk():
    """Several chunks (chunk 16 over S=64): the port's chunked path
    against the reference's, and both against the oracle."""
    rng = np.random.default_rng(3)
    t_in, j_in = _inputs(rng, 1, 2, 64, 8, 16, "float32", h0_scale=0.0)
    got = chunked_linear_scan(*t_in, chunk=16)
    _check_pair(got, j_chunked(*j_in, chunk=16), "float32", 1e-5)
    _check_pair(got, jref.ssd_scan_ref(*j_in), "float32", 1e-4)


def test_padded_steps_leave_the_state_exact():
    """a = 0, k = 0 steps (the kernel's masked tail) change nothing: the
    state after S steps plus zero steps is the state after S steps."""
    rng = np.random.default_rng(5)
    (q, k, v, a, h0), _ = _inputs(rng, 1, 2, 20, 8, 5, "float32",
                                  h0_scale=0.5)
    pad = 12
    q2, k2, v2 = (torch.cat([x, torch.zeros(1, 2, pad, x.shape[-1])], 2)
                  for x in (q.contiguous(), k.contiguous(), v))
    a2 = torch.cat([a, torch.zeros(1, 2, pad)], 2)
    y, h = ref.ssd_scan_ref(q, k, v, a, h0)
    y2, h2 = ref.ssd_scan_ref(q2, k2, v2, a2, h0)
    torch.testing.assert_close(h2, h, rtol=0, atol=0)
    torch.testing.assert_close(y2[:, :, :20], y, rtol=0, atol=0)


def test_large_decays_stay_finite():
    """Mamba's decay rates (dt*A down to about -55 a step): the chunked
    path masks before the exp, so no inf * 0 turns into NaN."""
    rng = np.random.default_rng(11)
    (q, k, v, _, h0), _ = _inputs(rng, 1, 3, 64, 8, 8, "float32")
    a = -torch.from_numpy(rng.uniform(0.0, 55.0, size=(1, 3, 64))
                          .astype(np.float32))
    y, h = chunked_linear_scan(q, k, v, a, h0, chunk=32)
    yr, hr = ref.ssd_scan_ref(q, k, v, a, h0)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    torch.testing.assert_close(y, yr, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(h, hr, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# dispatch, launch counts and layout checks
# ---------------------------------------------------------------------------

def test_cpu_path_is_plain_and_counts_no_launch():
    rng = np.random.default_rng(0)
    t_in, _ = _inputs(rng, 1, 2, 10, 8, 3, "float32")
    ops.reset_launch_counts()
    y, h = ss.ssd_scan_fwd(*t_in)
    yr, hr = ref.ssd_scan_ref(*t_in)
    torch.testing.assert_close(y, yr, rtol=0, atol=0)
    torch.testing.assert_close(h, hr, rtol=0, atol=0)
    assert ops.launch_counts()["ssd_scan"] == 0


def test_non_cpu_tensors_never_fall_back(monkeypatch):
    """Off the CPU the scan goes to the kernel or raises; ``meta`` takes
    the plain version (shapes only, for the dry run) until it is taken
    off ``_build.PLAIN_DEVICES``."""
    meta = dict(device="meta")
    q = torch.empty(1, 2, 8, 16, **meta)
    y, _ = ss.ssd_scan_fwd(q, q, torch.empty(1, 2, 8, 4, **meta),
                           torch.empty(1, 2, 8, **meta),
                           torch.empty(1, 2, 16, 4, **meta))
    assert (y.device.type, y.shape) == ("meta", (1, 2, 8, 4))
    monkeypatch.setattr(_build, "PLAIN_DEVICES", ("cpu",))
    with pytest.raises(ValueError, match="CUDA device"):
        ss.ssd_scan_fwd(q, q, torch.empty(1, 2, 8, 4, **meta),
                        torch.empty(1, 2, 8, **meta),
                        torch.empty(1, 2, 16, 4, **meta))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layout_checks_accept_what_the_kernel_takes(dtype):
    f32 = dict(dtype=torch.float32)
    # zamba2: B and C broadcast over 80 heads; xlstm: dk 512, dv 513
    bq = torch.zeros(1, 1, 512, 64, dtype=dtype).expand(1, 80, 512, 64)
    ss.check_layout(bq, bq, torch.zeros(1, 80, 512, 64, dtype=dtype),
                    torch.zeros(1, 512, 80, **f32).transpose(1, 2),
                    torch.zeros(1, 80, 64, 64, **f32))
    q = torch.zeros(1, 512, 4, 512, dtype=dtype).transpose(1, 2)
    ss.check_layout(q, q, torch.zeros(1, 4, 512, 513, dtype=dtype),
                    torch.zeros(1, 4, 512, **f32),
                    torch.zeros(1, 4, 512, 513, **f32))
    # the narrowest and widest dk of the entry; v and log_a at odd strides
    # and offsets (the kernel loads them element by element)
    for dk in (8, ss.MAX_DK[dtype]):
        x = torch.zeros(2, 3, 5, dk, dtype=dtype)
        v = torch.zeros(2, 3, 5, 9, dtype=dtype)[..., 1:8]
        ss.check_layout(x, x, v, torch.zeros(2, 3, 7, **f32)[..., 1:6],
                        torch.zeros(2, 3, dk, 7, **f32))


def _bad(case):
    q, v = torch.zeros(1, 2, 8, 16), torch.zeros(1, 2, 8, 4)
    a, h0 = torch.zeros(1, 2, 8), torch.zeros(1, 2, 16, 4)
    bq, bv = q.bfloat16(), v.bfloat16()
    return {
        "f64": (q.double(), q.double(), v.double(), a, h0),
        "mixed": (q, q.bfloat16(), v, a, h0),
        "a_bf16": (q, q, v, a.bfloat16(), h0),
        "rank": (q[0], q[0], v, a, h0),
        "k_shape": (q, torch.zeros(1, 2, 8, 12), v, a, h0),
        "v_seq": (q, q, torch.zeros(1, 2, 9, 4), a, h0),
        "h0_shape": (q, q, v, a, torch.zeros(1, 2, 4, 16)),
        "dk_odd": (torch.zeros(1, 2, 8, 6), torch.zeros(1, 2, 8, 6), v, a,
                   torch.zeros(1, 2, 6, 4)),
        "dk_big": (torch.zeros(1, 1, 2, 1028), torch.zeros(1, 1, 2, 1028),
                   torch.zeros(1, 1, 2, 4), torch.zeros(1, 1, 2),
                   torch.zeros(1, 1, 1028, 4)),
        # bf16: 16-byte copies of q and k, dk <= 512
        "bf16_dk_not_8": (torch.zeros(1, 2, 8, 12).bfloat16(),
                          torch.zeros(1, 2, 8, 12).bfloat16(), bv, a,
                          torch.zeros(1, 2, 12, 4)),
        "bf16_dk_big": (torch.zeros(1, 1, 2, 520).bfloat16(),
                        torch.zeros(1, 1, 2, 520).bfloat16(),
                        torch.zeros(1, 1, 2, 4).bfloat16(),
                        torch.zeros(1, 1, 2), torch.zeros(1, 1, 520, 4)),
        "bf16_time_stride": (torch.zeros(1, 2, 8, 20).bfloat16()[..., :16],
                             bq, bv, a, h0),
        "bf16_head_stride": (bq, torch.zeros(2 * 132).bfloat16()
                             .as_strided((1, 2, 8, 16), (264, 132, 16, 1)),
                             bv, a, h0),
        "bf16_batch_stride": (torch.zeros(2 * 2 * 8 * 16 + 4).bfloat16()
                              .as_strided((2, 2, 8, 16), (260, 128, 16, 1)),
                              torch.zeros(2, 2, 8, 16).bfloat16(),
                              torch.zeros(2, 2, 8, 4).bfloat16(),
                              torch.zeros(2, 2, 8), torch.zeros(2, 2, 16, 4)),
        "bf16_base": (torch.zeros(2 * 8 * 16 + 4).bfloat16()[4:]
                      .view(1, 2, 8, 16), bq, bv, a, h0),
    }[case]


@pytest.mark.parametrize("case", ["f64", "mixed", "a_bf16", "rank",
                                  "k_shape", "v_seq", "h0_shape", "dk_odd",
                                  "dk_big", "bf16_dk_not_8", "bf16_dk_big",
                                  "bf16_time_stride", "bf16_head_stride",
                                  "bf16_batch_stride", "bf16_base"])
def test_layout_rejects_what_the_kernel_cannot_take(case):
    with pytest.raises((ValueError, TypeError)):
        ss.check_layout(*_bad(case))


def _scan_inputs_of(cfg, s=16):
    """The (q, k, v, log_a, h0) one prefill layer of ``cfg`` hands the scan,
    as the wrapper launches them (a tensor whose last axis is not
    contiguous copied): a Mamba2 layer (hybrid) or an mLSTM layer (ssm) at
    the config's full width, random weights, ``s`` steps, on the CPU."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((1, s, cfg.d_model), generator=gen).to(
        getattr(torch, cfg.dtype))
    seen = []

    def record(cfg_, q, k, v, log_a, h0):
        seen.append((q, k, v, log_a, h0))
        return chunked_linear_scan(q, k, v, log_a, h0)

    orig = ssm._scan
    ssm._scan = record
    try:
        if cfg.family == "hybrid":
            ssm.mamba_block(ssm.mamba_init(gen, cfg), x, cfg)
        else:
            ssm.mlstm_block(ssm.mlstm_init(gen, cfg), x, cfg)
    finally:
        ssm._scan = orig
    (q, k, v, log_a, h0), = seen
    q, k, v = (ss._unit_last(t) for t in (q, k, v))
    return q, k, v, log_a.float(), h0.float().contiguous()


RECURRENT = [a for a in ARCH_IDS
             if get_config(a).family in ("ssm", "hybrid")]


@pytest.mark.parametrize("arch", RECURRENT)
def test_every_recurrent_config_passes_the_layout_checks(arch):
    """The scan inputs of every registered ssm and hybrid config, strides
    and offsets as the model makes them, pass the kernel's layout
    checks: none would raise on the card."""
    cfg = get_config(arch)
    q, k, v, log_a, h0 = _scan_inputs_of(cfg)
    assert q.dtype == getattr(torch, cfg.dtype)
    ss.check_layout(q, k, v, log_a, h0)
    if cfg.family == "hybrid":                  # B and C: no copy
        assert q.stride(1) == 0 and k.stride(1) == 0


def test_ops_keep_the_reference_shape_checks():
    q, v = torch.zeros(1, 2, 8, 16), torch.zeros(1, 2, 8, 4)
    a, h0 = torch.zeros(1, 2, 8), torch.zeros(1, 2, 16, 4)
    with pytest.raises(ValueError, match="q/k shape"):
        ops.ssd_scan(q, torch.zeros(1, 2, 8, 12), v, a, h0)
    with pytest.raises(ValueError, match="v batch/seq"):
        ops.ssd_scan(q, q, torch.zeros(1, 2, 9, 4), a, h0)


def test_ssd_scan_source_builds_on_its_own():
    """One library per source: every quoted include of ssd_scan.cu names
    a shared header under csrc/ (which every build hashes), and both C
    entries are there."""
    assert "ssd_scan" in _build.sources()
    src = (_build.CSRC / "ssd_scan.cu").read_text()
    for line in src.splitlines():
        if line.startswith('#include "'):
            header = line.split('"')[1]
            assert "/" not in header and header.endswith(".cuh")
            assert (_build.CSRC / header).is_file()
    for entry in ss._ENTRY.values():
        assert f"int {entry}(" in src


# ---------------------------------------------------------------------------
# the bf16 kernel's precision plan, modelled in f32
# ---------------------------------------------------------------------------

def _rounding_plan(q, k, v, log_a, h0, chunk=64):
    """An f32 model of where the bf16 kernel rounds (a test aid, not a
    mirror of the kernel): per 64-step chunk, the gated scores G rounded
    to bf16 before G v; q . H as q . hi + q . lo with H split into bf16
    hi + lo; H' = exp(total) H + k^T (w o v) with w o v rounded to bf16;
    every sum in f32. Returns y in f32 (before its own rounding) and
    h_final."""
    def bf(x):
        return x.to(torch.bfloat16).float()

    q, k, v = q.float(), k.float(), v.float()
    h = h0.float().clone()
    ys = []
    for t0 in range(0, q.shape[2], chunk):
        qi, ki, vi = (x[:, :, t0:t0 + chunk] for x in (q, k, v))
        n = qi.shape[2]
        cum = log_a[:, :, t0:t0 + n].float().cumsum(-1)
        total = cum[..., -1]
        causal = torch.ones((n, n), dtype=torch.bool).tril()
        gate = torch.where(causal, torch.exp(torch.clamp(
            cum[..., :, None] - cum[..., None, :], max=0.0)), 0.0)
        g = bf(qi @ ki.transpose(-1, -2) * gate)
        hi = bf(h)
        lo = bf(h - hi)
        ys.append(g @ vi + torch.exp(cum)[..., None] * (qi @ hi + qi @ lo))
        vw = bf(vi * torch.exp(total[..., None] - cum)[..., None])
        h = h * torch.exp(total)[..., None, None] + ki.transpose(-1, -2) @ vw
    return torch.cat(ys, dim=2), h


def _family_inputs(family, s, seed=0):
    """bf16-valued inputs at a family's full width and decay rates, as
    ``chip_smoke.py`` draws them (numpy): zamba2, B and C one [S, 64] draw
    over 80 heads, log_a = dt A with A = -(1..80) and dt = softplus(N(0,
    1)) (down to about -55 a step), v = x dt; xlstm, q / sqrt(512), dv 513
    with mLSTM's ones column times a sigmoid gate, log_a = logsigmoid(N(0,
    1)). h0 ~ N(0, 0.5^2)."""
    rng = np.random.default_rng(seed)

    def t(x):
        return torch.from_numpy(np.asarray(x, np.float32))

    if family == "zamba2":
        nh, dk, dv = 80, 64, 64
        bc = t(rng.normal(size=(2, 1, 1, s, dk)))
        q, k = (x.expand(1, nh, s, dk) for x in bc)
        dt = F.softplus(t(rng.normal(size=(1, nh, s))))
        log_a = dt * -torch.arange(1, nh + 1, dtype=torch.float32)[:, None]
        v = t(rng.normal(size=(1, nh, s, dv))) * dt[..., None]
    else:
        nh, dk, dv = 4, 512, 513
        q = t(rng.normal(size=(1, nh, s, dk))) / math.sqrt(dk)
        k = t(rng.normal(size=(1, nh, s, dk)))
        v = torch.cat([t(rng.normal(size=(1, nh, s, dk))),
                       torch.ones((1, nh, s, 1))], dim=-1)
        v = v * torch.sigmoid(t(rng.normal(size=(1, nh, s))))[..., None]
        log_a = F.logsigmoid(t(rng.normal(size=(1, nh, s))))
    h0 = t(rng.normal(size=(1, nh, dk, dv)) * 0.5)
    q, k, v = (x.to(torch.bfloat16).float() for x in (q, k, v))
    return q, k, v, log_a, h0


@pytest.mark.parametrize("family", ["zamba2", "xlstm"])
def test_bf16_precision_plan_stays_under_the_gate(family):
    """At both families' widths and decay rates (S = 130: two chunks and
    two steps past them), the kernel's rounding points keep y and h_final
    within 5e-3 of the sequential f32 scan, relative to their largest
    magnitude, over the whole tensor and in every head against that
    head's own (zamba2's fast-decay heads hold smaller values): a quarter
    of the 2e-2 gate the kernel is held to on the card, the rest left for
    y's rounding to bf16."""
    q, k, v, log_a, h0 = _family_inputs(family, 130)
    y, h = _rounding_plan(q, k, v, log_a, h0)
    y_ref, h_ref = ref.ssd_scan_ref(q, k, v, log_a, h0)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    y_err = float((y - y_ref).abs().max() / y_ref.abs().max())
    h_err = float((h - h_ref).abs().max() / h_ref.abs().max())
    assert y_err <= 5e-3, y_err
    assert h_err <= 5e-3, h_err
    for got, want in ((y, y_ref), (h, h_ref)):
        per_head = ((got - want).abs().amax(dim=(2, 3))
                    / want.abs().amax(dim=(2, 3)))
        assert float(per_head.max()) <= 5e-3, per_head.max()
