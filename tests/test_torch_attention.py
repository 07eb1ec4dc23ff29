"""The port's attention kernels' plain versions against the JAX package.

On the CPU each wrapper of the port runs its kernel's plain version
(flash: ``flash_attention_ref`` with lse; dense decode:
``decode_attention_ref``; paged: ``gather_dense_decode``). They are held
against the reference's oracles (``repro.kernels.ref``), its XLA flash
forward (``attention_flash._flash_fwd_impl``, for lse) and its Pallas
kernels in interpret mode, on the same numpy-made inputs, at shapes from
``tests/test_kernels.py`` plus ragged lengths (the Pallas kernels in f32
and on a few shapes each: they are the same code in either dtype, and
the interpreter is slow). The CUDA kernels themselves are held against the same plain versions on the card by
``chip_smoke.py``.

Tolerances: f32 1e-5 (both sides sum in f32, in other orders); bf16
2e-2, as ``tests/test_kernels.py`` (inputs round to bf16 identically on
both sides; the outputs round once more, and the Pallas kernel keeps
its sums in bf16-fed f32 tiles).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention_fwd
from repro.kernels.flash_attention import flash_attention_fwd
from repro.kernels.paged_attention import (gather_dense_decode as
                                           j_gather_dense_decode)
from repro.kernels.paged_attention import paged_decode_attention_fwd
from repro.models.attention_flash import _flash_fwd_impl

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_attention as pa
from repro_torch.models import attention_flash

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _pair(rng, shape, dtype):
    """The same normal draws as a torch and a JAX array of ``dtype``."""
    x = rng.normal(size=shape).astype(np.float32)
    return (torch.from_numpy(x).to(getattr(torch, dtype)),
            jnp.asarray(x).astype(getattr(jnp, dtype)))


def _close(got, want, dtype, **kw):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype], **kw)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

FLASH_SHAPES = [
    (2, 128, 8, 2, 32),   # GQA 4:1
    (1, 256, 4, 4, 64),   # MHA
    (2, 64, 8, 1, 16),    # MQA
    (1, 96, 6, 2, 32),    # non-power seq
    (1, 24, 12, 1, 128),  # the CLI's default prompt length, path head dim
    (1, 100, 4, 2, 32),   # ragged: the TPU kernel halves bq to 4
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,kvh,d", FLASH_SHAPES)
def test_flash_matches_reference(b, s, h, kvh, d, dtype):
    rng = np.random.default_rng(s + h)
    (q, qj), (k, kj), (v, vj) = (_pair(rng, shp, dtype) for shp in
                                 [(b, s, h, d), (b, s, kvh, d),
                                  (b, s, kvh, d)])
    out = ops.flash_attention(q, k, v, causal=True)
    assert out.dtype == q.dtype and tuple(out.shape) == (b, s, h, d)
    _close(out, jref.flash_attention_ref(qj, kj, vj, causal=True), dtype)
    if dtype == "float32" and s in (128, 64, 100):
        _close(out, flash_attention_fwd(qj, kj, vj, True, interpret=True),
               dtype)


@pytest.mark.parametrize("b,s,h,kvh,d", [FLASH_SHAPES[0], FLASH_SHAPES[3],
                                         FLASH_SHAPES[5]])
def test_flash_lse_matches_xla_forward(b, s, h, kvh, d):
    """o and lse [b, kvh, g, s] against the reference's blockwise XLA
    forward (its q and kv chunks need not divide s: it shrinks them)."""
    rng = np.random.default_rng(7)
    (q, qj), (k, kj), (v, vj) = (_pair(rng, shp, "float32") for shp in
                                 [(b, s, h, d), (b, s, kvh, d),
                                  (b, s, kvh, d)])
    o_want, lse_want = _flash_fwd_impl(qj, kj, vj, True, 16, 32)
    o, lse = attention_flash.flash_fwd(q, k, v, True)
    assert lse.dtype == torch.float32
    assert tuple(lse.shape) == (b, kvh, h // kvh, s)
    _close(o, o_want, "float32")
    _close(lse, lse_want, "float32")


@pytest.mark.parametrize("causal", [True, False])
def test_flash_cross_lengths_and_noncausal(causal):
    rng = np.random.default_rng(3)
    (q, qj), (k, kj), (v, vj) = (_pair(rng, shp, "float32") for shp in
                                 [(1, 64, 4, 32), (1, 128, 4, 32),
                                  (1, 128, 4, 32)])
    out = ops.flash_attention(q, k, v, causal=causal)
    _close(out, jref.flash_attention_ref(qj, kj, vj, causal=causal),
           "float32")


def test_flash_autograd_backward_waits_for_lm_slice():
    """Once a pin that the backward raised until the LM-training slice;
    now that slice is here: the backward runs and is the gradient of o
    alone, so a gradient arriving for lse raises, as the reference's
    custom VJP of o has no lse cotangent."""
    q = torch.randn(1, 8, 2, 16, requires_grad=True)
    k = torch.randn(1, 8, 1, 16, requires_grad=True)
    v = torch.randn(1, 8, 1, 16)
    out = attention_flash.flash_attention(q, k, v)
    out.sum().backward()
    assert q.grad.shape == q.shape and k.grad.shape == k.shape
    assert bool(torch.isfinite(q.grad).all())
    o, lse = attention_flash.flash_fwd(q, k, v)
    with pytest.raises(NotImplementedError, match="lse takes no gradient"):
        (o.sum() + lse.sum()).backward()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [16, 64, 80])
@pytest.mark.parametrize("g", [1, 2, 4])
def test_flash_backward_matches_reference_vjp(g, d, causal):
    """dq, dk, dv of the port's flash attention (the plain forward on the
    CPU, the reference's blockwise recompute from (o, lse) in the
    backward) against ``jax.vjp`` of the reference's ``flash_attention``
    on the same inputs and cotangent: f32 within 1e-5. s = 24 is no
    multiple of the chunks asked for (16 and 10): ``_chunks`` blocks it
    by 12 and 8; GQA sums dk, dv over the g query heads."""
    import jax

    from repro.models.attention_flash import flash_attention as ref_flash

    rng = np.random.default_rng(10 * g + d)
    b, s, kvh = 2, 24, 2
    h = g * kvh
    (q, qj), (k, kj), (v, vj), (do, doj) = (
        _pair(rng, shp, "float32") for shp in
        [(b, s, h, d), (b, s, kvh, d), (b, s, kvh, d), (b, s, h, d)])
    _, vjp = jax.vjp(lambda a, b_, c: ref_flash(a, b_, c, causal, 16, 10),
                     qj, kj, vj)
    want = vjp(doj)
    leaves = [x.requires_grad_() for x in (q, k, v)]
    out = attention_flash.flash_attention(*leaves, causal, 16, 10)
    got = torch.autograd.grad(out, leaves, do)
    for gt, w in zip(got, want):
        assert gt.dtype == torch.float32
        _close(gt, w, "float32")


def test_flash_backward_keeps_the_input_dtypes():
    """bf16 inputs: the backward computes in f32 and returns bf16
    gradients, as the reference casts dq, dk, dv to the inputs'
    dtypes."""
    q, k, v = (torch.randn(1, 16, n, 32, dtype=torch.bfloat16,
                           requires_grad=True) for n in (4, 2, 2))
    attention_flash.flash_attention(q, k, v).float().sum().backward()
    assert {x.grad.dtype for x in (q, k, v)} == {torch.bfloat16}


# ---------------------------------------------------------------------------
# dense decode attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,kvh,d", [
    (2, 256, 8, 2, 32), (1, 512, 4, 4, 64), (3, 128, 6, 1, 16),
    (2, 98, 4, 2, 16), (2, 1030, 24, 2, 32),
])
def test_decode_matches_reference(b, s, h, kvh, d, dtype):
    rng = np.random.default_rng(s + b)
    (q, qj), (kc, kj), (vc, vj) = (_pair(rng, shp, dtype) for shp in
                                   [(b, h, d), (b, s, kvh, d),
                                    (b, s, kvh, d)])
    lens = np.concatenate([[1, s], rng.integers(1, s + 1, b)])[:b]
    lens = lens.astype(np.int32)
    out = ops.decode_attention(q, kc, vc, torch.from_numpy(lens))
    assert out.dtype == q.dtype and tuple(out.shape) == (b, h, d)
    _close(out, jref.decode_attention_ref(qj, kj, vj, jnp.asarray(lens)),
           dtype)
    if dtype == "float32" and s in (98, 1030):
        _close(out, decode_attention_fwd(qj, kj, vj, jnp.asarray(lens),
                                         interpret=True), dtype)


# ---------------------------------------------------------------------------
# paged decode attention
# ---------------------------------------------------------------------------

def _paged_inputs(rng, b, nblk, bs, h, kvh, d, dtype):
    nb = 1 + b * nblk
    (q, qj), (kp, kpj), (vp, vpj) = (_pair(rng, shp, dtype) for shp in
                                     [(b, h, d), (nb, bs, kvh, d),
                                      (nb, bs, kvh, d)])
    bt = rng.permutation(np.arange(1, nb)).reshape(b, nblk).astype(np.int32)
    # lengths 1, full and mid-page; the last row (if any) reads only the
    # scratch page 0, as an inactive engine row does
    lens = np.array([1, nblk * bs, bs + bs // 2 + 1][:b], np.int32)
    if b > 3:
        lens = np.concatenate([lens, rng.integers(1, nblk * bs, b - 3)])
    if b > 1:
        bt[-1] = 0
        lens[-1] = 1
    lens = lens.astype(np.int32)
    return ((q, kp, vp, torch.from_numpy(bt), torch.from_numpy(lens)),
            (qj, kpj, vpj, jnp.asarray(bt), jnp.asarray(lens)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,nblk,bs,h,kvh,d", [
    (2, 4, 16, 8, 2, 32), (1, 8, 8, 4, 4, 16), (3, 2, 32, 6, 1, 16),
    (5, 3, 16, 24, 2, 32),
])
def test_paged_matches_reference(b, nblk, bs, h, kvh, d, dtype):
    rng = np.random.default_rng(b * nblk + bs)
    t_in, j_in = _paged_inputs(rng, b, nblk, bs, h, kvh, d, dtype)
    out = ops.paged_decode_attention(*t_in)
    assert out.dtype == t_in[0].dtype and tuple(out.shape) == (b, h, d)
    assert bool(torch.isfinite(out).all())
    _close(out, jref.paged_decode_attention_ref(*j_in), dtype)
    _close(out, j_gather_dense_decode(*j_in), dtype)
    if dtype == "float32" and b in (2, 5):
        _close(out, paged_decode_attention_fwd(*j_in, interpret=True), dtype)


def test_port_oracles_match_reference_oracles():
    rng = np.random.default_rng(11)
    t_in, j_in = _paged_inputs(rng, 3, 4, 8, 8, 2, 16, "float32")
    _close(ref.paged_decode_attention_ref(*t_in),
           jref.paged_decode_attention_ref(*j_in), "float32")
    # gather_dense_decode is the paged kernel's plain version
    torch.testing.assert_close(pa.gather_dense_decode(*t_in),
                               ref.paged_decode_attention_ref(*t_in),
                               rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# dispatch, launch counts and layout checks
# ---------------------------------------------------------------------------

def test_cpu_paths_are_plain_and_count_no_launch():
    rng = np.random.default_rng(0)
    t_in, _ = _paged_inputs(rng, 2, 2, 4, 4, 2, 8, "float32")
    q4 = torch.randn(1, 6, 4, 8)
    kv4 = torch.randn(1, 6, 2, 8)
    ops.reset_launch_counts()
    o, lse = fa.flash_attention_fwd(q4, kv4, kv4)
    o_ref, lse_ref = ref.flash_attention_ref(q4, kv4, kv4)
    torch.testing.assert_close(o, o_ref, rtol=0, atol=0)
    torch.testing.assert_close(lse, lse_ref, rtol=0, atol=0)
    torch.testing.assert_close(pa.paged_decode_attention_fwd(*t_in),
                               pa.gather_dense_decode(*t_in), rtol=0, atol=0)
    kc = torch.randn(2, 5, 2, 8)
    lens = torch.tensor([1, 5], dtype=torch.int32)
    torch.testing.assert_close(
        da.decode_attention_fwd(t_in[0], kc, kc, lens),
        ref.decode_attention_ref(t_in[0], kc, kc, lens), rtol=0, atol=0)
    assert ops.launch_counts() == {"group_mean": 0, "flash_attention": 0,
                                   "decode_attention": 0,
                                   "paged_decode_attention": 0,
                                   "ssd_scan": 0}


def test_non_cpu_tensors_never_fall_back(monkeypatch):
    """A tensor that is not on the CPU goes to a kernel or raises; meta
    tensors (no data, no CUDA) must raise, not take the plain path, once
    ``meta`` is taken off ``_build.PLAIN_DEVICES`` (where it stands for
    the dry run, which computes shapes only)."""
    o, _ = fa.flash_attention_fwd(*(torch.empty(1, 8, h, 16, device="meta")
                                    for h in (4, 2, 2)))
    assert (o.device.type, o.shape) == ("meta", (1, 8, 4, 16))
    monkeypatch.setattr(_build, "PLAIN_DEVICES", ("cpu",))
    meta = dict(device="meta")
    q4, kv4 = torch.empty(1, 8, 4, 16, **meta), torch.empty(1, 8, 2, 16,
                                                            **meta)
    with pytest.raises(ValueError, match="CUDA device"):
        fa.flash_attention_fwd(q4, kv4, kv4)
    q3 = torch.empty(2, 4, 16, **meta)
    lens = torch.empty(2, dtype=torch.int32, **meta)
    with pytest.raises(ValueError, match="CUDA device"):
        da.decode_attention_fwd(q3, kv4.expand(2, 8, 2, 16), kv4.expand(
            2, 8, 2, 16), lens)
    pages = torch.empty(5, 4, 2, 16, **meta)
    bt = torch.empty(2, 2, dtype=torch.int32, **meta)
    with pytest.raises(ValueError, match="CUDA device"):
        pa.paged_decode_attention_fwd(q3, pages, pages, bt, lens)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layout_checks_accept_what_the_kernels_take(dtype):
    fa.check_layout(torch.zeros(1, 24, 24, 128, dtype=dtype),
                    torch.zeros(1, 24, 2, 128, dtype=dtype),
                    torch.zeros(1, 24, 2, 128, dtype=dtype))
    i32 = dict(dtype=torch.int32)
    da.check_layout(torch.zeros(8, 24, 128, dtype=dtype),
                    torch.zeros(8, 1000, 2, 128, dtype=dtype),
                    torch.zeros(8, 1000, 2, 128, dtype=dtype),
                    torch.ones(8, **i32))
    pa.check_layout(torch.zeros(8, 24, 128, dtype=dtype),
                    torch.zeros(289, 16, 2, 128, dtype=dtype),
                    torch.zeros(289, 16, 2, 128, dtype=dtype),
                    torch.zeros(8, 36, **i32), torch.ones(8, **i32))


def _config(arch, kind):
    return get_config(arch) if kind == "full" else get_smoke_config(arch)


#: every registered config (published and smoke) with a block that runs
#: attention through the flash kernel in prefill and a cache in decode
ATTN_CONFIGS = [(arch, kind) for arch in ARCH_IDS for kind in ("full", "smoke")
                if {"attn", "moe", "shared_attn"}
                & set(_config(arch, kind).block_pattern())]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch,kind", ATTN_CONFIGS)
def test_layout_checks_accept_every_config_head_shape(arch, kind, dtype):
    """The head dim and GQA grouping of each config pass the flash, dense
    decode and paged decode layout checks in both dtypes."""
    cfg = _config(arch, kind)
    h, kvh, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    z = dict(dtype=dtype)
    i32 = dict(dtype=torch.int32)
    fa.check_layout(torch.zeros(1, 24, h, d, **z),
                    torch.zeros(1, 24, kvh, d, **z),
                    torch.zeros(1, 24, kvh, d, **z))
    da.check_layout(torch.zeros(2, h, d, **z), torch.zeros(2, 40, kvh, d, **z),
                    torch.zeros(2, 40, kvh, d, **z), torch.ones(2, **i32))
    pa.check_layout(torch.zeros(2, h, d, **z), torch.zeros(5, 16, kvh, d, **z),
                    torch.zeros(5, 16, kvh, d, **z), torch.zeros(2, 2, **i32),
                    torch.ones(2, **i32))


def test_attention_configs_cover_the_served_head_shapes():
    shapes = {(_config(a, k).head_dim,
               _config(a, k).num_heads // _config(a, k).num_kv_heads)
              for a, k in ATTN_CONFIGS}
    assert {(128, 12), (80, 1), (32, 4)} <= shapes    # starcoder2, zamba2
    assert ("xlstm-350m", "full") not in ATTN_CONFIGS  # no attention


def _off_by_one(dtype, *shape):
    """A contiguous view that starts one element into its storage, so its
    data is not 16-byte aligned."""
    return torch.zeros(math.prod(shape) + 1, dtype=dtype)[1:].view(*shape)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layouts_reject_a_view_off_16_byte_alignment(dtype):
    z = dict(dtype=dtype)
    q, kv = torch.zeros(1, 8, 4, 16, **z), torch.zeros(1, 8, 2, 16, **z)
    for args in [(_off_by_one(dtype, 1, 8, 4, 16), kv, kv),
                 (q, _off_by_one(dtype, 1, 8, 2, 16), kv),
                 (q, kv, _off_by_one(dtype, 1, 8, 2, 16))]:
        assert args[0].is_contiguous()
        with pytest.raises(ValueError, match="aligned"):
            fa.check_layout(*args)
    q3, kc = torch.zeros(2, 4, 16, **z), torch.zeros(2, 8, 2, 16, **z)
    lens = torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="aligned"):
        da.check_layout(_off_by_one(dtype, 2, 4, 16), kc, kc, lens)
    pages = torch.zeros(5, 4, 2, 16, **z)
    bt = torch.zeros(2, 3, dtype=torch.int32)
    with pytest.raises(ValueError, match="aligned"):
        pa.check_layout(q3, _off_by_one(dtype, 5, 4, 2, 16), pages, bt, lens)


def _flash_bad(case):
    q, kv = torch.zeros(1, 8, 4, 16), torch.zeros(1, 8, 2, 16)
    return {
        "f64": (q.double(), kv.double(), kv.double()),
        "mixed": (q, kv.bfloat16(), kv),
        "rank": (q[0], kv, kv),
        "kv_shape": (q, kv, torch.zeros(1, 9, 2, 16)),
        "groups": (torch.zeros(1, 8, 3, 16), kv, kv),
        "head_dim": (torch.zeros(1, 8, 4, 136), torch.zeros(1, 8, 2, 136),
                     torch.zeros(1, 8, 2, 136)),
        "head_dim_odd": (torch.zeros(1, 8, 4, 6), torch.zeros(1, 8, 2, 6),
                         torch.zeros(1, 8, 2, 6)),
        # bf16 rows are copied in 16-byte pieces: d % 8 == 0
        "head_dim_bf16": tuple(torch.zeros(1, 8, n, 12, dtype=torch.bfloat16)
                               for n in (4, 2, 2)),
        "strided": (torch.zeros(1, 4, 8, 16).transpose(1, 2), kv, kv),
        "empty_kv": (q, torch.zeros(1, 0, 2, 16), torch.zeros(1, 0, 2, 16)),
    }[case]


@pytest.mark.parametrize("case", ["f64", "mixed", "rank", "kv_shape",
                                  "groups", "head_dim", "head_dim_odd",
                                  "head_dim_bf16", "strided", "empty_kv"])
def test_flash_layout_rejects_what_the_kernel_cannot_take(case):
    with pytest.raises((ValueError, TypeError)):
        fa.check_layout(*_flash_bad(case))


def _paged_bad(case):
    q = torch.zeros(2, 8, 16)
    pages = torch.zeros(5, 4, 2, 16)
    bt = torch.zeros(2, 3, dtype=torch.int32)
    lens = torch.ones(2, dtype=torch.int32)
    return {
        "lens_i64": (q, pages, pages, bt, lens.long()),
        "table_i64": (q, pages, pages, bt.long(), lens),
        "table_rows": (q, pages, pages, bt[:1], lens),
        "lens_shape": (q, pages, pages, bt, lens[:1]),
        "big_group": (torch.zeros(2, 34, 16), pages, pages, bt, lens),
        "table_strided": (q, pages, pages,
                          torch.zeros(3, 2, dtype=torch.int32).t(), lens),
        "pages_dtype": (q, pages.bfloat16(), pages.bfloat16(), bt, lens),
        "head_dim_bf16": (torch.zeros(2, 8, 12, dtype=torch.bfloat16),
                          torch.zeros(5, 4, 2, 12, dtype=torch.bfloat16),
                          torch.zeros(5, 4, 2, 12, dtype=torch.bfloat16), bt,
                          lens),
    }[case]


@pytest.mark.parametrize("case", ["lens_i64", "table_i64", "table_rows",
                                  "lens_shape", "big_group",
                                  "table_strided", "pages_dtype",
                                  "head_dim_bf16"])
def test_paged_layout_rejects_what_the_kernel_cannot_take(case):
    with pytest.raises((ValueError, TypeError)):
        pa.check_layout(*_paged_bad(case))


def test_dense_decode_layout_rejects_empty_and_mismatched_caches():
    q, lens = torch.zeros(2, 8, 16), torch.ones(2, dtype=torch.int32)
    for kc in (torch.zeros(2, 0, 2, 16), torch.zeros(3, 8, 2, 16)):
        with pytest.raises(ValueError):
            da.check_layout(q, kc, kc, lens)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("positions,pairs,sms", [
    (576, 16, 132), (1000, 16, 132), (24, 4, 132), (32768, 1, 132),
    (1, 1, 132), (100, 1000, 132), (33, 2, 8)])
def test_split_plan_covers_every_position(positions, pairs, sms, dtype):
    chunk, nsplit = da.split_plan(positions, pairs, sms, dtype)
    tile, least, per_sm = da.PLAN[dtype]
    assert chunk % tile == 0 and chunk >= least
    # every position covered, and no empty trailing split
    assert chunk * nsplit >= positions > chunk * (nsplit - 1)
    # a bounded block count: about per_sm blocks per SM at most
    assert 1 <= nsplit <= da.MAX_SPLITS
    assert pairs * nsplit <= max(per_sm * sms + pairs - 1, pairs)


def test_ops_keep_the_reference_shape_checks():
    with pytest.raises(ValueError, match="rank-4"):
        ops.flash_attention(torch.zeros(2, 3, 4), torch.zeros(1, 2, 3, 4),
                            torch.zeros(1, 2, 3, 4))
    with pytest.raises(ValueError, match="GQA"):
        ops.flash_attention(torch.zeros(1, 2, 3, 4), torch.zeros(1, 2, 2, 4),
                            torch.zeros(1, 2, 2, 4))
    with pytest.raises(ValueError, match="head_dim"):
        ops.decode_attention(torch.zeros(2, 4, 8), torch.zeros(2, 5, 2, 4),
                             torch.zeros(2, 5, 2, 4), torch.ones(2))
    with pytest.raises(ValueError, match="block_tables"):
        ops.paged_decode_attention(torch.zeros(2, 4, 8),
                                   torch.zeros(3, 4, 2, 8),
                                   torch.zeros(3, 4, 2, 8),
                                   torch.zeros(3, 1), torch.ones(2))


def test_attention_sources_build_with_their_shared_header():
    assert {"flash_attention", "decode_attention"} <= set(_build.sources())
    header = _build.CSRC / "online_softmax.cuh"
    assert header.exists()
    for name in ("flash_attention", "decode_attention"):
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert '#include "online_softmax.cuh"' in src
        assert "sm_90a" in src or "Hopper" in src


def test_bf16_paths_use_tensor_cores_and_async_copies():
    """Both attention sources take their bf16 building blocks from the
    shared header: mma.sync on the tensor cores, ldmatrix and cp.async;
    the decode source has one kernel per call (no combine kernel)."""
    header = (_build.CSRC / "hopper_mma.cuh").read_text()
    for ptx in ("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32",
                "cp.async.cg.shared.global", "ldmatrix.sync.aligned"):
        assert ptx in header
    for name, kernel in (("flash_attention", "flash_fwd_bf16_kernel"),
                         ("decode_attention", "decode_split_bf16_kernel")):
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert '#include "hopper_mma.cuh"' in src and kernel in src
        assert "hop::mma_bf16" in src and "hop::cp_async16" in src
    decode = (_build.CSRC / "decode_attention.cu").read_text()
    assert "combine_kernel" not in decode and "atomicAdd" in decode
