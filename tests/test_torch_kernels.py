"""The port's kernel modules (hetu_tpu_torch/ops) against the JAX
reference's Pallas kernels and plain compositions.

On the CPU each kernel wrapper runs its plain PyTorch version; the JAX
side runs its Pallas kernel in interpret mode, as
tests/test_pallas_kernels.py does, and its plain composition.  Inputs
are seeded numpy arrays handed to both.  Backward kernels are compared
through the autograd Functions against `jax.vjp` of the Pallas
kernels' custom VJPs, on the same cotangents.  Float32 tolerance 1e-5
(docs/kernels.md); bf16 outputs, each rounded once, within one bf16
ulp; AdamW at the reference's own 1-ulp bound (rtol 3e-7).

The CUDA kernels themselves are held against their plain versions on
the card in tests/test_torch_cuda.py, which imports no JAX.
"""
from __future__ import annotations

import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from hetu_tpu import ops as jops
from hetu_tpu.models import generation as jgen
from hetu_tpu.ops.pallas import adam as jadam
from hetu_tpu.ops.pallas import fused_norm as jfused_norm
from hetu_tpu.ops.pallas import paged_attention as jpaged
from hetu_tpu.ops.pallas import rotary as jrotary
from hetu_tpu.ops.pallas import swiglu as jswiglu
from hetu_tpu_torch.ops import norms, rotary
from hetu_tpu_torch.ops.activations import swiglu
from hetu_tpu_torch.ops.cuda import adam as tadam
from hetu_tpu_torch.ops.cuda import build
from hetu_tpu_torch.ops.cuda import fused_norm as tfused_norm
from hetu_tpu_torch.ops.cuda import kv_write as tkv_write
from hetu_tpu_torch.ops.cuda import paged_attention as tpaged
from hetu_tpu_torch.ops.cuda import quant as tquant
from hetu_tpu_torch.ops.cuda import rotary as trotary
from hetu_tpu_torch.ops.cuda import sample as tsample
from hetu_tpu_torch.ops.cuda import swiglu as tswiglu

FWD_TOL = 1e-5


def _rand(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _bf16_close(a: torch.Tensor, b):
    """Within one bf16 ulp (8 significant bits) of the larger of the
    two, elementwise (`b` may be a JAX array)."""
    a = a.float()
    b = torch.from_numpy(np.asarray(b, np.float32))
    _, exp = torch.frexp(torch.maximum(a.abs(), b.abs()))
    ulp = torch.ldexp(torch.ones_like(a), exp - 8)
    assert bool(((a - b).abs() <= ulp).all()), \
        f"max diff {(a - b).abs().max().item()}"


# ------------------------------------------------------------- rms norm
def test_rms_norm_matches_reference():
    x, w = _rand((3, 5, 64), 0), _rand((64,), 1)
    ref = jops.rms_norm(jnp.asarray(x), jnp.asarray(w))
    out = norms.rms_norm(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FWD_TOL)


# --------------------------------------------------------------- rotary
@pytest.mark.parametrize("max_len,hd,theta", [(256, 16, 1e4),
                                              (8192, 128, 5e5)])
def test_rope_cache_matches_reference(max_len, hd, theta):
    jc, js = jops.build_rope_cache(max_len, hd, theta)
    tc, ts = rotary.build_rope_cache(max_len, hd, theta)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=FWD_TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=FWD_TOL)


def _rotary_case(seed, b=2, s=5, nq=4, nk=2, hd=128):
    q, k = _rand((b, s, nq, hd), seed), _rand((b, s, nk, hd), seed + 1)
    pos = np.random.default_rng(seed + 2).integers(
        0, 64, size=(b, s)).astype(np.int32)
    cos, sin = jops.build_rope_cache(64, hd, 10000.0)
    cos_t, sin_t = np.asarray(cos)[pos], np.asarray(sin)[pos]
    return q, k, pos, cos_t, sin_t


def test_fused_rotary_matches_pallas_kernel():
    q, k, _, cos_t, sin_t = _rotary_case(0)
    jq, jk = jrotary.fused_rotary_qk(*map(jnp.asarray, (q, k, cos_t, sin_t)))
    tq, tk = trotary.fused_rotary_qk(
        *map(torch.from_numpy, (q, k, cos_t, sin_t)), device="cpu")
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=FWD_TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=FWD_TOL)


def test_apply_rotary_qk_matches_reference_composition():
    """The serving forwards' RoPE (`rope_tables` gathers the rows once,
    then one fused call) against the reference's dispatcher on its
    plain two-call composition."""
    q, k, pos, _, _ = _rotary_case(3)
    jc, js = jops.build_rope_cache(64, 128, 10000.0)
    jq, jk = jops.apply_rotary_qk(jnp.asarray(q), jnp.asarray(k), jc, js,
                                  jnp.asarray(pos), use_pallas=False)
    tc, ts = rotary.build_rope_cache(64, 128, 10000.0)
    b, s = pos.shape
    cos_t, sin_t = rotary.rope_tables(tc, ts, b, s,
                                      torch.from_numpy(pos).long())
    tq, tk = trotary.fused_rotary_qk(torch.from_numpy(q), torch.from_numpy(k),
                                     cos_t, sin_t, device="cpu")
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=FWD_TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=FWD_TOL)
    tq1 = rotary.apply_rotary(torch.from_numpy(q), tc, ts,
                              torch.from_numpy(pos).long())
    np.testing.assert_allclose(tq1.numpy(), np.asarray(jq), atol=FWD_TOL)


def test_fused_rotary_bf16_matches_pallas_kernel():
    q, k, _, cos_t, sin_t = _rotary_case(5)
    jq, jk = jrotary.fused_rotary_qk(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(cos_t), jnp.asarray(sin_t))
    tq, tk = trotary.fused_rotary_qk(
        torch.from_numpy(q).bfloat16(), torch.from_numpy(k).bfloat16(),
        torch.from_numpy(cos_t), torch.from_numpy(sin_t), device="cpu")
    _bf16_close(tq, jq)
    _bf16_close(tk, jk)


# --------------------------------------------------------------- swiglu
def test_fused_swiglu_matches_pallas_kernel():
    g, u = _rand((16, 256), 0), _rand((16, 256), 1)
    ref = jswiglu.fused_swiglu(jnp.asarray(g), jnp.asarray(u))
    out = tswiglu.fused_swiglu(torch.from_numpy(np.stack([g, u], -2)),
                               device="cpu")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FWD_TOL)


def test_swiglu_matches_reference_composition_on_strided_views():
    """The MLP's call: gate/up are strided views of the fused [.., 2, I]
    projection; fp32 against the reference's plain `silu(g) * u`."""
    gu = _rand((2, 8, 2, 256), 4)
    ref = jops.swiglu(jnp.asarray(gu[:, :, 0]), jnp.asarray(gu[:, :, 1]),
                      use_pallas=False)
    out = swiglu(torch.from_numpy(gu))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FWD_TOL)


def test_fused_swiglu_bf16_rounds_once_like_pallas_kernel():
    g, u = _rand((16, 256), 6), _rand((16, 256), 7)
    ref = jswiglu.fused_swiglu(jnp.asarray(g, jnp.bfloat16),
                               jnp.asarray(u, jnp.bfloat16))
    out = tswiglu.fused_swiglu(
        torch.from_numpy(np.stack([g, u], -2)).bfloat16(), device="cpu")
    _bf16_close(out, ref)


def test_fused_swiglu_backward_matches_pallas_kernel():
    """dgate and dup, written into one [..., 2, inner] cotangent of the
    fused projection, against the Pallas kernel's custom VJP."""
    g, u, dy = _rand((16, 256), 10), _rand((16, 256), 11), _rand((16, 256),
                                                                   12)
    _, vjp = jax.vjp(jswiglu.fused_swiglu, jnp.asarray(g), jnp.asarray(u))
    jdg, jdu = vjp(jnp.asarray(dy))
    gu = torch.from_numpy(np.stack([g, u], -2)).requires_grad_(True)
    tswiglu.fused_swiglu(gu, device="cpu").backward(torch.from_numpy(dy))
    np.testing.assert_allclose(gu.grad[:, 0].numpy(), np.asarray(jdg),
                               atol=FWD_TOL)
    np.testing.assert_allclose(gu.grad[:, 1].numpy(), np.asarray(jdu),
                               atol=FWD_TOL)


def test_fused_swiglu_backward_bf16_rounds_once_like_pallas_kernel():
    g, u, dy = (_rand((16, 256), s) for s in (13, 14, 15))
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)
    _, vjp = jax.vjp(jswiglu.fused_swiglu, bf(g), bf(u))
    jdg, jdu = vjp(bf(dy))
    dgu = tswiglu.swiglu_bwd(torch.from_numpy(np.stack([g, u], -2)).bfloat16(),
                             torch.from_numpy(dy).bfloat16(), device="cpu")
    _bf16_close(dgu[:, 0], jdg)
    _bf16_close(dgu[:, 1], jdu)


# ------------------------------------------------------ rotary backward
@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_fused_rotary_backward_matches_pallas_kernel(dtype):
    """dq and dk through the autograd Function (the same kernel by
    -theta) against the Pallas kernel's custom VJP."""
    q, k, _, cos_t, sin_t = _rotary_case(20)
    dqo, dko = _rand(q.shape, 22), _rand(k.shape, 23)
    cs = jnp.asarray(cos_t), jnp.asarray(sin_t)
    _, vjp = jax.vjp(lambda a, b: jrotary.fused_rotary_qk(a, b, *cs),
                     jnp.asarray(q, dtype), jnp.asarray(k, dtype))
    jdq, jdk = vjp((jnp.asarray(dqo, dtype), jnp.asarray(dko, dtype)))
    tdtype = torch.float32 if dtype == np.float32 else torch.bfloat16
    tq, tk = (torch.from_numpy(a).to(tdtype).requires_grad_(True)
              for a in (q, k))
    oq, ok = trotary.fused_rotary_qk(tq, tk, torch.from_numpy(cos_t),
                                     torch.from_numpy(sin_t), device="cpu")
    torch.autograd.backward((oq, ok), (torch.from_numpy(dqo).to(tdtype),
                                       torch.from_numpy(dko).to(tdtype)))
    if dtype == np.float32:
        np.testing.assert_allclose(tq.grad.numpy(), np.asarray(jdq),
                                   atol=FWD_TOL)
        np.testing.assert_allclose(tk.grad.numpy(), np.asarray(jdk),
                                   atol=FWD_TOL)
    else:
        _bf16_close(tq.grad, jdq)
        _bf16_close(tk.grad, jdk)


def test_rotary_backward_takes_strided_cotangents():
    """Autograd may hand the Function strided cotangents; it makes them
    contiguous before the kernel (which requires contiguous operands)."""
    q, k, _, cos_t, sin_t = _rotary_case(24)
    tq, tk = (torch.from_numpy(a).requires_grad_(True) for a in (q, k))
    oq, ok = trotary.fused_rotary_qk(tq, tk, torch.from_numpy(cos_t),
                                     torch.from_numpy(sin_t), device="cpu")
    dqo = torch.from_numpy(_rand(q.shape[:2] + q.shape[3:] + q.shape[2:3],
                                 25)).transpose(2, 3)
    assert not dqo.is_contiguous()
    torch.autograd.backward((oq, ok), (dqo, torch.zeros_like(ok)))
    ref, _ = trotary.rotary_qk_plain(dqo.contiguous(), torch.zeros_like(ok),
                                     torch.from_numpy(cos_t),
                                     -torch.from_numpy(sin_t))
    np.testing.assert_array_equal(tq.grad.numpy(), ref.numpy())


# ------------------------------------------------- fused residual norm
@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_fused_residual_rmsnorm_matches_pallas_kernel(dtype):
    """y and s forward; dx, dh and dw from the Pallas kernel's custom
    VJP on the same cotangents.  bf16: y, s and dx are each rounded
    once (one ulp); dw is an fp32 sum over the rows (1e-5, summation
    order)."""
    x, h, w = _rand((2, 8, 256), 30), _rand((2, 8, 256), 31), \
        1.0 + 0.1 * _rand((256,), 32)
    dy, dr = _rand((2, 8, 256), 33), _rand((2, 8, 256), 34)
    (jy, js), vjp = jax.vjp(
        lambda a, b, c: jfused_norm.fused_residual_rmsnorm(a, b, c, 1e-5),
        jnp.asarray(x, dtype), jnp.asarray(h, dtype), jnp.asarray(w))
    jdx, jdh, jdw = vjp((jnp.asarray(dy, dtype), jnp.asarray(dr, dtype)))
    tdtype = torch.float32 if dtype == np.float32 else torch.bfloat16
    tx, th = (torch.from_numpy(a).to(tdtype).requires_grad_(True)
              for a in (x, h))
    tw = torch.from_numpy(w).requires_grad_(True)
    ty, ts = tfused_norm.fused_residual_rmsnorm(tx, th, tw, 1e-5,
                                                device="cpu")
    torch.autograd.backward((ty, ts), (torch.from_numpy(dy).to(tdtype),
                                       torch.from_numpy(dr).to(tdtype)))
    assert tw.grad.dtype == torch.float32
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), rtol=1e-5,
                               atol=FWD_TOL)
    pairs = ((ty, jy), (ts, js), (tx.grad, jdx), (th.grad, jdh))
    for a, b in pairs:
        if dtype == np.float32:
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       atol=FWD_TOL)
        else:
            _bf16_close(a.detach(), b)


def test_fused_residual_rmsnorm_bf16_gap_to_the_reference_fallback():
    """The port follows the Pallas kernel, which normalizes the
    UNROUNDED fp32 s = x + h; the reference's XLA fallback
    (`ops.residual_rms_norm`, use_pallas=False) rounds s to bf16 first.
    The two y's therefore differ in bf16: by a few ulps, not by one.
    This test states that gap: nonzero, and within 3 bf16 ulps of |y|
    (bf16 s carries a relative error up to 2^-9, which y inherits on top
    of its own rounding); the y's agree to 1 ulp with the kernel's."""
    x, h = _rand((4, 8, 512), 40), _rand((4, 8, 512), 41)
    w = 1.0 + 0.1 * _rand((512,), 42)
    jy, _ = jops.residual_rms_norm(jnp.asarray(x, jnp.bfloat16),
                                   jnp.asarray(h, jnp.bfloat16),
                                   jnp.asarray(w), use_pallas=False)
    ty, _ = norms.residual_rms_norm(torch.from_numpy(x).bfloat16(),
                                    torch.from_numpy(h).bfloat16(),
                                    torch.from_numpy(w))
    a = ty.float()
    b = torch.from_numpy(np.asarray(jy, np.float32))
    _, exp = torch.frexp(torch.maximum(a.abs(), b.abs()))
    ulps = ((a - b).abs() / torch.ldexp(torch.ones_like(a), exp - 8))
    assert ulps.max() > 0              # the paths do differ in bf16
    assert ulps.max() <= 3
    jk, _ = jfused_norm.fused_residual_rmsnorm(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(h, jnp.bfloat16),
        jnp.asarray(w))
    _bf16_close(ty, jk)


def test_residual_rms_norm_matches_reference_in_fp32():
    """In fp32 the kernel's arithmetic and the reference's fallback
    composition agree."""
    x, h, w = _rand((3, 5, 64), 43), _rand((3, 5, 64), 44), _rand((64,), 45)
    jy, js = jops.residual_rms_norm(jnp.asarray(x), jnp.asarray(h),
                                    jnp.asarray(w), use_pallas=False)
    ty, ts = norms.residual_rms_norm(torch.from_numpy(x), torch.from_numpy(h),
                                     torch.from_numpy(w))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=FWD_TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=FWD_TOL)


def _layernorm_case(shape, seed, bias):
    x, h = _rand(shape, seed), _rand(shape, seed + 1)
    w = 1.0 + 0.1 * _rand(shape[-1:], seed + 2)
    b = 0.1 * _rand(shape[-1:], seed + 3) if bias else None
    return x, h, w, b


@pytest.mark.parametrize("shape", [(2, 8, 256), (3, 8, 384)])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_fused_residual_layernorm_matches_pallas_kernel(shape, bias, dtype):
    """The LayerNorm arm against the Pallas kernel in interpret mode, with
    a bias and scale-only: y and s forward; dx, dh, dw and db from its
    custom VJP on the same cotangents (no db without a bias, as the
    reference returns none).  fp32 within 1e-5; bf16 y, s and dx, each
    rounded once, within one ulp; dw and db are fp32 sums over the rows
    (1e-5, summation order)."""
    x, h, w, b = _layernorm_case(shape, 50, bias)
    dy, dr = _rand(shape, 55), _rand(shape, 56)

    def jfn(a, c, wt, bs):
        return jfused_norm.fused_residual_layernorm(a, c, wt, bs, 1e-5)
    jb = None if b is None else jnp.asarray(b)
    (jy, js), vjp = jax.vjp(jfn, jnp.asarray(x, dtype), jnp.asarray(h, dtype),
                            jnp.asarray(w), jb)
    jdx, jdh, jdw, jdb = vjp((jnp.asarray(dy, dtype),
                              jnp.asarray(dr, dtype)))
    tdtype = torch.float32 if dtype == np.float32 else torch.bfloat16
    tx, th = (torch.from_numpy(a).to(tdtype).requires_grad_(True)
              for a in (x, h))
    tw = torch.from_numpy(w).requires_grad_(True)
    tb = None if b is None else torch.from_numpy(b).requires_grad_(True)
    ty, ts = tfused_norm.fused_residual_layernorm(tx, th, tw, tb, 1e-5,
                                                  device="cpu")
    torch.autograd.backward((ty, ts), (torch.from_numpy(dy).to(tdtype),
                                       torch.from_numpy(dr).to(tdtype)))
    sums = [(tw.grad, jdw)]
    if bias:
        sums.append((tb.grad, jdb))
    else:
        assert jdb is None
    for a, ref in sums:
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=FWD_TOL)
    for a, ref in ((ty, jy), (ts, js), (tx.grad, jdx), (th.grad, jdh)):
        if dtype == np.float32:
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(ref),
                                       atol=FWD_TOL)
        else:
            _bf16_close(a.detach(), ref)


def test_layernorm_backward_without_bias_returns_no_db():
    x, h, w, _ = _layernorm_case((4, 64), 57, False)
    s = torch.from_numpy(x + h)
    dy, dr = torch.from_numpy(_rand((4, 64), 58)), torch.zeros(4, 64)
    dx, dw, db = tfused_norm.residual_layernorm_bwd(
        s, torch.from_numpy(w), dy, dr, has_bias=False, device="cpu")
    assert db is None and dw.shape == (64,) and dx.shape == (4, 64)
    _, _, db = tfused_norm.residual_layernorm_bwd(
        s, torch.from_numpy(w), dy, dr, device="cpu")
    torch.testing.assert_close(db, dy.sum(0))


def test_fused_residual_layernorm_bf16_gap_to_the_reference_fallback():
    """As for the RMS arm: the port follows the Pallas kernel, which
    normalizes the UNROUNDED fp32 s = x + h; the reference's fallback
    (`ops.residual_layer_norm`, use_pallas=False) rounds s to bf16
    first.  s's rounding (up to 2^-9 |s|) reaches y through (s - mean)
    * inv * w, an absolute error, large against y's own ulp where y is
    near 0: the y's differ by at most 3 bf16 ulps of |y| plus 1e-2
    (2^-9 * max|s| * inv * max|w| is under 1e-2 at these inputs); they
    agree to 1 ulp with the kernel's."""
    x, h, w, b = _layernorm_case((4, 8, 512), 60, True)
    jy, _ = jops.residual_layer_norm(jnp.asarray(x, jnp.bfloat16),
                                     jnp.asarray(h, jnp.bfloat16),
                                     jnp.asarray(w), jnp.asarray(b),
                                     use_pallas=False)
    ty, _ = norms.residual_layer_norm(torch.from_numpy(x).bfloat16(),
                                      torch.from_numpy(h).bfloat16(),
                                      torch.from_numpy(w),
                                      torch.from_numpy(b))
    a = ty.float()
    ref = torch.from_numpy(np.asarray(jy, np.float32))
    _, exp = torch.frexp(torch.maximum(a.abs(), ref.abs()))
    ulp = torch.ldexp(torch.ones_like(a), exp - 8)
    gap = (a - ref).abs()
    assert gap.max() > 0               # the paths do differ in bf16
    assert bool((gap <= 3 * ulp + 1e-2).all()), float(gap.max())
    jk, _ = jfused_norm.fused_residual_layernorm(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(h, jnp.bfloat16),
        jnp.asarray(w), jnp.asarray(b))
    _bf16_close(ty, jk)


@pytest.mark.parametrize("bias", [True, False])
def test_layer_norms_match_reference_in_fp32(bias):
    """`layer_norm` against the reference's; `residual_layer_norm`
    against its fallback composition (in fp32 the kernel's arithmetic
    and the composition agree), at an odd width."""
    x, h, w, b = _layernorm_case((3, 5, 72), 61, bias)
    jb = None if b is None else jnp.asarray(b)
    tb = None if b is None else torch.from_numpy(b)
    np.testing.assert_allclose(
        norms.layer_norm(torch.from_numpy(x), torch.from_numpy(w),
                         tb).numpy(),
        np.asarray(jops.layer_norm(jnp.asarray(x), jnp.asarray(w), jb)),
        atol=FWD_TOL)
    jy, js = jops.residual_layer_norm(jnp.asarray(x), jnp.asarray(h),
                                      jnp.asarray(w), jb, use_pallas=False)
    ty, ts = norms.residual_layer_norm(torch.from_numpy(x),
                                       torch.from_numpy(h),
                                       torch.from_numpy(w), tb)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=FWD_TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=FWD_TOL)


def test_gelu_matches_reference():
    from hetu_tpu_torch.ops.activations import gelu
    x = 3.0 * _rand((4, 100), 62)
    np.testing.assert_allclose(gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(jops.gelu(jnp.asarray(x))),
                               atol=FWD_TOL)


# ------------------------------------------------------------- adamw
def test_adam_update_matches_pallas_kernel_over_two_steps():
    """An fp32 leaf and a bf16 leaf, two steps (the bias corrections
    move), in place, against the Pallas kernel at the reference's own
    1-ulp bound; lr/c1/c2 in fp32 as the reference's optimizer computes
    them."""
    b1, b2, eps, wd, lr = 0.9, 0.95, 1e-8, 0.01, 1e-2
    leaves = {"w": (_rand((8, 128), 50), np.float32),
              "e": (_rand((256,), 51), jnp.bfloat16)}
    for name, (p0, dtype) in leaves.items():
        g = (_rand(p0.shape, 52) * 0.1).astype(np.float32)
        jp, jm, jv = (jnp.asarray(p0, dtype), jnp.zeros(p0.shape),
                      jnp.zeros(p0.shape))
        tp = torch.from_numpy(np.array(jp, np.float32)).to(
            torch.float32 if dtype == np.float32 else torch.bfloat16)
        tm, tv = torch.zeros(p0.shape), torch.zeros(p0.shape)
        for step in (1, 2):
            c1 = np.float32(1.0) - np.float32(b1) ** np.float32(step)
            c2 = np.float32(1.0) - np.float32(b2) ** np.float32(step)
            jp, jm, jv = jadam.adam_update(
                jp, jnp.asarray(g), jm, jv, lr, c1, c2, b1=b1, b2=b2,
                eps=eps, weight_decay=wd)
            tadam.adam_update(tp, torch.from_numpy(g), tm, tv, lr, c1, c2,
                              b1=b1, b2=b2, eps=eps, weight_decay=wd,
                              device="cpu")
        for a, b in ((tp, jp), (tm, jm), (tv, jv)):
            np.testing.assert_allclose(a.float().numpy(),
                                       np.asarray(b, np.float32),
                                       rtol=3e-7, atol=1e-8, err_msg=name)


def test_adam_update_refuses_what_the_kernel_does_not_take():
    p, m, v = torch.zeros(8), torch.zeros(8), torch.zeros(8)
    with pytest.raises(ValueError):              # a bf16 gradient
        tadam.adam_update(p, torch.zeros(8).bfloat16(), m, v, 1e-3, 0.1,
                          0.05, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.0,
                          device="cpu")
    with pytest.raises(ValueError):              # shapes differ
        tadam.adam_update(p, torch.zeros(9), m, v, 1e-3, 0.1, 0.05, b1=0.9,
                          b2=0.95, eps=1e-8, weight_decay=0.0, device="cpu")


def test_adam_update_multi_matches_pallas_and_the_reference_adamw():
    """One `adam_update_multi` call a step over a mixed list — fp32 and
    bf16 leaves, lane-aligned and ragged, one a view off a 16-byte
    boundary — two steps, in place: the lane-aligned leaves against the
    Pallas kernel (interpret mode), the ragged ones against the
    reference's `AdamW.update` (its unfused chain: the Pallas gate is
    n % 128), at the reference's 1-ulp bound."""
    from hetu_tpu.optim import optimizer as joptim
    b1, b2, eps, wd, lr = 0.9, 0.95, 1e-8, 0.01, 1e-2
    leaves = {"w": ((8, 128), np.float32, True),
              "e": ((256,), jnp.bfloat16, True),
              "b": ((5,), np.float32, False),
              "t": ((1001,), np.float32, False)}
    p0 = {n: _rand(shape, 60 + i) for i, (n, (shape, _, _)) in
          enumerate(leaves.items())}
    grads = {n: (_rand(x.shape, 70 + i) * 0.1).astype(np.float32)
             for i, (n, x) in enumerate(p0.items())}
    jp = {n: jnp.asarray(p0[n], dt) for n, (_, dt, _) in leaves.items()}
    jm = {n: jnp.zeros(x.shape) for n, x in p0.items()}
    jv = dict(jm)
    ragged = [n for n, (_, _, lane) in leaves.items() if not lane]
    jopt = joptim.AdamW(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=wd)
    jr = {n: jp[n] for n in ragged}
    jstate = jopt.init(jr)

    def view(x: np.ndarray, dtype) -> torch.Tensor:
        """`x` in a buffer one element in: off a 16-byte boundary."""
        buf = torch.empty(x.size + 1, dtype=dtype)[1:].view(x.shape)
        return buf.copy_(torch.from_numpy(np.array(x, np.float32)))
    names = list(leaves)
    tp = [view(np.asarray(jp[n], np.float32),
               torch.bfloat16 if leaves[n][1] == jnp.bfloat16
               else torch.float32) for n in names]
    tg = [view(grads[n], torch.float32) for n in names]
    tm = [torch.zeros(p0[n].shape) for n in names]
    tv = [torch.zeros(p0[n].shape) for n in names]
    for step in (1, 2):
        c1 = np.float32(1.0) - np.float32(b1) ** np.float32(step)
        c2 = np.float32(1.0) - np.float32(b2) ** np.float32(step)
        for n in names:
            if leaves[n][2]:
                jp[n], jm[n], jv[n] = jadam.adam_update(
                    jp[n], jnp.asarray(grads[n]), jm[n], jv[n], lr, c1, c2,
                    b1=b1, b2=b2, eps=eps, weight_decay=wd)
        jr, jstate = jopt.update({n: jnp.asarray(grads[n]) for n in ragged},
                                 jstate, jr)
        tadam.adam_update_multi(tp, tg, tm, tv, lr, c1, c2, b1=b1, b2=b2,
                                eps=eps, weight_decay=wd, device="cpu")
    for i, n in enumerate(names):
        want = ((jp[n], jm[n], jv[n]) if leaves[n][2] else
                (jr[n], jstate["m"][n], jstate["v"][n]))
        for a, b in zip((tp[i], tm[i], tv[i]), want):
            np.testing.assert_allclose(a.float().numpy(),
                                       np.asarray(b, np.float32),
                                       rtol=3e-7, atol=1e-8, err_msg=n)


@pytest.mark.parametrize("max_leaves", [1, 2, tadam.MAX_LEAVES])
def test_adam_plan_tables_cuts_chunks_and_splits_long_lists(max_leaves):
    """The host side of the multi-tensor launch: each leaf's chunks
    (ceil(n / CHUNK)) as a prefix from 0, empty leaves left out, and a
    list longer than a table cut into as few launches as it needs, in
    order."""
    C = tadam.CHUNK
    sizes = [10, 0, C, C + 1, 3 * C - 1, 1]
    tables = tadam.plan_tables(sizes, max_leaves)
    live = [i for i, n in enumerate(sizes) if n]
    assert len(tables) == -(-len(live) // max_leaves)
    assert [i for idx, _ in tables for i in idx] == live
    for idx, starts in tables:
        assert 1 <= len(idx) <= max_leaves and len(starts) == len(idx) + 1
        assert starts[0] == 0
        assert [b - a for a, b in zip(starts, starts[1:])] == [
            -(-sizes[i] // C) for i in idx]
    assert tadam.plan_tables([0, 0]) == []


def test_adam_plan_tables_fit_gpt2_large_in_one_launch():
    """GPT-2-large's 436 leaves (the Trainer's fp32 parameters) take one
    table; 1,100 one-element leaves take three."""
    from hetu_tpu_torch.models.gpt import GPTConfig
    c = GPTConfig.gpt2_large()
    h, i = c.hidden_size, c.intermediate_size
    block = [h, h, 3 * h * h, 3 * h, h * h, h, h, h, h * i, i, i * h, h]
    sizes = ([c.max_position_embeddings * h, c.vocab_size * h]
             + block * c.num_hidden_layers + [h, h])
    assert len(sizes) == 436
    (idx, starts), = tadam.plan_tables(sizes)
    assert idx == list(range(436))
    assert starts[-1] == sum(-(-n // tadam.CHUNK) for n in sizes)
    assert [len(ix) for ix, _ in tadam.plan_tables([1] * 1100)] == [
        512, 512, 76]


def test_adam_tables_hold_pointers_chunks_and_alignment_flags():
    """`make_tables` writes each leaf's pointers, length and alignment
    flag (every one of p, g, m, v on a 16-byte boundary: the vector
    path) and the chunk prefix, with the nine scalars."""
    def off(n, k, dtype=torch.float32):
        return torch.zeros(n + k, dtype=dtype)[k:]
    leaves = [(torch.zeros(40000), torch.zeros(40000), torch.zeros(40000),
               torch.zeros(40000)),
              (off(7, 1), torch.zeros(7), torch.zeros(7), torch.zeros(7)),
              (off(8, 4, torch.bfloat16), off(8, 4), off(8, 4), off(8, 4)),
              (torch.zeros(0),) * 4]
    scalars = tadam._scalars(1e-3, 0.1, 0.05, 0.9, 0.95, 1e-8, 0.1)
    (t,) = tadam.make_tables(*zip(*leaves), scalars)
    assert t.leaves == 3
    assert list(t.chunk_start[:4]) == [0, 3, 4, 5]
    assert [t.leaf[j].aligned for j in range(3)] == [1, 0, 0]
    assert [t.leaf[j].n for j in range(3)] == [40000, 7, 8]
    for j in range(3):
        assert [getattr(t.leaf[j], f) for f in "pgmv"] == [
            x.data_ptr() for x in leaves[j]]
    assert (t.b1, t.lr, t.wd) == (scalars[0], scalars[4], scalars[8])
    assert tadam.vector_aligned(off(8, 4)) and not tadam.vector_aligned(
        off(8, 1))


def test_adam_table_mirrors_the_source():
    """`_Leaf` / `_Table` are `struct AdamLeaf` / `struct AdamTable` of
    csrc/adam.cu field for field, its MAX_LEAVES and CHUNK are the
    source's, and the table fits the 32,764 bytes a kernel's parameters
    may take: checked here, where no compiler runs."""
    import ctypes
    text = (build.CSRC / "adam.cu").read_text()
    const = {k: int(v) for k, v in re.findall(
        r"constexpr int (ADAM_\w+) = (\d+);", text)}
    assert const["ADAM_MAX_LEAVES"] == tadam.MAX_LEAVES
    assert const["ADAM_CHUNK"] == tadam.CHUNK
    assert const["ADAM_CHUNK"] % (4 * const["ADAM_THREADS"]) == 0

    def fields(struct):
        body = re.search(rf"struct {struct} \{{(.*?)\n\}};", text,
                         re.S).group(1)
        out = []
        for decl in filter(None, (d.strip() for d in body.split(";"))):
            decl = re.sub(r"\[.*?\]", "", decl)
            names = re.match(r".*?[\s*](\w+(?:\s*,\s*\w+)*)$", decl,
                             re.S).group(1)
            out += [n.strip() for n in names.split(",")]
        return out
    assert fields("AdamLeaf") == [f for f, _ in tadam._Leaf._fields_]
    assert fields("AdamTable") == [f for f, _ in tadam._Table._fields_]
    assert ctypes.sizeof(tadam._Table) <= 32764


# ------------------------------------------------------ paged attention
def _paged_case(seed, dtype=np.float32):
    """hd 128, GQA group 2, mixed depths, one inactive slot on the null
    page (the reference's own parity case plus the inactive row)."""
    S, P, ps, n_kv, nq, hd = 4, 9, 8, 2, 4, 128
    kp = _rand((P, ps, n_kv, hd), seed, dtype)
    vp = _rand((P, ps, n_kv, hd), seed + 1, dtype)
    q = _rand((S, nq, hd), seed + 2, dtype)
    table = np.array([[1, 2, 3, 0], [4, 5, 0, 0], [6, 7, 8, 0],
                      [0, 0, 0, 0]], np.int32)
    positions = np.array([20, 9, 17, 0], np.int32)
    return q, kp, vp, table, positions


def test_paged_attention_matches_pallas_kernel():
    q, kp, vp, table, positions = _paged_case(3)
    ref = jpaged.paged_attention(*map(jnp.asarray,
                                      (q, kp, vp, table, positions)))
    out = tpaged.paged_attention(*map(torch.from_numpy,
                                      (q, kp, vp, table, positions)),
                                 device="cpu")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FWD_TOL)


def test_paged_attention_matches_reference_composition():
    """Against the reference's plain gather + `_attend_cached`."""
    q, kp, vp, table, positions = _paged_case(8)
    S, nq, hd = q.shape
    dense = lambda pool: jnp.asarray(pool[table].reshape(S, -1,
                                                         *pool.shape[2:]))
    ref = jgen._attend_cached(jnp.asarray(q)[:, None], dense(kp), dense(vp),
                              jnp.asarray(positions), hd ** -0.5)[:, 0]
    out = tpaged.paged_attention(*map(torch.from_numpy,
                                      (q, kp, vp, table, positions)),
                                 device="cpu")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FWD_TOL)


def test_paged_attention_ignores_stale_bytes_past_each_position():
    """Freed and null pages hold stale bytes: NaN there, past every
    slot's position, must not reach the output (0 * NaN is NaN)."""
    q, kp, vp, table, positions = _paged_case(9)
    clean = tpaged.paged_attention(*map(torch.from_numpy,
                                        (q, kp, vp, table, positions)),
                                   device="cpu")
    ps = kp.shape[1]
    for s in range(table.shape[0]):
        for j in range(table.shape[1] * ps):
            if j > positions[s] and table[s, j // ps] != 0:
                kp[table[s, j // ps], j % ps] = np.nan
                vp[table[s, j // ps], j % ps] = np.nan
    kp[0, 1:], vp[0, 1:] = np.nan, np.nan
    out = tpaged.paged_attention(*map(torch.from_numpy,
                                      (q, kp, vp, table, positions)),
                                 device="cpu")
    assert torch.isfinite(out).all()
    np.testing.assert_array_equal(out.numpy(), clean.numpy())


def test_paged_attention_rejects_what_the_kernel_does_not_take():
    q, kp, vp, table, positions = map(torch.from_numpy, _paged_case(1))
    with pytest.raises(ValueError):
        tpaged.paged_attention(q, kp, vp, table.long(), positions,
                               device="cpu")
    with pytest.raises(ValueError):
        tpaged.paged_attention(q[:, :3], kp, vp, table, positions,
                               device="cpu")
    with pytest.raises(ValueError):
        tpaged.paged_attention(q.double(), kp, vp, table, positions,
                               device="cpu")


# ---------------------------------------------- the wrappers' contract
def _norm_args():
    x = torch.ones(2, 4, 128)
    return x, x, torch.ones(128)


def _adam_args():
    return (*(torch.zeros(256) for _ in range(4)), 1e-3, 0.1, 0.05)


def _quant_pages():
    q, kp, vp, table, positions = map(torch.from_numpy, _paged_case(2))
    k8, ks = tquant.quantize_blockwise(kp, 128, device="cpu")
    v8, vs = tquant.quantize_blockwise(vp, 128, device="cpu")
    return ((q, k8.reshape(kp.shape), v8.reshape(vp.shape), table,
             positions),
            dict(k_scale=ks.reshape(kp.shape[:-1]),
                 v_scale=vs.reshape(vp.shape[:-1])))


def _kv_write_args(pages: bool):
    """A token block (or a prefill scratch) and int8 pools: L = 2,
    S = 2, n_kv = 2, hd 64, pages of 4."""
    pools = [torch.zeros((2, 5, 4, 2, 64), dtype=torch.int8)
             for _ in range(2)]
    scales = dict(k_scale=torch.zeros((2, 5, 4, 2)),
                  v_scale=torch.zeros((2, 5, 4, 2)))
    if pages:
        x = torch.ones(2, 8, 2, 64)
        return ([*pools, torch.tensor([3, 0], dtype=torch.int32), x, x],
                scales)
    x = torch.ones(2, 1, 2, 64)
    table = torch.tensor([[1, 2], [0, 0]], dtype=torch.int32)
    return ([pools[0][0], pools[1][0], table,
             torch.tensor([5, 0], dtype=torch.int32), x, x],
            {k: t[0] for k, t in scales.items()})


def _sample_args(R=3, V=16):
    return (torch.zeros(R, 2, dtype=torch.long), torch.ones(R),
            torch.zeros(R, dtype=torch.int32), torch.zeros(R))


@pytest.mark.parametrize("call", ["paged", "rotary", "swiglu", "norm",
                                  "norm_bwd", "swiglu_bwd", "rotary_bwd",
                                  "adam", "paged_int8", "verify", "quant",
                                  "sample", "fused_sample", "ln", "ln_bwd",
                                  "kv_tokens", "kv_pages"])
def test_wrappers_default_to_the_card(monkeypatch, call):
    """Default device is "cuda": with no card, CPU inputs without
    device="cpu" raise instead of quietly running the plain version,
    and the plain version never counts as a launch."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rot = list(map(torch.from_numpy, _rotary_case(2)[:2]
                   + _rotary_case(2)[3:]))
    gu = torch.ones(8, 2, 128)
    mod, counter, fn, args, kw = {
        "paged": (tpaged, "launches", tpaged.paged_attention,
                  list(map(torch.from_numpy, _paged_case(2))), {}),
        "rotary": (trotary, "launches", trotary.fused_rotary_qk, rot, {}),
        "swiglu": (tswiglu, "launches", tswiglu.fused_swiglu, [gu], {}),
        "norm": (tfused_norm, "launches",
                 tfused_norm.fused_residual_rmsnorm, _norm_args(), {}),
        "norm_bwd": (tfused_norm, "bwd_launches",
                     tfused_norm.residual_rmsnorm_bwd,
                     (_norm_args()[0], _norm_args()[2], *_norm_args()[:2]),
                     {}),
        "ln": (tfused_norm, "ln_launches",
               tfused_norm.fused_residual_layernorm,
               (*_norm_args(), torch.zeros(128)), {}),
        "ln_bwd": (tfused_norm, "ln_bwd_launches",
                   tfused_norm.residual_layernorm_bwd,
                   (_norm_args()[0], _norm_args()[2], *_norm_args()[:2]),
                   {}),
        "swiglu_bwd": (tswiglu, "bwd_launches", tswiglu.swiglu_bwd,
                       (gu, torch.ones(8, 128)), {}),
        "rotary_bwd": (trotary, "bwd_launches", trotary.rotary_qk_bwd, rot,
                       {}),
        "adam": (tadam, "launches", tadam.adam_update, _adam_args(),
                 dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.0)),
        "paged_int8": (tpaged, "int8_launches", tpaged.paged_attention,
                       *_quant_pages()),
        "verify": (tpaged, "verify_launches", tpaged.paged_verify,
                   [t[:, None] if i == 0 else t for i, t in
                    enumerate(_quant_pages()[0])], _quant_pages()[1]),
        "quant": (tquant, "launches", tquant.quantize_blockwise,
                  (torch.ones(4, 128), 128), {}),
        "sample": (tsample, "logits_launches", tsample.sample_logits,
                   (torch.ones(3, 16), *_sample_args()), {}),
        "fused_sample": (tsample, "launches", tsample.fused_sample,
                         (torch.ones(3, 8), torch.ones(8, 16),
                          *_sample_args()), {}),
        "kv_tokens": (tkv_write, "launches", tkv_write.write_kv_tokens,
                      *_kv_write_args(pages=False)),
        "kv_pages": (tkv_write, "pages_launches", tkv_write.write_kv_pages,
                     *_kv_write_args(pages=True)),
    }[call]
    with pytest.raises(RuntimeError):
        fn(*args, **kw)
    before = getattr(mod, counter)
    fn(*args, **kw, device="cpu")
    assert getattr(mod, counter) == before


def _exported_text(lib):
    """`csrc/<lib>.cu`, with each `PA_EXPORTS(T, sfx)` line written out as
    the three entry points `paged_attention.cuh`'s macros emit."""
    text = (build.CSRC / f"{lib}.cu").read_text()
    cuh = (build.CSRC / "paged_attention.cuh").read_text()
    one = re.search(r"#define PA_EXPORT\(T, MODE, name\)(.*?\})\n", cuh,
                    re.S).group(1)
    names = re.findall(r"PA_EXPORT\(T, \w+, (\w+)##sfx\)", cuh)
    for sfx in re.findall(r"^PA_EXPORTS\(\w+, (\w+)\)", text, re.M):
        text += "".join(one.replace("name", base + sfx) for base in names)
    return text


def test_exported_symbols_match_the_wrappers():
    """Each wrapper's C symbols are exported by its source (for paged
    attention, the query type's source), with as many
    parameters as the wrapper's argtypes declare — checked here, where
    no compiler runs."""
    for mod, src in ((tpaged, None), (trotary, "rotary"),
                     (tswiglu, "swiglu"), (tfused_norm, "fused_norm"),
                     (tadam, "adam"), (tquant, "quant"),
                     (tsample, "sample"), (tkv_write, "kv_write")):
        # paged attention exports each query type's symbols from a
        # source of its own (`_LIBRARY`)
        source_of = {sym: tpaged._LIBRARY[dtype] for (dtype, _), sym in
                     tpaged._SYMBOLS.items()} if mod is tpaged else {}
        for sym, argtypes in mod._SIGNATURES.items():
            lib = source_of.get(sym, src)
            text = _exported_text(lib)
            m = re.search(rf"HETU_EXPORT int {sym}\(([^)]*)\)", text)
            assert m, f"{sym} not exported by {lib}.cu"
            assert len(m.group(1).split(",")) == len(argtypes), sym
    assert set(build.SOURCES) == {p.stem for p in build.CSRC.glob("*.cu")}
