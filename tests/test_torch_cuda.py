"""The PyTorch port's hand-written CUDA kernels against their plain
versions, on the card.

This file imports no JAX, so it runs on a GPU machine that has none:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(`--noconftest` skips tests/conftest.py, which sets JAX up).  Every test
is marked `cuda` and skips where there is no card; whether there is one
is decided in a fixture at run time, never at import, so every pytest
worker collects the same tests.  Tolerances: the plain versions repeat
the kernels' fp32 arithmetic, so outputs the kernels round once to
bf16 (rotary, SwiGLU and their backwards, the fused norm's y, s and dx)
agree within one bf16 ulp, fp32 outputs within 1e-5 relative (plus
1e-6 absolute where terms cancel; the norm's 1e-5 for row sums taken
in another order), AdamW within one fp32 ulp (rtol 3e-7); paged
attention within 1e-4 on fp32 pools; on bf16 pools its output, rounded once to
bf16, lies within half a bf16 ulp (plus 1e-5 for fp32 summation order)
of the plain version on the same values in fp32, which a wrong
rounding or a dropped key breaks.  The flash kernels, against the plain
version on the same values in fp32: the fp32 arm within 1e-5 of each
output's largest entry (fp32 sums in another order); the bf16 arm rounds
P and dS to bf16 for the tensor cores (2^-9 relative a term), so o lies
within half a bf16 ulp + 2^-9 max|v|, the fp32 gradients of `_bwd`
within 2^-8 of their largest entry, and the Function's bf16 gradients
within 2^-7 of it (their own rounding, and delta taken from the rounded
o).  The training step on the card is held against the same step on the
CPU (the plain versions).

The second serving slice's kernels: the blockwise quantize bit for bit
(payload and scales: true divisions on both sides); paged attention and
verify over int8/int4 pages as over exact ones, against the plain
version on the same quantized pool in fp32 (NaN planted where no key
may be read); the sampler over existing logits token for token; the
fused sampler's product within 1e-5 of the largest logit, its tokens
identical wherever the plain top-two gap after noise exceeds 1e-3; the
sampled, speculative, quantized engine token for token against the CPU.
"""
from __future__ import annotations

import pytest
import torch

import numpy as np

from hetu_tpu_torch.engine import Trainer, TrainingConfig
from hetu_tpu_torch.models.llama import LlamaConfig, LlamaLMHeadModel
from hetu_tpu_torch.ops.cuda import adam as tadam
from hetu_tpu_torch.ops.cuda import flash_attention as tflash
from hetu_tpu_torch.ops.cuda import fused_norm as tfused_norm
from hetu_tpu_torch.ops import quantization as tquantization
from hetu_tpu_torch.ops.cuda import paged_attention as tpaged
from hetu_tpu_torch.ops.cuda import quant as tquant
from hetu_tpu_torch.ops.cuda import rotary as trotary
from hetu_tpu_torch.ops.cuda import sample as tsample
from hetu_tpu_torch.ops.cuda import swiglu as tswiglu
from hetu_tpu_torch.ops.rotary import build_rope_cache
from hetu_tpu_torch.serving import (SamplingParams, ServeConfig,
                                    ServingEngine, poisson_arrivals,
                                    synthetic_requests)
from hetu_tpu_torch.serving import sampling as tsampling

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _normal(shape, seed, dev, dtype=torch.float32):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randn(shape, generator=g).to(dev, dtype)


def _bf16_close(a, b):
    """Within one bf16 ulp (8 significant bits) of the larger of the
    two, elementwise."""
    a, b = a.float(), b.float()
    _, exp = torch.frexp(torch.maximum(a.abs(), b.abs()))
    ulp = torch.ldexp(torch.ones_like(a), exp - 8)
    assert bool(((a - b).abs() <= ulp).all()), \
        f"max diff {(a - b).abs().max().item()}"


def _close(a, b):
    """fp32 outputs within 1e-5 relative (+1e-6 where terms cancel);
    bf16 outputs, rounded once, within one bf16 ulp."""
    if a.dtype == torch.float32:
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    else:
        _bf16_close(a, b)


def _rounded_once_to_bf16(out, ref_f32, atol=1e-5):
    """`out` (bf16) is `ref_f32` rounded to nearest: within half a bf16
    ulp of the larger of the two, plus `atol` for fp32 summation order."""
    a = out.float()
    _, exp = torch.frexp(torch.maximum(a.abs(), ref_f32.abs()))
    half_ulp = torch.ldexp(torch.ones_like(a), exp - 9)
    err = (a - ref_f32).abs()
    assert bool((err <= half_ulp + atol).all()), \
        f"max diff {err.max().item()}, worst excess " \
        f"{(err - half_ulp).max().item()}"


def _paged_case(dev, dtype, S=4, P=9, ps=8, n_kv=2, nq=4, hd=128):
    kp = _normal((P, ps, n_kv, hd), 0, dev, dtype)
    vp = _normal((P, ps, n_kv, hd), 1, dev, dtype)
    q = _normal((S, nq, hd), 2, dev, dtype)
    table = torch.tensor([[1, 2, 3, 0], [4, 5, 0, 0], [6, 7, 8, 0],
                          [0, 0, 0, 0]], dtype=torch.int32, device=dev)
    positions = torch.tensor([20, 9, 17, 0], dtype=torch.int32, device=dev)
    return q, kp, vp, table, positions


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nq,hd", [(4, 128),     # Llama-3 head dim
                                   (4, 64),      # the smaller Llama one
                                   (6, 128),     # group 3 runs as 4
                                   (2, 128),     # group 1
                                   (32, 256)])   # > 48 KB shared memory
def test_paged_attention_matches_plain(dev, dtype, nq, hd):
    q, kp, vp, table, positions = _paged_case(dev, dtype, nq=nq, hd=hd)
    before = tpaged.launches
    out = tpaged.paged_attention(q, kp, vp, table, positions)
    torch.cuda.synchronize()
    assert tpaged.launches == before + 1
    ref = tpaged.paged_attention_plain(q.float(), kp.float(), vp.float(),
                                       table, positions, hd ** -0.5)
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)
    else:
        _rounded_once_to_bf16(out, ref)


def test_paged_attention_rejects_unaligned_rows(dev):
    """The kernel stages rows with 16-byte loads: a head dim whose rows
    are not a multiple of 16 bytes (100 bf16 values, 200 bytes) raises,
    it never launches."""
    q, kp, vp, table, positions = _paged_case(dev, torch.bfloat16, hd=100)
    before = tpaged.launches
    with pytest.raises(ValueError, match="16-byte"):
        tpaged.paged_attention(q, kp, vp, table, positions)
    assert tpaged.launches == before


def test_paged_attention_skips_stale_bytes(dev):
    """NaN in the null page and in a page past slot 0's position must
    not reach any output: the kernel never loads those keys."""
    q, kp, vp, table, positions = _paged_case(dev, torch.float32)
    clean = tpaged.paged_attention(q, kp, vp, table, positions)
    for pool in (kp, vp):
        pool[0, 1:] = float("nan")
        pool[3, 5:] = float("nan")          # slot 0 sees page 3 rows 0..4
    out = tpaged.paged_attention(q, kp, vp, table, positions)
    assert bool(torch.isfinite(out).all())
    torch.testing.assert_close(out, clean, atol=0, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s", [(8, 1), (1, 37)])
def test_rotary_matches_plain(dev, dtype, b, s):
    hd = 128
    cos, sin = build_rope_cache(64, hd, 500000.0, device=dev)
    pos = torch.randint(0, 64, (b, s), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(3))
    q = _normal((b, s, 8, hd), 4, dev, dtype)
    k = _normal((b, s, 2, hd), 5, dev, dtype)
    cos_t, sin_t = cos[pos].contiguous(), sin[pos].contiguous()
    before = trotary.launches
    tq, tk = trotary.fused_rotary_qk(q, k, cos_t, sin_t)
    assert trotary.launches == before + 1
    rq, rk = trotary.rotary_qk_plain(q, k, cos_t, sin_t)
    _close(tq, rq)
    _close(tk, rk)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_swiglu_matches_plain_on_strided_views(dev, dtype):
    gu = _normal((3, 7, 2, 384), 6, dev, dtype)
    before = tswiglu.launches
    out = tswiglu.fused_swiglu(gu)
    assert tswiglu.launches == before + 1
    _close(out, tswiglu.swiglu_plain(gu[:, :, 0], gu[:, :, 1]))


def test_engine_on_the_card_matches_the_cpu(dev):
    """The whole slice at a small size in fp32: the engine on the card
    (the kernels) emits the tokens the same engine emits on the CPU (the
    plain versions), for the same weights and trace."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = LlamaConfig.tiny(hidden_size=256, num_attention_heads=4,
                           num_key_value_heads=2, intermediate_size=512,
                           compute_dtype=torch.float32,
                           initializer_range=0.1)
    cpu_model = LlamaLMHeadModel(cfg, device="cpu", seed=0)
    gpu_model = LlamaLMHeadModel(cfg, device=dev, seed=0)
    gpu_model.load_state_dict(cpu_model.state_dict())
    serve = ServeConfig(num_slots=3, page_size=8, max_len=64,
                        prefill_chunk=16)

    def run(model, device):
        reqs = synthetic_requests(5, vocab_size=cfg.vocab_size,
                                  prompt_lens=(3, 40), max_new=(4, 8),
                                  arrivals=poisson_arrivals(5, 50.0, seed=1),
                                  seed=2)
        eng = ServingEngine(model, serve, device=device).warmup()
        res = eng.run(reqs)
        eng.scheduler.check_invariants()
        return [r.tokens for r in res]

    counts = (tpaged.launches, trotary.launches, tswiglu.launches)
    on_card = run(gpu_model, dev)
    assert all(after > before for after, before in zip(
        (tpaged.launches, trotary.launches, tswiglu.launches), counts))
    assert on_card == run(cpu_model, "cpu")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_swiglu_backward_matches_plain(dev, dtype):
    """dgate/dup written into the two strided halves of one buffer."""
    gu = _normal((3, 7, 2, 384), 7, dev, dtype)
    dy = _normal((3, 7, 384), 8, dev, dtype)
    before = tswiglu.bwd_launches
    dgu = tswiglu.swiglu_bwd(gu, dy)
    assert tswiglu.bwd_launches == before + 1
    assert dgu.shape == gu.shape and dgu.is_contiguous()
    dg, du = tswiglu.swiglu_bwd_plain(gu[..., 0, :], gu[..., 1, :], dy)
    _close(dgu[..., 0, :], dg)
    _close(dgu[..., 1, :], du)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rotary_backward_matches_plain(dev, dtype):
    hd = 128
    cos, sin = build_rope_cache(64, hd, 500000.0, device=dev)
    pos = torch.randint(0, 64, (2, 37), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(4))
    dq = _normal((2, 37, 8, hd), 9, dev, dtype)
    dk = _normal((2, 37, 2, hd), 10, dev, dtype)
    cos_t, sin_t = cos[pos].contiguous(), sin[pos].contiguous()
    before = trotary.bwd_launches, trotary.launches
    gq, gk = trotary.rotary_qk_bwd(dq, dk, cos_t, sin_t)
    assert (trotary.bwd_launches, trotary.launches) == (before[0] + 1,
                                                         before[1])
    rq, rk = trotary.rotary_qk_plain(dq, dk, cos_t, -sin_t)
    _close(gq, rq)
    _close(gk, rk)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hidden", [256, 4096, 1000])
def test_fused_norm_matches_plain(dev, dtype, hidden):
    """Forward y/s and backward dx/dw; a ragged hidden (1000) runs the
    masked columns; dw is the same bits on a second run (per-block
    partials, no atomics)."""
    x = _normal((3, 11, hidden), 11, dev, dtype)
    h = _normal((3, 11, hidden), 12, dev, dtype)
    w = 1.0 + 0.1 * _normal((hidden,), 13, dev)
    dy = _normal((3, 11, hidden), 14, dev, dtype)
    dr = _normal((3, 11, hidden), 15, dev, dtype)
    before = tfused_norm.launches, tfused_norm.bwd_launches
    y, s = tfused_norm.residual_rmsnorm_fwd(x, h, w)
    dx, dw = tfused_norm.residual_rmsnorm_bwd(s, w, dy, dr)
    assert (tfused_norm.launches, tfused_norm.bwd_launches) == (
        before[0] + 1, before[1] + 1)
    ry, rs = tfused_norm.residual_rmsnorm_plain(x, h, w, 1e-5)
    rdx, rdw = tfused_norm.residual_rmsnorm_bwd_plain(s, w, dy, dr, 1e-5)
    assert dw.dtype == torch.float32
    torch.testing.assert_close(dw, rdw, rtol=1e-5, atol=1e-5)
    if dtype == torch.float32:
        for a, b in ((y, ry), (s, rs), (dx, rdx)):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    else:
        for a, b in ((y, ry), (s, rs), (dx, rdx)):
            _bf16_close(a, b)
    _, dw2 = tfused_norm.residual_rmsnorm_bwd(s, w, dy, dr)
    assert torch.equal(dw, dw2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adam_matches_plain(dev, dtype):
    """Two in-place steps on a leaf whose size is no multiple of 128."""
    n = 1000 * 37
    p = _normal((n,), 16, dev, dtype)
    g = 0.1 * _normal((n,), 17, dev)
    m, v = torch.zeros(n, device=dev), torch.zeros(n, device=dev)
    ref = [t.clone() for t in (p, m, v)]
    before = tadam.launches
    for step in (1, 2):
        c1 = np.float32(1) - np.float32(0.9) ** np.float32(step)
        c2 = np.float32(1) - np.float32(0.95) ** np.float32(step)
        kw = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
        tadam.adam_update(p, g, m, v, 1e-3, c1, c2, **kw)
        tadam.adam_plain(*ref[:1], g, *ref[1:], 1e-3, c1, c2, **kw)
    assert tadam.launches == before + 2
    for a, b in zip((p, m, v), ref):
        torch.testing.assert_close(a.float(), b.float(), rtol=3e-7,
                                   atol=1e-10)


# ------------------------------------------------------------ flash
_DEAD_ROW = ((True, False, True, False), (False, False, False, False))
#: name -> (sq, sk, block_q, block_k, what the case turns on)
_FLASH_CASES = {
    "causal": (256, 256, 128, 128, {}),
    "full": (128, 256, 64, 128, {"causal": False}),
    "sq_ne_sk": (128, 256, 64, 64, {}),                # bottom-right
    "segments": (256, 256, 128, 64, {"segments": True}),
    "dead_row": (128, 256, 64, 64, {"block_mask": _DEAD_ROW,
                                    "causal": False}),
    "ragged_blocks": (192, 96, 96, 96, {}),            # 64 + 32 row tiles
    "future_chunk": (128, 128, 64, 64, {"k_offset": 1000}),
}


def _flash_inputs(dev, dtype, sq, sk, hq, hkv, d, opts):
    b = 2
    q = _normal((b, sq, hq, d), 20, dev, dtype)
    k = _normal((b, sk, hkv, d), 21, dev, dtype)
    v = _normal((b, sk, hkv, d), 22, dev, dtype)
    kw = {key: opts[key] for key in ("causal", "block_mask") if key in opts}
    if opts.get("segments"):
        cut_q, cut_k = sq // 3, sk // 3 + (sk - sq)
        kw["segment_ids"] = (torch.arange(sq, device=dev) >= cut_q).int()[
            None].expand(b, sq).contiguous()
        kw["kv_segment_ids"] = (torch.arange(sk, device=dev) >= cut_k).int()[
            None].expand(b, sk).contiguous()
    if "k_offset" in opts:
        kw["q_positions"] = torch.arange(
            sq, dtype=torch.int32, device=dev)[None].expand(b, sq)
        kw["kv_positions"] = (torch.arange(sk, dtype=torch.int32, device=dev)
                              + opts["k_offset"])[None].expand(b, sk)
    return q, k, v, kw


def _of_max(a, b, rtol=1e-5):
    scale = max(float(b.abs().max()), 1e-30)
    err = float((a.float() - b.float()).abs().max())
    assert err <= rtol * scale + 1e-6, f"max diff {err} of {scale}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,hq,hkv", [(128, 4, 1), (64, 2, 2), (128, 8, 2)])
@pytest.mark.parametrize("case", sorted(_FLASH_CASES))
def test_flash_matches_plain(dev, dtype, d, hq, hkv, case):
    """Forward (o, lse) and backward (dq, dk, dv, fp32) of the three
    kernels against the plain versions on the same values in fp32; one
    launch of each; a second backward gives the same bits (the group is
    summed in registers, no atomics)."""
    sq, sk, bq, bk, opts = _FLASH_CASES[case]
    q, k, v, kw = _flash_inputs(dev, dtype, sq, sk, hq, hkv, d, opts)
    kw.update(block_q=bq, block_k=bk)
    before = tflash.launches, tflash.dq_launches, tflash.dkv_launches
    o, lse = tflash.flash_attention_with_lse(q, k, v, **kw)
    torch.cuda.synchronize()
    ro, rlse = tflash.flash_attention_with_lse(
        q.float().cpu(), k.float().cpu(), v.float().cpu(),
        **{key: t.cpu() if torch.is_tensor(t) else t
           for key, t in kw.items()}, device="cpu")
    assert o.dtype == dtype and lse.dtype == torch.float32
    assert bool(torch.isfinite(o).all())
    if case in ("dead_row", "future_chunk"):
        rows = slice(64, None) if case == "dead_row" else slice(None)
        assert bool((o[:, rows] == 0).all())
        assert bool((lse[:, :, rows] == tflash.NEG_INF).all())
    torch.testing.assert_close(lse.cpu(), rlse, rtol=1e-5, atol=1e-5)
    if dtype == torch.float32:
        _of_max(o.cpu(), ro)
    else:   # + what rounding P to bf16 adds: at most 2^-9 of max|v|
        _rounded_once_to_bf16(
            o.cpu(), ro, atol=1e-5 + 2.0 ** -9 * float(v.abs().max()))
    # backward through the Function: one dq and one dk/dv launch
    grads = []
    for _ in range(2):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = tflash.flash_attention(*leaves, **kw)
        do = _normal(out.shape, 23, dev, dtype)
        out.backward(do)
        grads.append([t.grad for t in leaves])
    torch.cuda.synchronize()
    assert (tflash.launches, tflash.dq_launches, tflash.dkv_launches) == (
        before[0] + 3, before[1] + 2, before[2] + 2)
    for a, b2 in zip(*grads):
        assert torch.equal(a, b2)
    ref = [t.float().cpu().requires_grad_(True) for t in (q, k, v)]
    tflash.flash_attention(
        *ref, **{key: t.cpu() if torch.is_tensor(t) else t
                 for key, t in kw.items()}, device="cpu").backward(
        do.float().cpu())
    for mine, r in zip(grads[0], ref):
        assert mine.dtype == dtype
        if dtype == torch.float32:
            _of_max(mine.cpu(), r.grad)
        else:   # rounded once to bf16 by the Function (half an ulp),
            # and delta was taken from the o the kernel rounded
            _of_max(mine.cpu(), r.grad, rtol=2.0 ** -7)


def test_flash_never_loads_a_dead_tile(dev):
    """NaN in the keys and values of a k block that is dead for every q
    block reaches no output and no gradient: the kernels skip a dead
    tile before they load it."""
    q, k, v, kw = _flash_inputs(dev, torch.float32, 128, 256, 4, 2, 128,
                                _FLASH_CASES["dead_row"][4])
    k[:, 64:128], v[:, 64:128] = float("nan"), float("nan")
    leaves = [t.requires_grad_(True) for t in (q, k, v)]
    out = tflash.flash_attention(*leaves, block_q=64, block_k=64, **kw)
    out.sum().backward()
    assert bool(torch.isfinite(out).all())
    for t in leaves:
        assert bool(torch.isfinite(t.grad).all())
    assert bool((leaves[1].grad[:, 64:128] == 0).all())
    assert bool((leaves[0].grad[:, 64:] == 0).all())


def test_flash_bwd_returns_fp32_and_takes_delta(dev):
    """`_fwd`/`_bwd` on [b, h, s, d]: fp32 gradients for bf16 inputs,
    with delta passed in and left out."""
    q, k, v, _ = _flash_inputs(dev, torch.bfloat16, 128, 128, 4, 2, 128, {})
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    pos = torch.arange(128, dtype=torch.int32, device=dev)[None].expand(2, -1)
    kw = dict(scale=128 ** -0.5, causal=True, block_q=64, block_k=64,
              block_mask=tflash.causal_block_mask(128, 128, 64, 64))
    o, lse = tflash._fwd(qt, kt, vt, pos, pos, None, None, **kw)
    do = _normal(o.shape, 24, dev, torch.bfloat16)
    got = tflash._bwd(qt, kt, vt, o, lse, do, pos, pos, None, None, **kw)
    delta = (do.float() * o.float()).sum(-1)
    again = tflash._bwd(qt, kt, vt, o, lse, do, pos, pos, None, None,
                        delta=delta, **kw)
    ref = tflash.flash_bwd_plain(
        qt, kt, vt, lse, do, delta, pos, pos, None, None, scale=kw["scale"],
        causal=True, block_q=64, block_k=64,
        live=tflash._mask_tensor(kw["block_mask"], torch.device(dev)))
    for a, b2, r in zip(got, again, ref):
        assert a.dtype == torch.float32 and torch.equal(a, b2)
        _of_max(a, r, rtol=2.0 ** -8)   # P and dS rounded to bf16


@pytest.mark.parametrize("fault", ["head_dim", "dtype", "heads", "blocks"])
def test_flash_rejects_what_the_kernels_do_not_take(dev, fault):
    d = 96 if fault == "head_dim" else 128
    dtype = torch.float16 if fault == "dtype" else torch.bfloat16
    hkv = 3 if fault == "heads" else 2
    q = torch.zeros((1, 128, 4, d), dtype=dtype, device=dev)
    k = torch.zeros((1, 128, hkv, d), dtype=dtype, device=dev)
    kw = {"block_mask": ((True,),)} if fault == "blocks" else {}
    before = tflash.launches
    with pytest.raises(ValueError):
        tflash.flash_attention(q, k, k, block_q=64, block_k=64, **kw)
    assert tflash.launches == before


def _three_steps(model, device):
    tc = TrainingConfig(global_batch_size=4, micro_batch_size=2, seq_len=32,
                        warmup_steps=1, total_steps=10, log_every=100)
    tr = Trainer(model, tc, device=device)
    ids = np.random.default_rng(0).integers(
        0, model.config.vocab_size, (4, 32)).astype(np.int32)
    labels = ids.copy()
    labels[1, :5] = -100
    metrics = [tr.train_step({"input_ids": ids, "labels": labels})
               for _ in range(3)]
    return ([{k: float(v) for k, v in m.items()} for m in metrics],
            [p.detach().cpu() for p in model.parameters()])


@pytest.mark.parametrize("use_flash,remat_policy", [
    (False, "nothing"), (True, "nothing"), (True, "dots"),
    (True, "dots_attn")])
def test_training_on_the_card_matches_the_cpu(dev, use_flash, remat_policy):
    """Three Trainer steps of a narrow Llama (hidden 512, 4 q over 2 kv
    heads of 128, 2 layers) in fp32: the card (the kernels, every
    training kernel launched its count per step) against the CPU (the
    plain versions; flash's plain version forced, since the CPU's auto
    route is the dense attention), same weights and batches, with the
    dense attention and with flash under each recompute policy.  Losses
    and grad norms agree to 1e-5; AdamW normalizes each step, so an
    element whose gradient is within rounding of zero can move by up to
    lr in one run and not the other: parameters agree within 2 x the
    summed lr everywhere and within 1e-5 on all but 0.1% of elements."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = LlamaConfig.tiny(hidden_size=512, num_attention_heads=4,
                           num_key_value_heads=2, intermediate_size=1536,
                           vocab_size=4096, compute_dtype=torch.float32,
                           use_flash_attention=use_flash,
                           remat_policy=remat_policy)
    cpu_model = LlamaLMHeadModel(cfg, device="cpu", seed=0)
    gpu_model = LlamaLMHeadModel(cfg, device=dev, seed=0)
    gpu_model.load_state_dict(cpu_model.state_dict())
    if use_flash:
        for layer in cpu_model.model.layers:
            layer.attn.use_pallas = True

    def counts():
        return {"norm": (tfused_norm.launches, tfused_norm.bwd_launches),
                "swiglu": (tswiglu.launches, tswiglu.bwd_launches),
                "rotary": (trotary.launches, trotary.bwd_launches),
                "adam": (tadam.launches, 0),
                "flash": (tflash.launches, tflash.dq_launches),
                "flash_dkv": (tflash.dkv_launches, 0)}
    before = counts()
    on_card, card_params = _three_steps(gpu_model, dev)
    after = counts()
    L, n_micro, steps = cfg.num_hidden_layers, 2, 3
    fwd, bwd = 2 * L * n_micro, L * n_micro
    flash_fwd = 0 if not use_flash else (
        bwd if remat_policy == "dots_attn" else fwd)
    per_step = {"norm": (fwd, bwd), "swiglu": (fwd, bwd),
                "rotary": (fwd, bwd), "adam": (len(card_params), 0),
                "flash": (flash_fwd, bwd if use_flash else 0),
                "flash_dkv": (bwd if use_flash else 0, 0)}
    for name, expect in per_step.items():
        got = tuple(a - b for a, b in zip(after[name], before[name]))
        assert got == tuple(steps * n for n in expect), name
    on_cpu, cpu_params = _three_steps(cpu_model, "cpu")
    for c, g in zip(on_cpu, on_card):
        for k in ("loss", "grad_norm", "lr"):
            assert abs(c[k] - g[k]) <= 1e-5 * abs(c[k]), (k, c, g)
    bound = 2 * sum(m["lr"] for m in on_cpu)
    for a, b in zip(card_params, cpu_params):
        d = (a - b).abs()
        assert d.max() <= bound
        assert (d > 1e-5).float().mean() <= 1e-3


# ------------------------------------------- second serving slice kernels
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bs,bits", [(128, 8), (64, 8), (256, 8), (32, 8),
                                     (128, 4)])
def test_quantize_blockwise_matches_plain(dev, dtype, bs, bits):
    """Payload bit for bit, scales exactly (true divisions on both
    sides)."""
    x = _normal((3000, bs), 5, dev, dtype) * _normal((3000, 1), 6, dev).exp()
    x[7] = 0.0                               # the 1e-12 floor
    before = tquant.launches
    q, s = tquant.quantize_blockwise(x, bs, bits=bits)
    torch.cuda.synchronize()
    assert tquant.launches == before + 1
    rq, rs = tquant.quantize_blockwise_plain(x, bs, bits)
    assert torch.equal(q, rq)
    assert torch.equal(s, rs)


def test_quantize_blockwise_refuses_other_block_sizes(dev):
    """The kernel holds a block in one warp's registers: 32, 64, 128 or
    256 values; other sizes raise before a launch (the plain version
    takes any)."""
    x = _normal((10, 96), 7, dev)
    before = tquant.launches
    with pytest.raises(ValueError, match="block sizes"):
        tquant.quantize_blockwise(x, 96)
    assert tquant.launches == before
    tquant.quantize_blockwise(x.cpu(), 96, device="cpu")


def _quant_pool(pool, quant):
    """Quantize an fp32 pool [P, ps, n_kv, hd] by the pool's own path."""
    return tquantization.quantize_heads(pool, 4 if quant == "int4" else 8)


def _check_paged(out, ref, dtype):
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)
    else:
        _rounded_once_to_bf16(out, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_quantized_paged_attention_matches_plain(dev, dtype, quant):
    q, kp, vp, table, positions = _paged_case(dev, torch.float32)
    (k8, ks), (v8, vs) = _quant_pool(kp, quant), _quant_pool(vp, quant)
    counter = f"{quant}_launches"
    before = getattr(tpaged, counter)
    out = tpaged.paged_attention(q.to(dtype), k8, v8, table, positions,
                                 k_scale=ks, v_scale=vs, quant=quant)
    torch.cuda.synchronize()
    assert getattr(tpaged, counter) == before + 1
    ref = tpaged.paged_attention_plain(q.to(dtype).float(), k8, v8, table,
                                       positions, 128 ** -0.5, ks, vs, quant)
    _check_paged(out, ref, dtype)


@pytest.mark.parametrize("half", ["low", "high"])
def test_int4_pages_unpack_both_nibbles(dev, half):
    """Payload bytes whose other nibble holds 8 (the value 0): each
    half alone must reach the output, in its own head dim."""
    q, kp, vp, table, positions = _paged_case(dev, torch.float32)
    g = torch.Generator(device="cpu").manual_seed(11)
    pages = []
    for _ in range(2):
        nib = torch.randint(0, 16, (*kp.shape[:-1], 64), generator=g)
        byte = nib | (8 << 4) if half == "low" else 8 | (nib << 4)
        pages.append(byte.to(torch.uint8).to(dev))
    scales = [_normal(kp.shape[:-1], i, dev).abs() + 0.1 for i in (12, 13)]
    out = tpaged.paged_attention(q, *pages, table, positions,
                                 k_scale=scales[0], v_scale=scales[1],
                                 quant="int4")
    ref = tpaged.paged_attention_plain(q, *pages, table, positions,
                                       128 ** -0.5, *scales, "int4")
    _check_paged(out, ref, torch.float32)
    dead = slice(1, None, 2) if half == "low" else slice(0, None, 2)
    assert bool((out[..., dead] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("quant", ["none", "int8", "int4"])
def test_paged_verify_matches_plain(dev, dtype, quant):
    """C = 5 queries a slot at the Llama-3-8B group (4), one block
    running past its table row; NaN planted in every key past the last
    query's position and in the null page must not reach the output."""
    _, kp, vp, table, _ = _paged_case(dev, torch.float32)
    q = _normal((4, 5, 4, 128), 14, dev)
    positions = torch.tensor([20, 9, 28, 0], dtype=torch.int32, device=dev)
    if quant == "none":
        kp, vp, ks, vs = kp.to(dtype), vp.to(dtype), None, None
    else:
        (kp, ks), (vp, vs) = _quant_pool(kp, quant), _quant_pool(vp, quant)
    kw = dict(k_scale=ks, v_scale=vs, quant=quant)
    ref = tpaged.paged_verify_plain(q.to(dtype).float(), kp, vp, table,
                                    positions, 128 ** -0.5, ks, vs, quant)
    stale = torch.full_like(kp[0, 0], 255 if quant == "int4" else 0)
    if quant == "none":
        stale = torch.full_like(kp[0, 0], float("nan"))
    ps = kp.shape[1]
    for s in range(4):                     # keys past pos + C - 1
        for j in range(table.shape[1] * ps):
            page = int(table[s, j // ps])
            if page and j > int(positions[s]) + 4:
                kp[page, j % ps] = stale
                vp[page, j % ps] = stale
                if ks is not None:
                    ks[page, j % ps] = float("nan")
                    vs[page, j % ps] = float("nan")
    before = tpaged.verify_launches
    out = tpaged.paged_verify(q.to(dtype), kp, vp, table, positions, **kw)
    torch.cuda.synchronize()
    assert tpaged.verify_launches == before + 1
    assert bool(torch.isfinite(out).all())
    _check_paged(out, ref, dtype)


def _sampling_rows(dev, R, V, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    temps = torch.tensor([0.0, 1.0, 0.8, 0.7, 1.2, 0.9, 1.0, 0.0] * 16)[:R]
    top_ks = torch.tensor([0, 0, 50, 0, 20, 40, V, 3] * 16,
                          dtype=torch.int32)[:R]
    top_ps = torch.tensor([0, 0, 0, 0.9, 0.95, 0.8, 0.5, 0.9] * 16)[:R]
    seeds = torch.randint(0, 2 ** 32, (R,), generator=g)
    positions = torch.randint(0, 4096, (R,), generator=g)
    words = tsampling.key_words(seeds, positions)
    return [t.to(dev) for t in (words, temps, top_ks, top_ps)]


def _noisy_gap(logits, words, temps, top_ks, top_ps):
    """The gap between the two best entries of what each row's argmax
    runs over: the raw logits (greedy rows) or filtered + noise."""
    V = logits.shape[-1]
    filt = tsample.filtered_logits(logits, temps, top_ks, top_ps)
    idx = torch.arange(V, device=logits.device)[None]
    v = torch.where(temps[:, None] > 0,
                    filt + tsample.gumbel(words[:, :1], words[:, 1:], idx),
                    logits.float())
    top = v.topk(2, dim=-1).values
    return top[:, 0] - top[:, 1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("V", [128256, 4000, 13])
def test_sample_logits_matches_plain(dev, dtype, V):
    """Filter and draw over existing logits: tokens identical to the
    sort-based plain version (ties at the top take the first index);
    at V = 13 some of a row's 8 blocks hold one entry or none."""
    R = 16
    logits = (3.0 * _normal((R, V), 15, dev)).to(dtype)
    logits[0, min(100, V - 1)] = logits[0, 7] = logits[0].max() + 1  # tie
    args = _sampling_rows(dev, R, V, 16)
    before = tsample.logits_launches
    out = tsample.sample_logits(logits, *args)
    torch.cuda.synchronize()
    assert tsample.logits_launches == before + 1
    assert int(out[0]) == 7
    assert torch.equal(out, tsample.sample_plain(logits, *args))


def _words_with_infinite_noise(idx, w0):
    """Key words whose counter hash at `idx` has 0xFFFFFF in its 24 high
    bits (the murmur finalizer inverted): the uniform rounds to 1.0 and
    the Gumbel noise there is +inf."""
    m = 0xFFFFFFFF
    x = 0xFFFFFF00
    x ^= x >> 16
    x = (x * pow(0xC2B2AE35, -1, 2 ** 32)) & m
    x ^= (x >> 13) ^ (x >> 26)
    x = (x * pow(0x85EBCA6B, -1, 2 ** 32)) & m
    x ^= x >> 16
    return [w0, (x - (w0 ^ ((idx * 0x9E3779B1) & m))) & m]


@pytest.mark.parametrize("V", [128256, 4000])
def test_filtered_entry_with_infinite_noise_wins(dev, V):
    """A filtered entry (-1e30) whose noise is +inf wins the plain
    version's argmax, as the reference's: the kernel takes it too, with
    the kept set in shared memory (top-k) or walked in the row (top-p
    alone), and where it is kept (temperature alone)."""
    logits = 3.0 * _normal((5, V), 21, dev)
    target = logits.argmin(dim=-1)
    words = torch.tensor([_words_with_infinite_noise(int(t), 29 * r + 3)
                          for r, t in enumerate(target)], device=dev)
    temps = torch.tensor([1.0, 0.8, 0.9, 1.0, 0.7], device=dev)
    top_ks = torch.tensor([5, 0, 20, 0, 50], dtype=torch.int32, device=dev)
    top_ps = torch.tensor([0.0, 0.5, 0.9, 0.0, 0.95], device=dev)
    args = (words, temps, top_ks, top_ps)
    plain = tsample.sample_plain(logits, *args)
    assert torch.equal(plain, target.int())
    assert torch.equal(tsample.sample_logits(logits, *args), plain)


@pytest.mark.parametrize("R,V,dtype", [
    (24, 32000, torch.bfloat16),     # the tensor cores, 2 row tiles
    (70, 32000, torch.bfloat16),     # two row blocks
    (24, 32000, torch.float32),      # fp32 FMAs, 16-byte loads
    (24, 32001, torch.bfloat16)])    # rows off 16-byte runs
def test_fused_sample_matches_plain(dev, R, V, dtype):
    """The product within 1e-5 of the largest logit against the fp32
    product; tokens identical wherever the plain top-two gap after noise
    exceeds 1e-3."""
    H = 1024
    hidden = _normal((R, H), 17, dev, dtype)
    w = (0.05 * _normal((H, V), 18, dev)).to(dtype)
    args = _sampling_rows(dev, R, V, 19)
    logits = tsample.lm_head_logits(hidden, w)
    ref = hidden.float() @ w.float()
    assert (logits - ref).abs().max() <= 1e-5 * ref.abs().max()
    before = tsample.launches
    out = tsample.fused_sample(hidden, w, *args)
    torch.cuda.synchronize()
    assert tsample.launches == before + 1
    plain = tsample.fused_sample_plain(hidden, w, *args)
    clear = _noisy_gap(ref, *args) > 1e-3
    assert clear.sum() >= R - max(2, R // 12)
    assert torch.equal(out[clear], plain[clear])


@pytest.mark.parametrize("opts", [
    dict(sampling=True, spec_decode="ngram", spec_k=3),
    dict(sampling=True, spec_decode="ngram", spec_k=3, kv_quant="int8"),
    dict(sampling=True, kv_quant="int4")])
def test_sampled_spec_quantized_engine_on_the_card_matches_the_cpu(dev, opts):
    """The second serving slice at a small size in fp32, half the
    requests seeded-sampled: the engine on the card (the kernels) emits
    the CPU engine's tokens (the plain versions)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = LlamaConfig.tiny(hidden_size=256, num_attention_heads=4,
                           num_key_value_heads=2, intermediate_size=512,
                           compute_dtype=torch.float32,
                           initializer_range=0.1)
    cpu_model = LlamaLMHeadModel(cfg, device="cpu", seed=0)
    gpu_model = LlamaLMHeadModel(cfg, device=dev, seed=0)
    gpu_model.load_state_dict(cpu_model.state_dict())
    serve = ServeConfig(num_slots=3, page_size=8, max_len=64,
                        prefill_chunk=16, **opts)

    def run(model, device):
        reqs = synthetic_requests(5, vocab_size=cfg.vocab_size,
                                  prompt_lens=(3, 40), max_new=(4, 8),
                                  arrivals=poisson_arrivals(5, 50.0, seed=1),
                                  seed=2)
        for r in reqs[1::2]:
            r.sampling = SamplingParams(temperature=0.9, top_k=20,
                                        top_p=0.9, seed=r.rid)
        eng = ServingEngine(model, serve, device=device).warmup()
        res = eng.run(reqs)
        eng.scheduler.check_invariants()
        return [(r.tokens, r.stats.spec_accepted) for r in res]

    on_card = run(gpu_model, dev)
    assert on_card == run(cpu_model, "cpu")
