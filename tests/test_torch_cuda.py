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
The sampler's product takes the tensor cores' K-major arm over a tied
table's transposed view (H 1024/1280, ragged V, 8-70 rows; the route
counter checked) and each head layout its own arm; the nucleus (a radix
select over mass, confirmed by the bisection's predicate) token for
token at its edges: top-p alone over V = 128,256, equal logits, one
dominant logit, top-p 1e-6 and 0.999999, a k-th value duplicated across
the cut, V = 13 (a row is excused only where a drawn token's mass above
lies within 1e-5 of top_p, and counted).

The fused norm's LayerNorm arm as its RMS arm (dw and db of its
backward 1e-5 of their largest entry); the GPT engine and trainer
against the CPU as the LLaMA ones.

The fused norms (all four kernels) on one row layout of 16-byte
chunks: the scalar arm (hidden 1004 bf16, 1002 fp32) against the plain
version, and on values one element off a 16-byte boundary the vector
arm's bits; 1, 7 and 8,193 rows (across the plan's rows a block and the
backward's one wave) and hidden 8,192, dw and db the same bits on a
second run.

SwiGLU's forward and RoPE stream 16-byte vectors where every base and
stride allows, else take a scalar arm of the same kernel: the same
values one element off a 16-byte boundary give the same bits.  RoPE
reads q and k in place from views of the fused QKV projection, forward,
backward and through autograd, against the plain version on contiguous
copies; `LlamaAttention.heads` launches that one kernel and no copy.

The third serving slice's: the blockwise dequantize bit for bit in both
output arms, at block sizes whose rows end inside a 16-byte vector and
on payload views off a 16-byte boundary; the model drafter with the
prefix cache on int8 pages token for token against the CPU.

The fp16 arms (the fourth training slice): SwiGLU, RoPE (from the fused
projection, positions restarting as in a packed row) and the fused RMS
and LayerNorm, forward and backward, within one fp16 ulp of their plain
versions (+1e-6 where the norms' sums cancel; dw, db 1e-5 of their
largest entry), each fp16 launch counted apart; flash in fp16 through
every case of the bf16 arm and over packed rows' segments: o within
half an fp16 ulp + 2^-10 max|v| (P rounded to fp16: 2^-11 relative, or
2^-25 absolute below fp16's normal range), the Function's fp16
gradients 2^-10 of their largest entry; a narrow Llama trained in fp16
on packed batches, card against CPU (the scale on "auto", the same
scale and no skip each step, loss and grad norm within 2e-3).

The fused KV page write (`ops/cuda/kv_write.py`) bit for bit against
its plain version in every page mode, fp32 and bf16, head dims 64 and
128, decode (C = 1) and verify (C = 5) blocks: K and V as the serving
forwards hand them over (RoPE's contiguous K and V a view of a LLaMA
fused projection; K and V views of GPT's), NaN planted in the
projection's q columns and in every page slot no write reaches (NaN
exact values, NaN scales), a row that is not decoding and a block past
its table row (the null page, compared only for having been written:
several rows land there in no defined order), GPT's exact pages in the
other type (the cast rounded once); the prefill write over a page row with null entries, untouched pages still NaN; and one launch
a layer on the paged forwards, no quantize launch.

LoRA (the `peft` slice): a narrow Llama and GPT with a bf16 frozen base
fine-tuned by `SFTTrainer` card against CPU (loss and grad norm within
2e-3 relative, the base unchanged and without gradients);
the adapters' gradients under every recompute policy equal, bit for
bit, those without recompute on the card (the in-segment merge, flash);
the numerics stats of card tensors those of the same values on the CPU
within 1e-6; AdamW's "update" stats taken a group of leaves at a time,
one launch a group.
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
from hetu_tpu_torch.ops.cuda import kv_write as tkv_write
from hetu_tpu_torch.ops import quantization as tquantization
from hetu_tpu_torch.ops.cuda import paged_attention as tpaged
from hetu_tpu_torch.ops.cuda import quant as tquant
from hetu_tpu_torch.ops.cuda import rotary as trotary
from hetu_tpu_torch.ops.cuda import sample as tsample
from hetu_tpu_torch.ops.cuda import swiglu as tswiglu
from hetu_tpu_torch.ops.rotary import build_rope_cache
from hetu_tpu_torch.serving import (Request, SamplingParams, ServeConfig,
                                    ServingEngine, poisson_arrivals,
                                    synthetic_requests)
from hetu_tpu_torch.serving import sampling as tsampling
from hetu_tpu_torch.serving.spec_decode import ModelDrafter

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _normal(shape, seed, dev, dtype=torch.float32):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randn(shape, generator=g).to(dev, dtype)


def _bf16_close(a, b, atol=0.0):
    """Within one bf16 ulp (8 significant bits) of the larger of the
    two, elementwise, plus `atol`."""
    a, b = a.float(), b.float()
    _, exp = torch.frexp(torch.maximum(a.abs(), b.abs()))
    ulp = torch.ldexp(torch.ones_like(a), exp - 8)
    assert bool(((a - b).abs() <= ulp + atol).all()), \
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


def _f16_ulp(x):
    """One fp16 ulp at each element of x (11 significant bits; 2^-24 in
    the subnormal range, below 2^-14)."""
    _, exp = torch.frexp(x)
    return torch.maximum(torch.ldexp(torch.ones_like(x), exp - 11),
                         torch.full_like(x, 2.0 ** -24))


def _f16_close(a, b, atol=0.0):
    """Within one fp16 ulp of the larger of the two, elementwise, plus
    `atol` (outputs the kernels and the plain versions each round once
    to fp16 from fp32 values that differ by fp32 rounding)."""
    a, b = a.float(), b.float()
    ulp = _f16_ulp(torch.maximum(a.abs(), b.abs()))
    assert bool(((a - b).abs() <= ulp + atol).all()), \
        f"max diff {(a - b).abs().max().item()}"


def _rounded_once_to_f16(out, ref_f32, atol=1e-5):
    """`out` (fp16) is `ref_f32` rounded to nearest: within half an fp16
    ulp of the larger of the two, plus `atol`."""
    a = out.float()
    half_ulp = _f16_ulp(torch.maximum(a.abs(), ref_f32.abs())) / 2
    err = (a - ref_f32).abs()
    assert bool((err <= half_ulp + atol).all()), \
        f"max diff {err.max().item()}, worst excess " \
        f"{(err - half_ulp).max().item()}"


def _f16_p_atol(v):
    """What rounding P to fp16 for the P V product adds to o: each p_j
    (<= 1, the running max's row gives 1) carries at most 2^-11 of
    itself, or 2^-25 absolute below fp16's normal range (2^-14), and
    o = sum p_j v_j / l with l >= 1; over at most 2,048 keys that is
    (2^-11 + 2^-14) max|v|, held here to 2^-10 max|v| + 1e-5 for fp32
    summation order."""
    return 1e-5 + 2.0 ** -10 * float(v.abs().max())


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


def _offset_copy(t):
    """The values of t in a view one element past a 16-byte boundary:
    the kernels' scalar arm takes it."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("inner", [13, 1000, 8192, 14336])
def test_swiglu_fwd_arms_match_plain(dev, dtype, inner):
    """The strided halves of a [tokens, 2, inner] buffer against the
    plain version; the same values one element off a 16-byte boundary
    (the scalar arm) give the same bits as the vector arm."""
    gu = _normal((37, 2, inner), 21, dev, dtype)
    before = tswiglu.launches
    out = tswiglu.fused_swiglu(gu)
    assert tswiglu.launches == before + 1
    _close(out, tswiglu.swiglu_plain(gu[:, 0], gu[:, 1]))
    assert torch.equal(tswiglu.fused_swiglu(_offset_copy(gu)), out)


def _fused_qkv(dev, dtype, rows, hd, seed, n_kv=2, group=4):
    """A fused projection [b, s, n_kv, group+2, hd] (b * s = rows), its
    q (grouped) and k views, and RoPE rows at seeded positions."""
    b = 2 if rows % 2 == 0 else 1
    s = rows // b
    qkv = _normal((b, s, n_kv, group + 2, hd), seed, dev, dtype)
    cos, sin = build_rope_cache(512, hd, 500000.0, device=dev)
    pos = torch.randint(0, 512, (b, s), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(
                            seed))
    return (qkv, qkv[..., :group, :], qkv[..., group, :],
            cos[pos].contiguous(), sin[pos].contiguous())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [1, 37, 300])
@pytest.mark.parametrize("hd", [36, 64, 96, 128, 256])
def test_rotary_on_fused_qkv_views_matches_plain(dev, dtype, rows, hd):
    """Forward and backward read q and k in place from the fused
    projection's slices; the plain version rotates contiguous copies.
    The backward's cotangents are such views too."""
    _, q, k, cos_t, sin_t = _fused_qkv(dev, dtype, rows, hd, 22)
    b, s = q.shape[:2]
    q4, k4 = q.reshape(b, s, -1, hd).contiguous(), k.contiguous()
    before = trotary.launches, trotary.bwd_launches
    tq, tk = trotary.fused_rotary_qk(q, k, cos_t, sin_t)
    gq, gk = trotary.rotary_qk_bwd(q, k, cos_t, sin_t)
    assert (trotary.launches, trotary.bwd_launches) == (before[0] + 1,
                                                         before[1] + 1)
    assert tq.shape == q4.shape and tq.is_contiguous() and gq.is_contiguous()
    for out, ref in zip((tq, tk), trotary.rotary_qk_plain(q4, k4, cos_t,
                                                          sin_t)):
        _close(out, ref)
    for out, ref in zip((gq, gk), trotary.rotary_qk_plain(q4, k4, cos_t,
                                                          -sin_t)):
        _close(out, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128])
def test_rotary_vector_and_scalar_arms_same_bits(dev, dtype, hd):
    """The same values one element off a 16-byte boundary (the scalar
    arm) rotate to the same bits as the aligned views (the vector
    arm)."""
    qkv, q, k, cos_t, sin_t = _fused_qkv(dev, dtype, 300, hd, 23)
    off = _offset_copy(qkv)
    ref = trotary.fused_rotary_qk(q, k, cos_t, sin_t)
    out = trotary.fused_rotary_qk(off[..., :4, :], off[..., 4, :], cos_t,
                                  sin_t)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))


def test_rotary_autograd_through_views_matches_contiguous(dev):
    """The gradient of qkv through the strided `fused_rotary_qk` (dq
    returned in the grouped view's shape, scattered by autograd) equals
    the gradient through contiguous copies of q and k."""
    qkv, *_, cos_t, sin_t = _fused_qkv(dev, torch.float32, 37, 128, 24)
    b, s = qkv.shape[:2]
    dq = _normal((b, s, 8, 128), 25, dev)
    dk = _normal((b, s, 2, 128), 26, dev)
    grads = []
    for copy in (False, True):
        x = qkv.detach().clone().requires_grad_(True)
        q, k = x[..., :4, :], x[..., 4, :]
        if copy:
            q, k = q.reshape(b, s, 8, 128), k.contiguous()
        torch.autograd.backward(
            trotary.fused_rotary_qk(q, k, cos_t, sin_t), (dq, dk))
        grads.append(x.grad)
    assert torch.equal(*grads)


def test_rotary_rejects_a_strided_head_dim(dev):
    """A head dim without unit stride raises; nothing is copied in
    silence and nothing launches."""
    qkv, q, k, cos_t, sin_t = _fused_qkv(dev, torch.float32, 8, 128, 27)
    wide = torch.stack([k, k], dim=-1).flatten(-2)[..., ::2]  # stride 2
    before = trotary.launches
    with pytest.raises(ValueError, match="unit stride"):
        trotary.fused_rotary_qk(q, wide, cos_t, sin_t)
    assert trotary.launches == before


def test_llama_heads_launch_only_the_rotary_kernel(dev):
    """`LlamaAttention.heads` reads q and k from the fused projection in
    place: the profiler sees one kernel on the card, the rotary, and no
    copy."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from hetu_tpu_torch.ops.rotary import rope_tables
    cfg = LlamaConfig.tiny(hidden_size=1024, num_attention_heads=8,
                           num_key_value_heads=2,
                           compute_dtype=torch.bfloat16)
    attn = LlamaLMHeadModel(cfg, device=dev, seed=0).model.layers[0].attn
    qkv = _normal((2, 37, 2, 6, 128), 28, dev, torch.bfloat16)
    cos, sin = build_rope_cache(64, 128, 500000.0, device=dev)
    cos_t, sin_t = rope_tables(cos, sin, 2, 37)
    torch.cuda.synchronize()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CUDA]) as prof:
        q, k, v = attn.heads(qkv, cos_t, sin_t)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    assert len(names) == 1 and "rotary_qk_kernel" in names[0], names
    assert q.shape == (2, 37, 8, 128) and v.data_ptr() != q.data_ptr()


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
@pytest.mark.parametrize("hidden", [64, 1000, 1280, 4096])
@pytest.mark.parametrize("bias", [True, False])
def test_fused_layernorm_matches_plain(dev, dtype, hidden, bias):
    """The LayerNorm arm, forward y/s and backward dx/dw/db, with a bias
    and scale-only (no db), at GPT-2-large's 1280 (5 of 8 register
    slots hold data), a ragged 1000 and the narrowest and a wide row;
    dw and db are the same bits on a second run.  bf16 outputs within
    one ulp + 1e-6, as chip_smoke.py holds them: the centred s - mean
    and dx's g - mean(g) - ... cancel, so an output near 0 carries fp32
    rounding (the row sums in another order) far above its own ulp."""
    x = _normal((3, 11, hidden), 21, dev, dtype)
    h = _normal((3, 11, hidden), 22, dev, dtype)
    w = 1.0 + 0.1 * _normal((hidden,), 23, dev)
    b = 0.1 * _normal((hidden,), 24, dev) if bias else None
    dy = _normal((3, 11, hidden), 25, dev, dtype)
    dr = _normal((3, 11, hidden), 26, dev, dtype)
    before = tfused_norm.ln_launches, tfused_norm.ln_bwd_launches
    y, s = tfused_norm.residual_layernorm_fwd(x, h, w, b)
    dx, dw, db = tfused_norm.residual_layernorm_bwd(s, w, dy, dr,
                                                    has_bias=bias)
    assert (tfused_norm.ln_launches, tfused_norm.ln_bwd_launches) == (
        before[0] + 1, before[1] + 1)
    ry, rs = tfused_norm.residual_layernorm_plain(x, h, w, b, 1e-5)
    rdx, rdw, rdb = tfused_norm.residual_layernorm_bwd_plain(
        s, w, dy, dr, 1e-5, bias)
    assert (db is None) == (rdb is None) == (not bias)
    for a, ref in ((dw, rdw), (db, rdb)):
        if ref is not None:
            assert a.dtype == torch.float32
            torch.testing.assert_close(a, ref, rtol=1e-5,
                                       atol=1e-5 * float(ref.abs().max()))
    for a, ref in ((y, ry), (s, rs), (dx, rdx)):
        if dtype == torch.float32:
            _close(a, ref)
        else:
            _bf16_close(a, ref, atol=1e-6)
    _, dw2, db2 = tfused_norm.residual_layernorm_bwd(s, w, dy, dr,
                                                     has_bias=bias)
    assert torch.equal(dw, dw2) and (db2 is None or torch.equal(db, db2))


def _norm_inputs(dev, dtype, rows, hidden, seed, bias=True):
    """x, h, dy, dr [rows, hidden] of `dtype`; w, b fp32."""
    x, h, dy, dr = (_normal((rows, hidden), seed + i, dev, dtype)
                    for i in range(4))
    w = 1.0 + 0.1 * _normal((hidden,), seed + 4, dev)
    b = 0.1 * _normal((hidden,), seed + 5, dev) if bias else None
    return x, h, dy, dr, w, b


def _norm_run(kind, x, h, dy, dr, w, b):
    """(y, s, dx, dw[, db]) of the RMS ("rms") or LayerNorm ("ln")
    kernels, the backward from the kernel's own s."""
    if kind == "rms":
        y, s = tfused_norm.residual_rmsnorm_fwd(x, h, w)
        return (y, s) + tuple(tfused_norm.residual_rmsnorm_bwd(s, w, dy,
                                                                dr))
    y, s = tfused_norm.residual_layernorm_fwd(x, h, w, b)
    grads = tfused_norm.residual_layernorm_bwd(s, w, dy, dr,
                                               has_bias=b is not None)
    return (y, s) + tuple(g for g in grads if g is not None)


def _norm_plain(kind, x, h, dy, dr, w, b, s):
    """The plain versions of `_norm_run`, the backward from `s`."""
    if kind == "rms":
        return (tfused_norm.residual_rmsnorm_plain(x, h, w, 1e-5)
                + tfused_norm.residual_rmsnorm_bwd_plain(s, w, dy, dr,
                                                         1e-5))
    grads = tfused_norm.residual_layernorm_bwd_plain(s, w, dy, dr, 1e-5,
                                                     b is not None)
    return (tfused_norm.residual_layernorm_plain(x, h, w, b, 1e-5)
            + tuple(g for g in grads if g is not None))


def _norm_matches_plain(kind, x, h, dy, dr, w, b):
    """The kernels against their plain versions at chip_smoke.py's
    tolerances: y, s and dx one bf16 ulp + 1e-6 (dx cancels) or 1e-5
    relative + 1e-5 in fp32; dw and db 1e-5 of their largest entry (sums
    over the rows in another order).  dw and db are the same bits on a
    second run.  Returns the kernels' outputs."""
    out = _norm_run(kind, x, h, dy, dr, w, b)
    ref = _norm_plain(kind, x, h, dy, dr, w, b, out[1])
    for a, r in zip(out[:3], ref[:3]):
        if a.dtype == torch.float32:
            torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-5)
        else:
            _bf16_close(a, r, atol=1e-6)
    for a, r in zip(out[3:], ref[3:]):
        assert a.dtype == torch.float32
        torch.testing.assert_close(a, r, rtol=1e-5,
                                   atol=1e-5 * float(r.abs().max()))
    again = _norm_run(kind, x, h, dy, dr, w, b)
    for a, r in zip(out[3:], again[3:]):
        assert torch.equal(a, r)
    return out


def _off16(t):
    """`t`'s values in a buffer one element past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    return buf[1:].view(t.shape).copy_(t)


@pytest.mark.parametrize("kind", ["rms", "ln"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hidden", [1280, 4096])
def test_fused_norm_scalar_arm_same_bits_as_vector_arm(dev, kind, dtype,
                                                       hidden):
    """The same values one element off a 16-byte boundary (x, h, dy, dr
    and the s fed to the backward) take the scalar arm, and all four
    kernels give the vector arm's bits: the same chunks a thread, the
    same instructions, the same order of every sum."""
    x, h, dy, dr, w, b = _norm_inputs(dev, dtype, 37, hidden, 40)
    vec = _norm_matches_plain(kind, x, h, dy, dr, w, b)
    xo, ho, dyo, dro = (_off16(t) for t in (x, h, dy, dr))
    assert tfused_norm.launch_plan(hidden, dtype, 37, (xo.data_ptr(),),
                                   backward=False, sms=132).scalar
    sca = _norm_run(kind, xo, ho, dyo, dro, w, b)
    for a, r in zip(sca, vec):
        assert torch.equal(a, r)
    # the backward from an offset s as well
    so = _off16(vec[1])
    if kind == "rms":
        bwd = tfused_norm.residual_rmsnorm_bwd(so, w, dyo, dro)
    else:
        bwd = tfused_norm.residual_layernorm_bwd(so, w, dyo, dro)
    for a, r in zip(bwd, vec[2:]):
        assert torch.equal(a, r)


@pytest.mark.parametrize("kind", ["rms", "ln"])
@pytest.mark.parametrize("dtype,hidden", [(torch.bfloat16, 1004),
                                          (torch.float32, 1002)])
def test_fused_norm_scalar_widths_match_plain(dev, kind, dtype, hidden):
    """Widths that are no whole number of 16-byte chunks run the scalar
    arm (the last chunk part-masked), against the plain version."""
    x, h, dy, dr, w, b = _norm_inputs(dev, dtype, 33, hidden, 50)
    assert tfused_norm.launch_plan(hidden, dtype, 33, (x.data_ptr(),),
                                   backward=True, sms=132).scalar
    _norm_matches_plain(kind, x, h, dy, dr, w, b)


@pytest.mark.parametrize("kind", ["rms", "ln"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hidden", [64, 1280])
@pytest.mark.parametrize("rows", [1, 7, 8193])
def test_fused_norm_row_counts_match_plain(dev, kind, dtype, hidden, rows):
    """Row counts below, inside and past the plan's rows a block (64:
    8 rows of a warp a block) and the backward's one wave (8,193 rows:
    every block takes several row groups, the last one partial)."""
    x, h, dy, dr, w, b = _norm_inputs(dev, dtype, rows, hidden, 60)
    _norm_matches_plain(kind, x, h, dy, dr, w, b)


@pytest.mark.parametrize("kind,bias", [("rms", False), ("ln", True),
                                       ("ln", False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_norm_max_hidden_matches_plain(dev, kind, bias, dtype):
    """hidden MAX_HIDDEN (8,192): 512 threads a row, the widest
    instantiation; the LayerNorm arm with a bias and scale-only."""
    x, h, dy, dr, w, b = _norm_inputs(dev, dtype, 19,
                                      tfused_norm.MAX_HIDDEN, 70, bias)
    _norm_matches_plain(kind, x, h, dy, dr, w, b)


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



def _adam_leaf(n, seed, dev, dtype, off):
    """A leaf of n elements `off` elements into its buffer (off a 16-byte
    boundary where off % 4 != 0)."""
    buf = torch.empty(n + off, dtype=dtype, device=dev)[off:]
    return buf.copy_(_normal((n,), seed, dev, dtype))


@pytest.mark.parametrize("many", [False, True])
def test_adam_update_multi_matches_plain(dev, many):
    """Two in-place steps over a mixed list in one call a step: fp32 and
    bf16 leaves (one launch each), lengths no multiple of 4 (the scalar
    tail), leaves off a 16-byte boundary (the scalar path), leaves of
    several chunks and an empty one; `many`: 1,100 small leaves, more than
    a table holds (three fp32 launches a step)."""
    if many:
        spec = [(1 + i % 37, torch.float32, 0) for i in range(1100)]
    else:
        C = tadam.CHUNK
        spec = [(3 * C + 5, torch.float32, 0), (1001, torch.float32, 1),
                (C, torch.bfloat16, 0), (4097, torch.bfloat16, 2),
                (0, torch.float32, 0), (4096, torch.float32, 3),
                (12, torch.bfloat16, 0)]
    p = [_adam_leaf(n, 30 + i, dev, dt, off) for i, (n, dt, off) in
         enumerate(spec)]
    g = [_adam_leaf(n, 40 + i, dev, torch.float32, off).mul_(0.1)
         for i, (n, _, off) in enumerate(spec)]
    m = [torch.zeros(n, device=dev) for n, _, _ in spec]
    v = [torch.zeros(n, device=dev) for n, _, _ in spec]
    ref = [[t.clone() for t in ts] for ts in (p, m, v)]
    launches = tadam.launches
    kw = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
    for step in (1, 2):
        c1 = np.float32(1) - np.float32(0.9) ** np.float32(step)
        c2 = np.float32(1) - np.float32(0.95) ** np.float32(step)
        tadam.adam_update_multi(p, g, m, v, 1e-3, c1, c2, **kw)
        for leaf in zip(ref[0], g, ref[1], ref[2]):
            tadam.adam_plain(*leaf, 1e-3, c1, c2, **kw)
    torch.cuda.synchronize()
    assert tadam.launches == launches + 2 * (3 if many else 2)
    for mine, theirs in zip((p, m, v), ref):
        for a, b in zip(mine, theirs):
            if a.dtype == torch.bfloat16:
                _bf16_close(a, b)
            else:
                torch.testing.assert_close(a, b, rtol=3e-7, atol=1e-10)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adam_skip_flag_writes_nothing(dev, dtype):
    """The AdamW launch with its device-side skip flag set leaves p, m and
    v byte for byte as they were (and still counts a launch); with the
    flag clear it writes what a launch without the flag writes, and the
    plain version takes the flag the same way."""
    n = 4097
    p0 = _normal((n,), 18, dev, dtype)
    g = 0.1 * _normal((n,), 19, dev)
    m0, v0 = 0.01 * _normal((n,), 20, dev), _normal((n,), 21, dev).abs()
    kw = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
    c1 = np.float32(1) - np.float32(0.9) ** np.float32(3)
    c2 = np.float32(1) - np.float32(0.95) ** np.float32(3)
    for flag in (1, 0):
        skip = torch.full((), flag, dtype=torch.int32, device=dev)
        mine = [t.clone() for t in (p0, m0, v0)]
        plain = [t.clone() for t in (p0, m0, v0)]
        unflagged = [t.clone() for t in (p0, m0, v0)]
        before = tadam.launches
        tadam.adam_update(mine[0], g, *mine[1:], 1e-3, c1, c2, skip=skip,
                          **kw)
        tadam.adam_plain(plain[0], g, *plain[1:], 1e-3, c1, c2, skip=skip,
                         **kw)
        tadam.adam_update(unflagged[0], g, *unflagged[1:], 1e-3, c1, c2,
                          **kw)
        torch.cuda.synchronize()
        assert tadam.launches == before + 2
        expect = (p0, m0, v0) if flag else unflagged
        for a, b in zip(mine, expect):
            assert torch.equal(a, b)
        if flag:
            for a, b in zip(plain, expect):
                assert torch.equal(a, b)


def test_dropout_bits_equal_on_the_card_and_the_cpu(dev):
    """The counter-based mask is integer arithmetic: the card and the
    CPU draw the same bits, mask and kept values for the same key
    (attention probabilities' shape and a hidden state's)."""
    from hetu_tpu_torch.ops import activations as tact
    key = tact.DropoutKey((2, 17, 1, 5, 1))
    for shape, dtype in (((2, 20, 256, 256), torch.float32),
                         ((2, 256, 1280), torch.bfloat16)):
        n = int(np.prod(shape))
        assert torch.equal(tact.dropout_bits(n, key, dev).cpu(),
                           tact.dropout_bits(n, key, "cpu"))
        x = _normal(shape, 22, "cpu", dtype)
        on_card = tact.dropout(x.to(dev), 0.1, key, deterministic=False)
        on_cpu = tact.dropout(x, 0.1, key, deterministic=False)
        assert torch.equal(on_card.cpu(), on_cpu)


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


def _flash_inputs(dev, dtype, sq, sk, hq, hkv, d, opts, b=2):
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
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
    o, lse, dq = _check_flash(dev, q, k, v, kw)
    if case in ("dead_row", "future_chunk"):
        rows = slice(64, None) if case == "dead_row" else slice(None)
        assert bool((o[:, rows] == 0).all())
        assert bool((lse[:, :, rows] == tflash.NEG_INF).all())
        assert bool((dq[:, rows] == 0).all())


def _f16_flash_launches():
    """The flash forward, dq and dk/dv kernels' fp16 launches."""
    return tuple(tflash.arm_launches[c]["f16"]
                 for c in ("launches", "dq_launches", "dkv_launches"))


def _check_flash(dev, q, k, v, kw):
    """The body of `test_flash_matches_plain`: forward and backward of
    `flash_attention(q, k, v, **kw)` against the plain versions in
    fp32, launch counts, a backward's bits twice.  Returns (o, lse, the
    gradient of q)."""
    dtype = q.dtype
    before = tflash.launches, tflash.dq_launches, tflash.dkv_launches
    f16_before = _f16_flash_launches()
    o, lse = tflash.flash_attention_with_lse(q, k, v, **kw)
    torch.cuda.synchronize()
    ro, rlse = tflash.flash_attention_with_lse(
        q.float().cpu(), k.float().cpu(), v.float().cpu(),
        **{key: t.cpu() if torch.is_tensor(t) else t
           for key, t in kw.items()}, device="cpu")
    assert o.dtype == dtype and lse.dtype == torch.float32
    assert bool(torch.isfinite(o).all())
    torch.testing.assert_close(lse.cpu(), rlse, rtol=1e-5, atol=1e-5)
    if dtype == torch.float32:
        _of_max(o.cpu(), ro)
    elif dtype == torch.float16:
        _rounded_once_to_f16(o.cpu(), ro, atol=_f16_p_atol(v))
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
    f16 = 1 if dtype == torch.float16 else 0
    assert _f16_flash_launches() == (f16_before[0] + 3 * f16,
                                         f16_before[1] + 2 * f16,
                                         f16_before[2] + 2 * f16)
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
        elif dtype == torch.float16:    # the bf16 bound, 3 bits finer
            _of_max(mine.cpu(), r.grad, rtol=2.0 ** -10)
        else:   # rounded once to bf16 by the Function (half an ulp),
            # and delta was taken from the o the kernel rounded
            _of_max(mine.cpu(), r.grad, rtol=2.0 ** -7)
    return o, lse, grads[0][0]


# q block 0 sees k blocks 0 and 8 only: seven tiles that stream for the
# other warpgroups of its block and not for its own
_GAP = ((True,) + (False,) * 7 + (True,), (True,) * 9, (True,) * 9)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("case", ["ragged_tiles", "odd_tiles", "segments",
                                  "draft", "causal_block_512",
                                  "gap_of_7_blocks"])
def test_flash_bf16_block_shapes_match_plain(dev, d, case):
    """The bf16 Hopper kernels at shapes that decide their blocks, held
    as `test_flash_matches_plain` holds its cases: wide enough (b x hq
    blocks) that a block runs three (forward) or two (dk/dv) 64-row
    warpgroups, with sq not a multiple of 128 — 192 = blocks of 96
    (tiles of 64 + 32: ragged tiles inside a block; 4 q tiles, so the
    forward's second block holds one) and blocks of 64 (3 tiles: dk/dv's
    last block has one warpgroup without a tile) — and segments; the
    serving3 draft's q [1, 256, 32, 64] over 8 kv heads, which runs one
    warpgroup a block (fewer blocks of more would leave SMs idle); and
    two where more tiles than the ring has slots stream past a
    warpgroup after the last one it computed, so it must hand back the
    slot it still holds: causal blocks of 512 (8 tiles of one k block
    that only the block's third warpgroup computes, and 7 empty ones
    after a first q tile's only tile) and a block mask whose first row
    skips 7 k blocks that its neighbours see."""
    b, sq, sk, hq, hkv, bq, opts = {
        "ragged_tiles": (2, 192, 192, 72, 36, 128, {}),
        "odd_tiles": (2, 192, 192, 72, 36, 64, {}),
        "segments": (2, 256, 256, 72, 36, 128, {"segments": True}),
        "draft": (1, 256, 256, 32, 8, 128, {}),
        "causal_block_512": (2, 1024, 1024, 16, 4, 512, {}),
        "gap_of_7_blocks": (2, 192, 576, 72, 36, 64,
                            {"causal": False, "block_mask": _GAP}),
    }[case]
    q, k, v, kw = _flash_inputs(dev, torch.bfloat16, sq, sk, hq, hkv, d,
                                opts, b=b)
    kw.update(block_q=bq, block_k=bq)
    _check_flash(dev, q, k, v, kw)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("case", ["segments", "packed", "causal_block_512",
                                  "gap_of_7_blocks"])
def test_flash_f16_block_shapes_match_plain(dev, d, case):
    """The fp16 arm of the Hopper kernels (the bf16 kernels' template
    over `__half`) at the block shapes of
    `test_flash_bf16_block_shapes_match_plain` that decide their tile
    classes and ring: segments cut inside a 64-row tile, a packed row
    of five sequences (`_packed_segments`: boundaries inside tiles and
    on them, a pad tail of segment 0), causal blocks of 512 and the
    block mask with a gap of 7."""
    b, sq, sk, hq, hkv, bq, opts = {
        "segments": (2, 256, 256, 72, 36, 128, {"segments": True}),
        "packed": (2, 512, 512, 32, 8, 128, {}),
        "causal_block_512": (2, 1024, 1024, 16, 4, 512, {}),
        "gap_of_7_blocks": (2, 192, 576, 72, 36, 64,
                            {"causal": False, "block_mask": _GAP}),
    }[case]
    q, k, v, kw = _flash_inputs(dev, torch.float16, sq, sk, hq, hkv, d,
                                opts, b=b)
    if case == "packed":
        kw["segment_ids"] = _packed_segments(b, sq, dev)
    kw.update(block_q=bq, block_k=bq)
    _check_flash(dev, q, k, v, kw)


def _packed_segments(b, s, dev):
    """[b, s] int32 segment ids of packed rows: sequences of uneven
    lengths (1-indexed, some ending inside a 64-row tile, one on a tile
    edge), then padding (segment 0), different in each row."""
    rows = []
    for r in range(b):
        lengths = [64 + 37 * r, 1, 130 - r, 64, 100]
        ids = np.zeros(s, np.int32)
        at = 0
        for j, n in enumerate(lengths):
            ids[at:at + n] = j + 1
            at += n
        rows.append(ids)
    return torch.from_numpy(np.stack(rows)).to(dev)


def test_flash_block_of_two_skips_a_tile_dead_for_one_warpgroup(dev):
    """A block of 64-row warpgroups whose API blocks differ in
    liveness.  Forward: NaN in the keys and values of k block 1, live
    for q block 0 and dead for q block 1 (and k block 3 dead for both):
    the ring loads it for the first warpgroup, the second passes over
    it, and q block 1's o and lse equal the plain version's on the same
    values with the NaN block zeroed.  dk/dv: NaN in the queries and
    output gradients of q block 0, live for k block 0 and dead for k
    block 1: k block 1's dk and dv equal the plain version's likewise."""
    b, sq, sk, hq, hkv, d = 2, 128, 256, 72, 36, 64
    q, k, v, _ = _flash_inputs(dev, torch.bfloat16, sq, sk, hq, hkv, d, {},
                               b=b)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))      # [b, h, s, d]
    q_pos = torch.arange(sq, dtype=torch.int32, device=dev).expand(b, sq)
    k_pos = torch.arange(sk, dtype=torch.int32, device=dev).expand(b, sk)
    kw = dict(scale=d ** -0.5, causal=False, block_q=64, block_k=64)
    # the forward's block holds both q tiles (three warpgroups, the third
    # without a tile), dk/dv's two k tiles a block
    fwd_mask = ((True, True, True, False), (True, False, True, False))
    bad_k, bad_v = k.clone(), v.clone()
    bad_k[:, :, 64:128], bad_v[:, :, 64:128] = float("nan"), float("nan")
    o, lse = tflash._fwd(q, bad_k, bad_v, q_pos, k_pos, None, None,
                         block_mask=fwd_mask, **kw)
    zk, zv = (torch.nan_to_num(t.float(), nan=0.0).cpu()
              for t in (bad_k, bad_v))
    ro, rlse = tflash.flash_fwd_plain(
        q.float().cpu(), zk, zv, q_pos.cpu(), k_pos.cpu(), None, None,
        live=tflash._mask_tensor(fwd_mask, torch.device("cpu")), **kw)
    assert bool(torch.isnan(o[:, :, :64]).any())          # it was loaded
    assert bool(torch.isfinite(o[:, :, 64:]).all())
    torch.testing.assert_close(lse[:, :, 64:].cpu(), rlse[:, :, 64:],
                               rtol=1e-5, atol=1e-5)
    _rounded_once_to_bf16(o[:, :, 64:].cpu(), ro[:, :, 64:],
                          atol=1e-5 + 2.0 ** -9 * float(v.abs().max()))

    bwd_mask = ((True, False, True, True), (True, True, True, True))
    do = _normal(q.shape, 24, dev, torch.bfloat16)
    lse = tflash._fwd(q, k, v, q_pos, k_pos, None, None, block_mask=bwd_mask,
                      **kw)[1]
    delta = _normal(lse.shape, 25, dev)
    bad_q, bad_do = q.clone(), do.clone()
    bad_q[:, :, :64], bad_do[:, :, :64] = float("nan"), float("nan")
    dk, dv = tflash.flash_bwd_dkv(bad_q, k, v, lse, bad_do, delta, q_pos,
                                  k_pos, None, None, block_mask=bwd_mask,
                                  **kw)
    zq, zdo = (torch.nan_to_num(t.float(), nan=0.0).cpu()
               for t in (bad_q, bad_do))
    _, rdk, rdv = tflash.flash_bwd_plain(
        zq, k.float().cpu(), v.float().cpu(), lse.cpu(), zdo, delta.cpu(),
        q_pos.cpu(), k_pos.cpu(), None, None,
        live=tflash._mask_tensor(bwd_mask, torch.device("cpu")), **kw)
    assert bool(torch.isnan(dk[:, :, :64]).any())
    for mine, ref in ((dk, rdk), (dv, rdv)):
        assert bool(torch.isfinite(mine[:, :, 64:128]).all())
        _of_max(mine[:, :, 64:128].cpu(), ref[:, :, 64:128], rtol=2.0 ** -8)



@pytest.mark.parametrize("d", [64, 128])
def test_flash_dq_block_of_two_skips_a_tile_dead_for_one_warpgroup(dev, d):
    """dq's blocks hold two 64-row q warpgroups: NaN in the keys and
    values of k block 1, live for q block 0 and dead for q block 1 (k
    block 3 dead for both): the ring loads it for the first warpgroup,
    the second passes over it, and q block 1's dq equals the plain
    version's on the same values with the NaN block zeroed; q block 0's
    takes the NaN (the tile was computed there)."""
    b, sq, sk, hq, hkv = 2, 128, 256, 72, 36
    q, k, v, _ = _flash_inputs(dev, torch.bfloat16, sq, sk, hq, hkv, d, {},
                               b=b)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))      # [b, h, s, d]
    q_pos = torch.arange(sq, dtype=torch.int32, device=dev).expand(b, sq)
    k_pos = torch.arange(sk, dtype=torch.int32, device=dev).expand(b, sk)
    kw = dict(scale=d ** -0.5, causal=False, block_q=64, block_k=64)
    mask = ((True, True, True, False), (True, False, True, False))
    lse = tflash._fwd(q, k, v, q_pos, k_pos, None, None, block_mask=mask,
                      **kw)[1]
    do = _normal(q.shape, 24, dev, torch.bfloat16)
    delta = _normal(lse.shape, 25, dev)
    bad_k, bad_v = k.clone(), v.clone()
    bad_k[:, :, 64:128], bad_v[:, :, 64:128] = float("nan"), float("nan")
    before = tflash.dq_launches
    dq = tflash.flash_bwd_dq(q, bad_k, bad_v, lse, do, delta, q_pos, k_pos,
                             None, None, block_mask=mask, **kw)
    torch.cuda.synchronize()
    assert tflash.dq_launches == before + 1
    zk, zv = (torch.nan_to_num(t.float(), nan=0.0).cpu()
              for t in (bad_k, bad_v))
    rdq = tflash.flash_bwd_plain(
        q.float().cpu(), zk, zv, lse.cpu(), do.float().cpu(), delta.cpu(),
        q_pos.cpu(), k_pos.cpu(), None, None,
        live=tflash._mask_tensor(mask, torch.device("cpu")), **kw)[0]
    assert bool(torch.isnan(dq[:, :, :64]).any())         # it was loaded
    assert bool(torch.isfinite(dq[:, :, 64:]).all())
    _of_max(dq[:, :, 64:].cpu(), rdq[:, :, 64:], rtol=2.0 ** -8)


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
    dtype = torch.float64 if fault == "dtype" else torch.bfloat16
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
                "rotary": (fwd, bwd), "adam": (1, 0),
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


def _nan_pools(dev, quant, dtype, shape):
    """Pools [..., P, ps, n_kv, hd] holding what no write may leave
    behind: NaN exact values, or payload bytes 0x5a under NaN scales."""
    if quant == "none":
        k = torch.full(shape, float("nan"), dtype=dtype, device=dev)
        return [k, k.clone(), None, None]
    hd_p = shape[-1] // 2 if quant == "int4" else shape[-1]
    pay = torch.full((*shape[:-1], hd_p), 0x5a, device=dev,
                     dtype=torch.uint8 if quant == "int4" else torch.int8)
    sc = torch.full(shape[:-1], float("nan"), device=dev)
    return [pay, pay.clone(), sc, sc.clone()]


def _same_bytes(a, b):
    """Equal bit for bit, NaN payloads included."""
    return torch.equal(a.contiguous().view(torch.uint8),
                       b.contiguous().view(torch.uint8))


def _served_kv(dev, dtype, S, C, n_kv, hd, layout, seed):
    """K and V [S, C, n_kv, hd] as the serving forwards hand them over:
    LLaMA's K out of RoPE (contiguous) and V a view of the fused
    projection [S, C, n_kv, 2 + 2, hd]; GPT's K and V views of [S, C,
    n_kv, 3, hd].  The projection's q columns then hold NaN: a write
    that read them would carry NaN into the pages."""
    if layout == "llama":
        qkv = _normal((S, C, n_kv, 4, hd), seed, dev, dtype)
        cos_t = _normal((S, C, hd // 2), seed + 1, dev)
        sin_t = _normal((S, C, hd // 2), seed + 2, dev)
        _, k = trotary.fused_rotary_qk(qkv[..., :2, :], qkv[..., 2, :],
                                       cos_t, sin_t)
        v = qkv[..., 3, :]
        qkv[..., :2, :] = float("nan")
    else:
        qkv = _normal((S, C, n_kv, 3, hd), seed, dev, dtype)
        k, v = qkv[..., 1, :], qkv[..., 2, :]
        qkv[..., 0, :] = float("nan")
    return k, v


# slots at depths in their first, second and last page (the last one's
# verify block runs past its 3-page row into the null page), and a row
# that is not decoding (zeroed, at position 0)
_KV_TABLE = [[1, 2, 3], [4, 5, 0], [6, 7, 8], [0, 0, 0]]
_KV_POSITIONS = [20, 3, 46, 0]


@pytest.mark.parametrize("quant", ["none", "int8", "int4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("C", [1, 5])
@pytest.mark.parametrize("layout", ["llama", "gpt"])
def test_write_kv_tokens_matches_plain(dev, quant, dtype, hd, C, layout):
    S, n_kv, ps, P = 4, 2, 16, 9
    table = torch.tensor(_KV_TABLE, dtype=torch.int32, device=dev)
    pos = torch.tensor(_KV_POSITIONS, dtype=torch.int32, device=dev)
    k, v = _served_kv(dev, dtype, S, C, n_kv, hd, layout, 40 + C)
    # GPT's exact pages here in the other type: the cast, rounded once
    other = torch.bfloat16 if dtype == torch.float32 else torch.float32
    out = _nan_pools(dev, quant, dtype if layout == "llama" else other,
                     (P, ps, n_kv, hd))
    ref = [None if t is None else t.clone() for t in out]
    before = tkv_write.launches
    tkv_write.write_kv_tokens(out[0], out[1], table, pos, k, v,
                              k_scale=out[2], v_scale=out[3], quant=quant)
    torch.cuda.synchronize()
    assert tkv_write.launches == before + 1
    tkv_write.write_kv_tokens_plain(ref[0], ref[1], table, pos, k, v,
                                    ref[2], ref[3], quant)
    for a, b in zip(out, ref):
        if a is not None:
            assert _same_bytes(a[1:], b[1:])        # every real page
    # each live slot's C tokens (slot 2: two, then past its row) went to
    # their slots and nowhere else; the null page took the rest (the
    # inactive row's block, and the overflow: its slots 0..C-1)
    probe = out[2] if quant != "none" else out[0]
    done = torch.isfinite(probe.float().reshape(P, ps, -1)).all(-1)
    assert int(done[1:].sum()) == 2 * C + min(C, 2)
    assert bool(done[0, :C].all()) and not bool(done[0, C:].any())


def _kv_pages_case(dev, quant, dtype, hd, L=3, n_kv=2, ps=16, P=10):
    row = torch.tensor([0, 0, 7, 2, 9, 0], dtype=torch.int32, device=dev)
    M = row.shape[0] * ps
    scratch = [_normal((L, 1, M, n_kv, hd), 50 + i, dev, dtype)
               for i in range(2)]
    return row, scratch[0][:, 0], scratch[1][:, 0], _nan_pools(
        dev, quant, dtype, (L, P, ps, n_kv, hd))


@pytest.mark.parametrize("quant", ["none", "int8", "int4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128])
def test_write_kv_pages_matches_plain(dev, quant, dtype, hd):
    """The prefill's scratch (views of the dense cache) into a row with
    shared (null) pages ahead and an unused tail: the real pages bit for
    bit, every other page (page 0 too) still NaN."""
    row, ks, vs, out = _kv_pages_case(dev, quant, dtype, hd)
    ref = [None if t is None else t.clone() for t in out]
    before = tkv_write.pages_launches
    tkv_write.write_kv_pages(out[0], out[1], row, ks, vs, k_scale=out[2],
                             v_scale=out[3], quant=quant)
    torch.cuda.synchronize()
    assert tkv_write.pages_launches == before + 1
    tkv_write.write_kv_pages_plain(ref[0], ref[1], row, ks, vs, ref[2],
                                   ref[3], quant)
    for a, b in zip(out, ref):
        if a is not None:
            assert _same_bytes(a, b)
    untouched = [p for p in range(out[0].shape[1]) if p not in (7, 2, 9)]
    probe = out[2] if quant != "none" else out[0]
    assert bool(torch.isnan(probe[:, untouched].float()).all())
    assert bool(torch.isfinite(probe[:, [7, 2, 9]].float()).all())


def test_write_kv_refuses_what_the_kernel_does_not_take(dev):
    """fp16, head dims off the 16-byte grid or past 256, and K or V off a
    16-byte boundary raise before a launch."""
    table = torch.tensor(_KV_TABLE, dtype=torch.int32, device=dev)
    pos = torch.tensor(_KV_POSITIONS, dtype=torch.int32, device=dev)
    before = tkv_write.launches
    for dtype, hd, off in ((torch.float16, 64, 0), (torch.bfloat16, 36, 0),
                           (torch.float32, 512, 0), (torch.float32, 64, 1)):
        pools = _nan_pools(dev, "int8", torch.float32, (9, 16, 2, hd))
        flat = torch.zeros(4 * 2 * hd + off, dtype=dtype, device=dev)
        k = flat[off:].view(4, 1, 2, hd)
        with pytest.raises(ValueError):
            tkv_write.write_kv_tokens(pools[0], pools[1], table, pos, k, k,
                                      k_scale=pools[2], v_scale=pools[3])
    assert tkv_write.launches == before


@pytest.mark.parametrize("quant", ["none", "int8", "int4"])
def test_paged_forwards_write_one_launch_a_layer(dev, quant):
    """A decode and a verify step write their pages with one
    `write_kv_tokens` launch a layer, a prefill's page write is one
    `write_kv_pages` launch, and none launches the quantize."""
    from hetu_tpu_torch.models.generation import (decode_step_paged,
                                                  verify_step_paged)
    from hetu_tpu_torch.serving.kv_pool import PagePool
    cfg = LlamaConfig.tiny(hidden_size=256, num_attention_heads=4,
                           num_key_value_heads=2, intermediate_size=512,
                           compute_dtype=torch.float32)
    L = cfg.num_hidden_layers
    model = LlamaLMHeadModel(cfg, device=dev, seed=0)
    pool = PagePool(num_layers=L, num_pages=4, page_size=8, num_kv_heads=2,
                    head_dim=64, quant=quant, device=dev)
    kw = {} if quant == "none" else dict(
        k_scale=pool.k_scale, v_scale=pool.v_scale, kv_quant=quant)
    table = torch.tensor([[1, 2], [3, 0], [0, 0]], dtype=torch.int32,
                         device=dev)
    pos = np.array([9, 4, 0], np.int32)
    tok = torch.tensor([[5, 6, 7], [8, 9, 10], [0, 0, 0]], device=dev)
    counts = lambda: (tkv_write.launches, tkv_write.pages_launches,  # noqa
                      tquant.launches)
    before = counts()
    decode_step_paged(model, tok[:, 0], pool.k, pool.v, table, pos, **kw)
    verify_step_paged(model, tok, pool.k, pool.v, table, pos + 1, **kw)
    scratch = _normal((L, 1, 16, 2, 64), 60, dev)
    pool.write_pages(np.array([4, 0], np.int32), scratch[:, 0],
                     scratch[:, 0])
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(counts(), before)) == (2 * L, 1, 0)


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


@pytest.mark.parametrize("R", [8, 40, 70])
@pytest.mark.parametrize("V", [32001, 50257])
@pytest.mark.parametrize("H", [1024, 1280])
def test_fused_sample_over_a_tied_table_takes_the_k_major_arm(dev, H, V, R):
    """A tied head, the transposed view `table.t()` of a [V, H] table (as
    `lm_head_weight()` returns GPT's `wte`), at ragged V: the product on
    the tensor cores' K-major arm (counted in `lm_head_routes`) within
    1e-5 of the largest logit against the fp32 product; tokens identical
    wherever the plain top-two gap after noise exceeds 1e-3."""
    table = (0.05 * _normal((V, H), 31, dev)).bfloat16()
    head = table.t()
    hidden = _normal((R, H), 32, dev, torch.bfloat16)
    args = _sampling_rows(dev, R, V, 33)
    before = dict(tsample.lm_head_routes)
    logits = tsample.lm_head_logits(hidden, head)
    torch.cuda.synchronize()
    assert tsample.lm_head_routes["k_major"] == before["k_major"] + 1
    ref = hidden.float() @ head.float()
    assert (logits - ref).abs().max() <= 1e-5 * ref.abs().max()
    out = tsample.fused_sample(hidden, head, *args)
    torch.cuda.synchronize()
    assert tsample.lm_head_routes["k_major"] == before["k_major"] + 2
    assert tsample.lm_head_routes["fma"] == before["fma"]
    plain = tsample.fused_sample_plain(hidden, head, *args)
    clear = _noisy_gap(ref, *args) > 1e-3
    assert clear.sum() >= R - max(2, R // 12)
    assert torch.equal(out[clear], plain[clear])


def test_lm_head_routes_by_layout(dev):
    """Each head layout takes its arm and matches the fp32 product: an
    [H, V] head on the N-major arm, a padded one (row stride a multiple
    of 8, V ragged) too, a column-strided view and fp32 on the FMAs."""
    H, R = 256, 24
    hidden = _normal((R, H), 34, dev, torch.bfloat16)
    padded = (0.05 * _normal((H, 1008), 35, dev)).bfloat16()
    cases = {"n_major": [padded[:, :1000], padded[:, :1001]],
             "fma": [padded[:, ::2], padded.float()[:, :1000]]}
    for route, heads in cases.items():
        for w in heads:
            x = hidden.to(w.dtype)
            before = tsample.lm_head_routes[route]
            logits = tsample.lm_head_logits(x, w)
            torch.cuda.synchronize()
            assert tsample.lm_head_routes[route] == before + 1
            ref = x.float() @ w.float()
            assert (logits - ref).abs().max() <= 1e-5 * ref.abs().max()


def _mass_above(logits, temps, top_ks):
    """For each entry, the renormalized top-k mass of the entries with a
    strictly larger scaled value (float64): the nucleus keeps an entry
    exactly where this is below top_p."""
    x = (logits.double() / temps.double()[:, None])
    V = x.shape[-1]
    desc, order = torch.sort(x, dim=-1, descending=True)
    k = torch.where(top_ks > 0, top_ks, torch.full_like(top_ks, V)).long()
    ranks = torch.arange(V, device=x.device)[None]
    p = torch.softmax(torch.where(ranks < k[:, None], desc,
                                  torch.full_like(desc, -torch.inf)), -1)
    before = torch.cumsum(p, -1) - p
    # equal values: the mass before the first of them
    first = torch.searchsorted(-desc, -desc, side="left")
    above = torch.gather(before, 1, first)
    return torch.empty_like(above).scatter_(1, order, above)


def _nucleus_case(dev, case, dtype):
    """Rows of one edge case of the nucleus (logits [R, V] and the row
    arguments): top-p alone over Llama-3's vocabulary; a row of equal
    logits; one dominant logit; top-p 1e-6 and 0.999999; top-k whose
    k-th value is duplicated across the cut, with top-p on top; V = 13,
    where some of a row's 8 blocks hold nothing."""
    R = 8
    V = {"top_p_alone": 128256, "near_one": 128256, "v13": 13}.get(case,
                                                                    4000)
    logits = 3.0 * _normal((R, V), 41, dev)
    temps = torch.tensor([1.0, 0.7, 0.9, 1.3, 1.0, 0.8, 1.1, 0.6])
    top_ks = torch.zeros(R, dtype=torch.int32)
    top_ps = torch.tensor([0.5, 0.8, 0.9, 0.95, 0.99, 0.3, 0.7, 0.6])
    if case == "equal":
        logits[:] = 1.5
        logits[4:, 17] = 1.5 + 1e-2     # one slightly above the rest
        top_ks[2:4] = 50
    elif case == "dominant":
        logits[:, 123] = 40.0
        logits[4:, 124] = 38.0          # a second one ~ e^-2 behind
    elif case == "tiny_p":
        top_ps[:] = 1e-6
        top_ks[4:] = 20
    elif case == "near_one":
        top_ps[:] = 0.999999
        top_ks[6:] = 1000
    elif case == "dup_kth":
        top_ks[:] = torch.tensor([10, 10, 25, 25, 40, 40, 5, 5])
        srt = torch.sort(logits, dim=-1, descending=True)
        for r in range(R):              # ranks k - 3 .. k + 2 share a value
            k = int(top_ks[r])
            logits[r, srt.indices[r, k - 3:k + 3]] = srt.values[r, k - 1]
    elif case == "v13":
        top_ks[4:] = torch.tensor([3, 7, 12, 13], dtype=torch.int32)
    args = _sampling_rows(dev, R, V, 42)
    return (logits.to(dtype), args[0], temps.to(dev), top_ks.to(dev),
            top_ps.to(dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["top_p_alone", "equal", "dominant",
                                  "tiny_p", "near_one", "dup_kth", "v13"])
def test_nucleus_edge_cases_match_plain(dev, case, dtype):
    """The radix select over mass, confirmed by the bisection's predicate,
    at the nucleus's edges: tokens identical to the sort-based plain
    version, as `test_sample_logits_matches_plain` holds its rows.  A
    row is excused only where a drawn token's mass above lies within
    1e-5 of top_p: there the plain version's cumulative sum and the
    kernel's fixed-order sum (both fp32, in other orders) may round to
    opposite sides of top_p.  Excused rows are counted, at most one of
    eight; the draw gives the same bits twice."""
    logits, words, temps, top_ks, top_ps = _nucleus_case(dev, case, dtype)
    args = (words, temps, top_ks, top_ps)
    out = tsample.sample_logits(logits, *args)
    again = tsample.sample_logits(logits, *args)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    plain = tsample.sample_plain(logits, *args)
    above = _mass_above(logits.float(), temps, top_ks)
    diff = (out != plain).nonzero()[:, 0].tolist()
    for r in diff:
        near = [abs(float(above[r, int(t)]) - float(top_ps[r])) <= 1e-5
                for t in (out[r], plain[r])]
        assert any(near), f"row {r}: {int(out[r])} vs {int(plain[r])}"
    print(f"{case} {dtype}: {len(diff)} of {len(out)} rows excused "
          f"(a drawn token's mass above within 1e-5 of top_p)")
    assert len(diff) <= 1


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


# -------------------------------------------- third serving slice kernels
def _dequant_payload(dev, nb, bs, seed=0):
    x = _normal((nb, bs), seed, dev) * torch.rand(
        (nb, 1), generator=torch.Generator().manual_seed(seed)).to(dev)
    return tquant.quantize_blockwise_plain(x, bs)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bs", [32, 64, 128, 256, 24, 200])
def test_dequantize_blockwise_matches_plain(dev, bs, out_dtype):
    """Bit for bit, in both output arms (bf16: the fp32 product cast
    once), at the quantize's block sizes and at rows that end inside a
    16-byte vector (24, 200)."""
    q, s = _dequant_payload(dev, 1000 + bs % 7, bs)
    before = tquant.dequant_launches
    out = tquant.dequantize_blockwise(q, s, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert tquant.dequant_launches == before + 1
    ref = tquant.dequantize_blockwise_plain(q, s).to(out_dtype)
    assert out.dtype == out_dtype and out.shape == ref.shape
    assert torch.equal(out.view(torch.uint8), ref.view(torch.uint8))


@pytest.mark.parametrize("offset", [1, 16, 37])
def test_dequantize_blockwise_takes_a_view_at_any_offset(dev, offset):
    """A payload that is a view into a padded flat buffer, its base off
    (or on) a 16-byte boundary."""
    q, s = _dequant_payload(dev, 300, 64, seed=3)
    flat = torch.zeros(offset + q.numel() + 5, dtype=torch.int8,
                       device=dev)
    flat[offset:offset + q.numel()] = q.reshape(-1)
    view = flat[offset:offset + q.numel()].view(300, 64)
    assert view.data_ptr() % 16 == offset % 16
    for out_dtype in (torch.float32, torch.bfloat16):
        out = tquant.dequantize_blockwise(view, s, out_dtype=out_dtype)
        ref = tquant.dequantize_blockwise_plain(q, s).to(out_dtype)
        assert torch.equal(out.view(torch.uint8), ref.view(torch.uint8))


def test_dequantize_blockwise_refuses_wrong_devices_and_types(dev):
    q, s = _dequant_payload(dev, 8, 64)
    with pytest.raises(ValueError):                  # scales on the CPU
        tquant.dequantize_blockwise(q, s.cpu())
    with pytest.raises(ValueError):                  # asked for the CPU
        tquant.dequantize_blockwise(q, s, device="cpu")
    with pytest.raises(ValueError):
        tquant.dequantize_blockwise(q.to(torch.uint8), s)
    with pytest.raises(ValueError):
        tquant.dequantize_blockwise(q, s.double())
    with pytest.raises(ValueError):
        tquant.dequantize_blockwise(q, s, out_dtype=torch.float16)
    with pytest.raises(ValueError):                  # strided rows
        tquant.dequantize_blockwise(q[:, ::2], s)


@pytest.mark.parametrize("how", ["drafter", "draft_model"])
def test_model_drafter_engine_on_the_card_matches_the_cpu(dev, how):
    """The third serving slice at a small size in fp32: the model
    drafter over a copy of the target — passed as `drafter=` at
    temperature 0, so greedy drafts are accepted, or built by the engine
    from `draft_model=` with its defaults (temperature 1, block 64) —
    and the prefix cache over int8 pages, on the card against
    the CPU: the same tokens and acceptances, the tokens of the engine
    without speculation, and the dequantize, flash and verify kernels
    launched on the way.  Requests arrive one at a time, so every one
    after the first hits the cache on both devices."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = LlamaConfig.tiny(hidden_size=256, num_attention_heads=4,
                           num_key_value_heads=2, intermediate_size=512,
                           compute_dtype=torch.float32,
                           initializer_range=0.1)
    rng = np.random.default_rng(4)
    sysp = rng.integers(0, cfg.vocab_size, 17)

    def trace():
        r = np.random.default_rng(5)
        return [Request(rid=i, prompt=np.concatenate(
                    [sysp, r.integers(0, cfg.vocab_size, 6)]).astype(
                        np.int32), max_new_tokens=6, arrival_t=100.0 * i)
                for i in range(4)]

    weights = LlamaLMHeadModel(cfg, device="cpu", seed=0).state_dict()

    def copy(device):
        model = LlamaLMHeadModel(cfg, device=device, seed=0)
        model.load_state_dict(weights)
        return model

    def run(device, spec=True):
        model = copy(device)
        opts = dict(num_slots=3, page_size=8, max_len=64, prefill_chunk=16,
                    kv_quant="int8", prefix_cache=True)
        kw = {}
        if spec:
            opts.update(spec_decode="model", spec_k=3)
            kw = ({"drafter": ModelDrafter(copy(device), temperature=0.0)}
                  if how == "drafter" else {"draft_model": copy(device)})
        eng = ServingEngine(model, ServeConfig(**opts), device=device,
                            **kw).warmup()
        counters = lambda: (tquant.dequant_launches,  # noqa: E731
                            tflash.launches, tpaged.verify_launches)
        before = counters()
        res = eng.run(trace())
        eng.scheduler.check_invariants()
        moved = [a - b for a, b in zip(counters(), before)]
        return [(r.tokens, r.stats.spec_accepted) for r in res], moved

    on_card, moved = run(dev)
    on_cpu, cpu_moved = run("cpu")
    assert on_card == on_cpu
    assert all(n > 0 for n in moved) and cpu_moved == [0, 0, 0]
    if how == "drafter":
        assert sum(a for _, a in on_card) > 0
    plain, _ = run(dev, spec=False)
    assert [t for t, _ in on_card] == [t for t, _ in plain]


def test_gpt_engine_on_the_card_matches_the_cpu(dev):
    """GPT-2-large widths (hidden 1280, 20 heads of 64, vocab 50257, the
    tied head) cut to 2 layers, fp32: the engine on the card emits the
    tokens the same engine emits on the CPU, for the same weights and
    trace, greedy on exact pages."""
    from hetu_tpu_torch.models.gpt import GPTConfig, GPTLMHeadModel
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = GPTConfig.gpt2_large(num_hidden_layers=2,
                               compute_dtype=torch.float32)
    cpu_model = GPTLMHeadModel(cfg, device="cpu", seed=0)
    gpu_model = GPTLMHeadModel(cfg, device=dev, seed=0)
    gpu_model.load_state_dict(cpu_model.state_dict())
    serve = ServeConfig(num_slots=2, page_size=16, max_len=128,
                        prefill_chunk=32)

    def run(model, device):
        reqs = synthetic_requests(3, vocab_size=cfg.vocab_size,
                                  prompt_lens=(20, 70), max_new=(4, 6),
                                  arrivals=100.0 * np.arange(3), seed=3)
        eng = ServingEngine(model, serve, device=device).warmup()
        res = eng.run(reqs)
        eng.scheduler.check_invariants()
        return [r.tokens for r in res]

    before = tpaged.launches
    on_card = run(gpu_model, dev)
    assert tpaged.launches > before
    assert on_card == run(cpu_model, "cpu")


def test_gpt_training_on_the_card_matches_the_cpu(dev):
    """Three Trainer steps of a narrow GPT (hidden 256, 4 heads of 64, 2
    layers) in fp32 with flash attention, policy "nothing": the card
    (the LayerNorm arm's launches counted per step) against the CPU
    (flash's plain version forced), at the tolerances of
    `test_training_on_the_card_matches_the_cpu`."""
    from hetu_tpu_torch.models.gpt import GPTConfig, GPTLMHeadModel
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = GPTConfig.tiny(hidden_size=256, num_attention_heads=4,
                         vocab_size=4096, compute_dtype=torch.float32)
    cpu_model = GPTLMHeadModel(cfg, device="cpu", seed=0)
    gpu_model = GPTLMHeadModel(cfg, device=dev, seed=0)
    gpu_model.load_state_dict(cpu_model.state_dict())
    for block in cpu_model.model.blocks:
        block.attn.use_pallas = True
    before = tfused_norm.ln_launches, tfused_norm.ln_bwd_launches
    on_card, card_params = _three_steps(gpu_model, dev)
    L, n_micro, steps = cfg.num_hidden_layers, 2, 3
    assert (tfused_norm.ln_launches - before[0],
            tfused_norm.ln_bwd_launches - before[1]) == (
        steps * 2 * L * n_micro, steps * L * n_micro)
    on_cpu, cpu_params = _three_steps(cpu_model, "cpu")
    for c, g in zip(on_cpu, on_card):
        for k in ("loss", "grad_norm", "lr"):
            assert abs(c[k] - g[k]) <= 1e-5 * abs(c[k]), (k, c, g)
    bound = 2 * sum(m["lr"] for m in on_cpu)
    names = [n for n, _ in cpu_model.named_parameters()]
    for name, a, b in zip(names, card_params, cpu_params):
        d = (a - b).abs()
        assert d.max() <= bound, name
        if name.endswith("bqkv"):   # the key bias: its gradient is
            d = d[:, [0, 2]]        # rounding alone (tests/test_torch_gpt)
        assert (d > 1e-5).float().mean() <= 1e-3, name


def _split_case(dev, quant, dtype, group, hd, C, seed=21, ps=16, mp=130,
                n_kv=2):
    """Slots whose keys span many splits of the kernel's plan: depth
    2,047 (the table's 130 pages hold 2,080 keys, not a multiple of the
    split), depths K - 1, K and K + 1 around a split boundary, a verify
    slot whose query limits straddle one (K - 3 .. K + 1), and an
    inactive slot (position 0 on the null page).  Every pool row no
    query may read — past the slot's position in its own page, later
    pages, the rest of the null page — holds NaN (exact pages) or a NaN
    scale (quantized pages).  Returns q, (k, v, k_scale, v_scale) on the
    card, table, positions and the split's keys K."""
    _, K = tpaged.split_plan(mp, ps, C * group)
    depths = [2047, K - 1, K, K + 1, K - 3, 0]
    S = len(depths)
    g = torch.Generator(device="cpu").manual_seed(seed)
    n_pages = [0 if d == 0 else (d + C - 1) // ps + 1 for d in depths]
    P = sum(n_pages) + 1
    perm = torch.randperm(P - 1, generator=g) + 1
    table = torch.zeros((S, mp), dtype=torch.int32)
    used = 0
    for s, n in enumerate(n_pages):
        table[s, :n] = perm[used:used + n]
        used += n
    live = torch.zeros(P * ps, dtype=torch.bool)
    for s, d in enumerate(depths):
        keys = torch.arange(d + C)
        live[table[s, keys // ps].long() * ps + keys % ps] = True
    pools = []
    for _ in range(2):
        x = torch.randn((P, ps, n_kv, hd), generator=g)
        if quant == "none":
            x = x.to(dtype)
            x.view(P * ps, n_kv, hd)[~live] = float("nan")
            pools.append((x, None))
        else:
            pq, sc = _quant_pool(x, quant)
            sc.view(P * ps, n_kv)[~live] = float("nan")
            pools.append((pq, sc))
    q = torch.randn((S, C, n_kv * group, hd), generator=g).to(dtype)
    (kp, ks), (vp, vs) = pools
    on = [t if t is None else t.to(dev) for t in (kp, vp, ks, vs)]
    positions = torch.tensor(depths, dtype=torch.int32, device=dev)
    return q.to(dev), on, table.to(dev), positions, K


def _split_call(q, pools, table, positions, quant):
    k, v, ks, vs = pools
    kw = {} if quant == "none" else dict(k_scale=ks, v_scale=vs, quant=quant)
    if q.shape[1] == 1:
        return tpaged.paged_attention(q[:, 0], k, v, table, positions,
                                      **kw)[:, None]
    return tpaged.paged_verify(q, k, v, table, positions, **kw)


def _split_plain(q, pools, table, positions, quant):
    """The plain version on the same values in fp32."""
    k, v, ks, vs = pools
    if quant == "none":
        k, v = k.float(), v.float()
    return tpaged.paged_verify_plain(q.float(), k, v, table, positions,
                                     q.shape[-1] ** -0.5, ks, vs, quant)


@pytest.mark.parametrize("C", [1, 5])
@pytest.mark.parametrize("group,hd", [(1, 64), (4, 64), (1, 128), (4, 128),
                                      (1, 96), (4, 96),    # padded to 128
                                      (1, 256), (4, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("quant", ["none", "int8", "int4"])
def test_paged_split_and_merge_match_plain(dev, quant, dtype, group, hd, C):
    """The split kernel and its merge against the plain version, NaN in
    every unread row, at depths that span many splits and sit on split
    boundaries; two launches on the same inputs give the same bits.
    Head dim 96 runs zero-padded to 128; 256 merges two float4s a lane,
    and at C = 5, group 4 its 20 rows run as two row chunks."""
    q, pools, table, positions, _ = _split_case(dev, quant, dtype, group,
                                                hd, C)
    counter = ("verify_launches" if C > 1 else
               "launches" if quant == "none" else f"{quant}_launches")
    before = getattr(tpaged, counter)
    out = _split_call(q, pools, table, positions, quant)
    again = _split_call(q, pools, table, positions, quant)
    torch.cuda.synchronize()
    assert getattr(tpaged, counter) == before + 2
    assert bool(torch.isfinite(out).all())
    assert torch.equal(out, again)
    _check_paged(out, _split_plain(q, pools, table, positions, quant), dtype)


@pytest.mark.parametrize("C", [1, 5])
@pytest.mark.parametrize("quant", ["none", "int8", "int4"])
def test_paged_split_replays_from_a_cuda_graph(dev, quant, C):
    """A launch captured in a CUDA graph, replayed after `positions`
    changed in place, equals an eager launch on the new positions bit
    for bit: the split count comes from shapes alone, and the kernels
    read positions on the card."""
    q, pools, table, positions, K = _split_case(dev, quant, torch.bfloat16,
                                                4, 128, C)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _split_call(q, pools, table, positions, quant)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = _split_call(q, pools, table, positions, quant)
    # fewer keys than at capture (rows past the old ones hold NaN)
    positions.copy_(torch.tensor([1500, K - 2, K - 1, 7, K - 4, 0],
                                 dtype=torch.int32, device=dev))
    graph.replay()
    eager = _split_call(q, pools, table, positions, quant)
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)
    _check_paged(captured, _split_plain(q, pools, table, positions, quant),
                 torch.bfloat16)


@pytest.mark.parametrize("C", [6, 8])
@pytest.mark.parametrize("hd", [128, 96, 256])
@pytest.mark.parametrize("quant", ["none", "int8", "int4"])
def test_paged_verify_many_rows_match_plain(dev, quant, hd, C):
    """24 and 32 query rows a kv head (C = 6 and 8 at group 4): the
    kernel's largest row count, over many splits, NaN in unread rows;
    at head dim 256 in row chunks of 16."""
    q, pools, table, positions, _ = _split_case(dev, quant, torch.bfloat16,
                                                4, hd, C)
    out = _split_call(q, pools, table, positions, quant)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    _check_paged(out, _split_plain(q, pools, table, positions, quant),
                 torch.bfloat16)


# ------------------------------------------------------- fp16 arms
def _f16_counts():
    def f16(mod, *counters):
        return tuple(mod.arm_launches[c]["f16"] for c in counters)
    return {"swiglu": f16(tswiglu, "launches", "bwd_launches"),
            "rotary": f16(trotary, "launches", "bwd_launches"),
            "rms": f16(tfused_norm, "launches", "bwd_launches"),
            "ln": f16(tfused_norm, "ln_launches", "ln_bwd_launches"),
            "flash": _f16_flash_launches()}


def _f16_launched(before, **expect):
    """Since `before`, each fp16 arm named in `expect` launched that
    many times and every other fp16 arm none."""
    after = _f16_counts()
    for name, was in before.items():
        got = tuple(a - b for a, b in zip(after[name], was))
        assert got == expect.get(name, (0,) * len(was)), (name, got)


@pytest.mark.parametrize("inner", [13, 1000, 14336])
def test_f16_swiglu_matches_plain(dev, inner):
    """The fp16 arm of SwiGLU, forward from the strided halves of the
    fused projection (the vector arm; 13: the scalar arm) and backward
    into one buffer, each output within one fp16 ulp of the plain
    version (both round once from fp32)."""
    gu = _normal((3, 7, 2, inner), 40, dev, torch.float16)
    dy = _normal((3, 7, inner), 41, dev, torch.float16)
    before = _f16_counts()
    out = tswiglu.fused_swiglu(gu)
    dgu = tswiglu.swiglu_bwd(gu, dy)
    _f16_launched(before, swiglu=(1, 1))
    assert out.dtype == dgu.dtype == torch.float16
    _f16_close(out, tswiglu.swiglu_plain(gu[..., 0, :], gu[..., 1, :]))
    dg, du = tswiglu.swiglu_bwd_plain(gu[..., 0, :], gu[..., 1, :], dy)
    _f16_close(dgu[..., 0, :], dg)
    _f16_close(dgu[..., 1, :], du)


@pytest.mark.parametrize("hd", [64, 128])
def test_f16_rotary_matches_plain(dev, hd):
    """The fp16 arm of RoPE read in place from the fused QKV projection
    [b, s, n_kv, group + 2, hd] at per-token positions that restart (a
    packed row), forward and the backward (sign -1), within one fp16
    ulp of the plain version on contiguous copies."""
    cos, sin = build_rope_cache(256, hd, 500000.0, device=dev)
    pos = torch.cat([torch.arange(90), torch.arange(77)])[None].expand(
        2, 167).to(dev)
    cos_t, sin_t = cos[pos].contiguous(), sin[pos].contiguous()
    qkv = _normal((2, 167, 2, 4 + 2, hd), 42, dev, torch.float16)
    q, k = qkv[..., :4, :], qkv[..., 4, :]
    before = _f16_counts()
    oq, ok = trotary.fused_rotary_qk(q, k, cos_t, sin_t)
    dq, dk = trotary.rotary_qk_bwd(oq, ok, cos_t, sin_t)
    _f16_launched(before, rotary=(1, 1))
    rq, rk = trotary.rotary_qk_plain(q.reshape(2, 167, 8, hd), k, cos_t,
                                     sin_t)
    _f16_close(oq, rq)
    _f16_close(ok, rk)
    bq, bk = trotary.rotary_qk_plain(oq, ok, cos_t, -sin_t)
    _f16_close(dq, bq)
    _f16_close(dk, bk)


@pytest.mark.parametrize("kind", ["rms", "ln"])
@pytest.mark.parametrize("hidden", [64, 1000, 1280, 4096])
def test_f16_fused_norm_matches_plain(dev, kind, hidden):
    """The fp16 arm of the fused residual norm, RMS and LayerNorm (with
    a bias), forward (y, s) and backward (dx, dw, db): y, s and dx within
    one fp16 ulp of the plain version, + 1e-6 where the centred sums
    cancel (as the bf16 arm is held), dw and db (fp32 sums over the
    rows, in another order) 1e-5 of their largest entry; the same bits
    on a second backward."""
    x = _normal((5, 9, hidden), 43, dev, torch.float16)
    h = _normal((5, 9, hidden), 44, dev, torch.float16)
    w = 1.0 + 0.1 * _normal((hidden,), 45, dev)
    b = 0.1 * _normal((hidden,), 46, dev)
    dy = _normal((5, 9, hidden), 47, dev, torch.float16)
    dr = _normal((5, 9, hidden), 48, dev, torch.float16)
    before = _f16_counts()
    if kind == "rms":
        y, s = tfused_norm.residual_rmsnorm_fwd(x, h, w)
        grads = tfused_norm.residual_rmsnorm_bwd(s, w, dy, dr)
        again = tfused_norm.residual_rmsnorm_bwd(s, w, dy, dr)
        ry, rs = tfused_norm.residual_rmsnorm_plain(x, h, w, 1e-5)
        rgrads = tfused_norm.residual_rmsnorm_bwd_plain(s, w, dy, dr, 1e-5)
    else:
        y, s = tfused_norm.residual_layernorm_fwd(x, h, w, b)
        grads = tfused_norm.residual_layernorm_bwd(s, w, dy, dr)
        again = tfused_norm.residual_layernorm_bwd(s, w, dy, dr)
        ry, rs = tfused_norm.residual_layernorm_plain(x, h, w, b, 1e-5)
        rgrads = tfused_norm.residual_layernorm_bwd_plain(s, w, dy, dr,
                                                          1e-5)
    _f16_launched(before, **{kind: (1, 2)})
    for a, r in ((y, ry), (s, rs), (grads[0], rgrads[0])):
        assert a.dtype == torch.float16
        _f16_close(a, r, atol=1e-6)
    for a, r, a2 in zip(grads[1:], rgrads[1:], again[1:]):
        assert a.dtype == torch.float32 and torch.equal(a, a2)
        _of_max(a, r)


def test_f16_training_on_the_card_matches_the_cpu(dev):
    """Three Trainer steps of a narrow Llama with fp32 parameters and
    fp16 compute (flash, "dots_attn", `loss_scale="auto"`: the scaler
    on) on packed batches, card against CPU from the same weights: the
    fp16 arms launch their counts, the scale and the skip flags are the
    same each step, losses and grad norms within 2e-3 relative (fp16
    activations rounded in other places by cuBLAS's products and the
    CPU's, one fp16 ulp being 2^-11 relative)."""
    from hetu_tpu_torch.data import pack_sequences
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = LlamaConfig.tiny(hidden_size=512, num_attention_heads=4,
                           num_key_value_heads=2, intermediate_size=1536,
                           vocab_size=4096, compute_dtype=torch.float16,
                           use_flash_attention=True,
                           remat_policy="dots_attn")
    rng = np.random.default_rng(3)
    seqs = [rng.integers(1, 4096, n) for n in (40, 9, 64, 31, 17, 55, 12)]
    batch = pack_sequences(seqs, 64, num_packed=4)
    tc = TrainingConfig(global_batch_size=4, micro_batch_size=2, seq_len=64,
                        warmup_steps=1, total_steps=10, log_every=100,
                        packing=True)
    cpu_model = LlamaLMHeadModel(cfg, device="cpu", seed=0)
    gpu_model = LlamaLMHeadModel(cfg, device=dev, seed=0)
    gpu_model.load_state_dict(cpu_model.state_dict())
    for layer in cpu_model.model.layers:
        layer.attn.use_pallas = True
    runs = []
    for model, device in ((gpu_model, dev), (cpu_model, "cpu")):
        tr = Trainer(model, tc, device=device)
        before = _f16_counts()
        runs.append([{k: float(v) for k, v in tr.train_step(batch).items()}
                     for _ in range(3)])
        if device != "cpu":
            L, micro, steps = 2, 2, 3
            fwd, bwd = 2 * L * micro * steps, L * micro * steps
            _f16_launched(before, swiglu=(fwd, bwd), rotary=(fwd, bwd),
                          rms=(fwd, bwd), flash=(bwd, bwd, bwd))
    on_card, on_cpu = runs
    for g, c in zip(on_card, on_cpu):
        assert g["loss_scale"] == c["loss_scale"] == 2.0 ** 16
        assert g["amp_skipped"] == c["amp_skipped"] == 0.0
        for k in ("loss", "grad_norm"):
            assert abs(g[k] - c[k]) <= 2e-3 * abs(c[k]), (k, g, c)


# ------------------------------------------------------------------ LoRA
def _lora_config(family, **kw):
    from hetu_tpu_torch.models.gpt import GPTConfig
    common = dict(vocab_size=1024, num_hidden_layers=2,
                  param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
                  use_flash_attention=True)
    common.update(kw)
    if family == "llama":
        return LlamaConfig.tiny(hidden_size=256, num_attention_heads=2,
                                num_key_value_heads=1, intermediate_size=512,
                                **common)
    return GPTConfig.tiny(hidden_size=256, num_attention_heads=4, **common)


def _lora_model(family, cfg, device, seed=0):
    from hetu_tpu_torch.models.gpt import GPTLMHeadModel
    cls = LlamaLMHeadModel if family == "llama" else GPTLMHeadModel
    return cls(cfg, device=device, seed=seed)


@pytest.mark.parametrize("family", ["llama", "gpt"])
def test_lora_sft_on_the_card_matches_the_cpu(dev, family):
    """Three LoRA SFT steps (rank 4, every target, prompt-masked rows)
    of a bf16 base computing in bf16 on the card and on the CPU from one
    base and one set of adapters: losses and grad norms within 2e-3
    relative (as the fp16 training test: bf16 activations rounded in
    other places by cuBLAS's products and the CPU's, one bf16 ulp being
    2^-8 relative), the base bit for bit and without a gradient on
    both."""
    from hetu_tpu_torch.engine import SFTTrainer, mask_prompt_labels
    from hetu_tpu_torch.peft import LoRAConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _lora_config(family)
    cpu_model = _lora_model(family, cfg, "cpu")
    gpu_model = _lora_model(family, cfg, dev)
    gpu_model.load_state_dict(cpu_model.state_dict())
    for layer in cpu_model.layers:
        layer.attn.use_pallas = True
    base = [p.detach().cpu().clone() for p in gpu_model.parameters()]
    tc = TrainingConfig(global_batch_size=4, micro_batch_size=2, seq_len=64,
                        warmup_steps=1, total_steps=10, log_every=100)
    trainers = [SFTTrainer(m, tc, lora=LoRAConfig(rank=4), device=d)
                for m, d in ((gpu_model, dev), (cpu_model, "cpu"))]
    with torch.no_grad():
        for a, b in zip(trainers[0].model.lora.values(),
                        trainers[1].model.lora.values()):
            a.copy_(b)
    rng = np.random.default_rng(8)
    for _ in range(3):
        ids = rng.integers(1, 1024, (4, 64)).astype(np.int32)
        batch = {"input_ids": ids,
                 "labels": mask_prompt_labels(ids, rng.integers(3, 20, 4))}
        g, c = ({k: float(v) for k, v in tr.train_step(batch).items()}
                for tr in trainers)
        for k in ("loss", "grad_norm"):
            assert abs(g[k] - c[k]) <= 2e-3 * abs(c[k]), (k, g, c)
    for p, b in zip(gpu_model.parameters(), base):
        assert p.grad is None and torch.equal(p.detach().cpu(), b)


@pytest.mark.parametrize("policy", ["nothing", "dots", "dots_attn",
                                    "offload"])
@pytest.mark.parametrize("family", ["llama", "gpt"])
def test_lora_policies_give_the_same_gradients_on_the_card(dev, family,
                                                           policy):
    """The adapters' gradients under each recompute policy equal those
    without recompute bit for bit on the card (flash, bf16): a segment
    merges W + A B again in its backward with the bits of the forward's
    merge."""
    from hetu_tpu_torch.peft import LoRAConfig, LoRAWrappedModel
    grads = []
    for remat, pol in ((False, "dots"), (True, policy)):
        model = _lora_model(family, _lora_config(
            family, remat=remat, remat_policy=pol), dev, seed=2)
        wrapped = LoRAWrappedModel(model, LoRAConfig(rank=4), seed=3)
        gen = torch.Generator(device=dev).manual_seed(4)
        with torch.no_grad():
            for p in wrapped.lora.values():
                p.normal_(0.0, 0.05, generator=gen)
        ids = torch.from_numpy(np.random.default_rng(6).integers(
            0, 1024, (2, 128)).astype(np.int32)).to(dev)
        loss, _ = wrapped(ids, ids, loss_reduction="sum")
        loss.backward()
        grads.append([p.grad.clone() for p in wrapped.lora.values()])
        assert all(p.grad is None for p in model.parameters())
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_numerics_stats_on_the_card_match_the_cpu(dev):
    """`tree_stats` of card tensors (fp32, bf16, fp16; zeros, the
    underflow band, overflows, inf, nan) equals that of the same values
    on the CPU within 1e-6 relative, counts exactly."""
    from hetu_tpu_torch.obs import numerics
    x = _normal((8192,), 5, "cpu")
    x[:50] = 0.0
    x[50:90] = 1e-37
    x[90:95] = 1e5
    x[95], x[96], x[97] = float("inf"), float("-inf"), float("nan")
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        tree = {"a": x.to(dtype), "b": [x[:1000].to(dtype) * 3]}
        card = numerics.tree_stats({"a": tree["a"].to(dev),
                                    "b": [tree["b"][0].to(dev)]})
        host = numerics.tree_stats(tree)
        for k, v in host.items():
            a, b = float(card[k]), float(v)
            assert (a == b or abs(a - b) <= 1e-6 * abs(b)
                    or (np.isnan(a) and np.isnan(b))), (dtype, k, a, b)


def test_update_stats_are_taken_a_group_at_a_time(dev):
    """AdamW under a numerics collector on the card: one launch a
    snapshot group (two here, by a small budget), the "update" stats
    those of new - old over a full copy."""
    from hetu_tpu_torch.obs import numerics
    from hetu_tpu_torch.optim import optimizer as toptim
    params = [_normal((n,), 20 + i, dev) for i, n in
              enumerate((4096, 1000, 8192))]
    grads = [_normal(p.shape, 30 + i, dev) for i, p in enumerate(params)]
    opt = toptim.AdamW(lr=1e-2, weight_decay=0.1, device=dev)
    state = opt.init(params)
    old = [p.clone() for p in params]
    budget, toptim.SNAPSHOT_BYTES = toptim.SNAPSHOT_BYTES, 4 * 6000
    tadam.launches = 0
    try:
        with numerics.collecting() as col:
            opt.update(grads, state, params)
            stats = col.finalize()
    finally:
        toptim.SNAPSHOT_BYTES = budget
    assert tadam.launches == 2
    whole = numerics.tree_stats([p - o for p, o in zip(params, old)])
    for k, v in whole.items():
        assert abs(float(stats["update"][k]) - float(v)) <= \
            1e-6 * abs(float(v)), k


# ------------------------------------------------- the serving host layers
def _host_config():
    return LlamaConfig.tiny(hidden_size=256, num_attention_heads=4,
                            num_key_value_heads=2, intermediate_size=512,
                            compute_dtype=torch.float32,
                            initializer_range=0.1)


def _host_trace(cfg, n=10, sampled=True):
    """Every request at once (admission order is the rid order); gold
    (priority 2) and bulk alternate by rid and so do tenants acme and
    free; the odd requests sampled."""
    from hetu_tpu_torch.serving import SLOClass
    reqs = synthetic_requests(
        n, vocab_size=cfg.vocab_size, prompt_lens=(5, 40),
        max_new=(4, 9), arrivals=np.zeros(n),
        slo_classes=[SLOClass("gold", priority=2), SLOClass("bulk")],
        tenants=["acme", "free"], seed=9)
    if sampled:
        for r in reqs[1::2]:
            r.sampling = SamplingParams(temperature=0.8, top_k=20,
                                        top_p=0.95, seed=50 + r.rid)
    return reqs


@pytest.mark.parametrize("path", ["policies", "disagg-none", "disagg-int8",
                                  "disagg-int4", "storm", "frontend"])
def test_serving_host_layers_on_the_card_match_the_cpu(dev, path):
    """A narrow Llama in fp32 through the serving host layers on exact
    pages, on the card against the CPU (the plain versions), same
    weights and trace: preemption, a tenant quota and an engine kill
    under a retry budget; the disaggregated pipeline over each wire (and
    the exact wire under a shipment storm and a prefill kill); the
    frontend with a replica kill and hedging.  The same tokens and
    finish reasons, the same counters; on the card the wire is packed
    and unpacked by the kernels."""
    from hetu_tpu_torch.chaos.inject import maybe_chaos_serving
    from hetu_tpu_torch.chaos.plan import FaultPlan, FaultSpec
    from hetu_tpu_torch.serving import (DisaggCoordinator, Frontend,
                                        PrefillWorker, parse_quotas)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _host_config()
    weights = LlamaLMHeadModel(cfg, device="cpu", seed=0).state_dict()
    base = dict(num_slots=3, page_size=8, max_len=64, prefill_chunk=16,
                sampling=True)

    def run(device):
        model = LlamaLMHeadModel(cfg, device=device, seed=0)
        model.load_state_dict(weights)
        checks = []
        if path == "policies":
            eng = ServingEngine(model, ServeConfig(
                **base, preempt=True, retry_budget=1,
                quotas=parse_quotas("free:1")), device=device)
            plan = FaultPlan([FaultSpec(kind="engine_kill", at_step=7)])

            def on_step(i):
                maybe_chaos_serving(plan, eng, i)
                eng.scheduler.check_invariants()
            res = eng.run(_host_trace(cfg), on_step=on_step)
            reg = eng.registry
            counts = [reg.counter_value(n) for n in (
                "serve.preemptions", "serve.replica_requeues")]
            checks = counts + [reg.counter_value(
                "serve.admission_stalls", reason="quota_exceeded")]
            assert all(n > 0 for n in checks)
        elif path == "frontend":
            engines = [ServingEngine(model, ServeConfig(
                **base, retry_budget=2), device=device) for _ in range(2)]
            plan = FaultPlan([FaultSpec(kind="engine_kill", rank=0,
                                        at_step=3, count=3)])
            fe = Frontend(engines, plan=plan, hedge_after=2,
                          quotas=parse_quotas("free:2"))
            res = fe.run(_host_trace(cfg))
            s = fe.summary()
            checks = [s["reroutes"], s["hedges"], s["quota_holds"]]
        else:
            wire = "none" if path == "storm" else path.split("-")[1]
            plan = None
            if path == "storm":
                plan = FaultPlan([
                    FaultSpec(kind="shipment_drop", op="ship",
                              after_calls=1, count=2, prob=1.0),
                    FaultSpec(kind="shipment_dup", op="ship",
                              after_calls=4, count=2, prob=1.0),
                    FaultSpec(kind="shipment_delay", op="ship",
                              after_calls=6, count=1, prob=1.0,
                              delay_s=2.0),
                    FaultSpec(kind="prefill_kill", at_step=5)])
            eng = ServingEngine(model, ServeConfig(**base, retry_budget=2),
                                device=device)
            coord = DisaggCoordinator(
                PrefillWorker(model, prefill_chunk=16, max_len=64,
                              sampling=True, device=device),
                eng, plan=plan, ship_quant=wire)
            res = coord.run(_host_trace(cfg),
                            on_step=lambda i: eng.scheduler
                            .check_invariants())
            s = coord.summary()
            s.pop("degraded_s")
            checks = sorted(s.items())
        return [(r.rid, r.tokens, r.finished_reason) for r in res], checks

    q0, d0 = tquant.launches, tquant.dequant_launches
    on_card = run(dev)
    moved = (tquant.launches - q0, tquant.dequant_launches - d0)
    assert on_card == run("cpu")
    if path == "disagg-int8":
        assert moved[0] > 0 and moved[1] > 0
    elif path != "disagg-int4":
        assert moved == (0, 0)
    if path in ("policies", "disagg-none", "storm", "frontend"):
        # exact pages and an exact wire: the colocated run's tokens
        model = LlamaLMHeadModel(cfg, device=dev, seed=0)
        model.load_state_dict(weights)
        alone = ServingEngine(model, ServeConfig(**base), device=dev).run(
            _host_trace(cfg))
        want = {r.rid: r.tokens for r in alone}
        for rid, tokens, reason in on_card[0]:
            if reason in ("length", "eos"):
                assert tokens == want[rid], rid


def test_int8_wire_launches_two_kernels_a_side_and_matches_plain(dev):
    """An int8 shipment of a prefill's [L, max_len, n_kv, hd] scratch:
    the pack launches the quantize twice (K and V), the unpack the
    dequantize twice; payload, scales and the unpacked values equal the
    plain versions' on the same values, bit for bit, and the payload
    crossed to host memory."""
    from hetu_tpu_torch.serving import pack_shipment, unpack_shipment
    req = Request(rid=3, prompt=np.ones(5, np.int32), max_new_tokens=2)
    for dtype in (torch.float32, torch.bfloat16):
        ks = _normal((4, 64, 2, 128), 60, dev, dtype)
        vs = _normal((4, 64, 2, 128), 61, dev, dtype)
        q0, d0 = tquant.launches, tquant.dequant_launches
        ship = pack_shipment(1, req, 0, 7, ks, vs, quant="int8")
        assert (tquant.launches - q0, tquant.dequant_launches - d0) == (2, 0)
        assert ship.ks.device.type == "cpu" and ship.k_scale.dtype == \
            torch.float32
        bk, bv = unpack_shipment(ship, dev)
        assert (tquant.launches - q0, tquant.dequant_launches - d0) == (2, 2)
        plain = pack_shipment(1, req, 0, 7, ks.cpu(), vs.cpu(), quant="int8")
        for a, b in ((ship.ks, plain.ks), (ship.vs, plain.vs),
                     (ship.k_scale, plain.k_scale),
                     (ship.v_scale, plain.v_scale)):
            assert torch.equal(a, b), dtype
        pk, pv = unpack_shipment(plain)
        assert torch.equal(bk.cpu(), pk) and torch.equal(bv.cpu(), pv)
        assert ship.wire_bytes == 2 * (ks.numel() + 4 * ks.numel() // 128)


def test_numerics_kv_pages_snr_on_the_card_matches_the_cpu(dev,
                                                           monkeypatch,
                                                           tmp_path):
    """HETU_TORCH_NUMERICS on int8 pages: the engine's numerics records
    on the card (the SNR taps on the quantize and dequantize kernels)
    against the CPU's: the same steps and scopes, logits stats within
    2e-3, err_pow within 5% and snr_db within 0.25 dB (the K and V of
    the two devices' products differ by rounding); without the flag the
    taps launch nothing."""
    from hetu_tpu_torch.obs.runlog import RunLog
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _host_config()
    weights = LlamaLMHeadModel(cfg, device="cpu", seed=0).state_dict()
    serve = ServeConfig(num_slots=3, page_size=8, max_len=64,
                        prefill_chunk=16, kv_quant="int8")

    def run(device, tag):
        model = LlamaLMHeadModel(cfg, device=device, seed=0)
        model.load_state_dict(weights)
        log = RunLog(str(tmp_path / f"{tag}.jsonl"))
        ServingEngine(model, serve, device=device, run_log=log).run(
            _host_trace(cfg, n=4, sampled=False))
        log.close()
        return [r for r in RunLog.read(str(tmp_path / f"{tag}.jsonl"))
                if r["kind"] == "numerics"]

    q0 = tquant.launches
    assert run(dev, "off") == [] and tquant.launches == q0
    monkeypatch.setenv("HETU_TORCH_NUMERICS", "1")
    card, host = run(dev, "card"), run("cpu", "cpu")
    assert tquant.launches > q0 and len(card) == len(host) > 0
    for t, c in zip(card, host):
        assert t["step"] == c["step"]
        assert set(t["scopes"]) == set(c["scopes"]) >= {"kv_pages", "logits"}
        for scope, stats in c["scopes"].items():
            for name, v in stats.items():
                tol = {"err_pow": dict(rtol=5e-2),
                       "snr_db": dict(atol=0.25)}.get(
                           name, dict(rtol=2e-3, atol=1e-5))
                np.testing.assert_allclose(t["scopes"][scope][name], v,
                                           err_msg=f"{scope}.{name}", **tol)
