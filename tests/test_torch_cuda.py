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
rounding or a dropped key breaks.  The training step on the card is
held against the same step on the CPU (the plain versions).
"""
from __future__ import annotations

import pytest
import torch

import numpy as np

from hetu_tpu_torch.engine import Trainer, TrainingConfig
from hetu_tpu_torch.models.llama import LlamaConfig, LlamaLMHeadModel
from hetu_tpu_torch.ops.cuda import adam as tadam
from hetu_tpu_torch.ops.cuda import fused_norm as tfused_norm
from hetu_tpu_torch.ops.cuda import paged_attention as tpaged
from hetu_tpu_torch.ops.cuda import rotary as trotary
from hetu_tpu_torch.ops.cuda import swiglu as tswiglu
from hetu_tpu_torch.ops.rotary import build_rope_cache
from hetu_tpu_torch.serving import (ServeConfig, ServingEngine,
                                    poisson_arrivals, synthetic_requests)

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


def test_training_on_the_card_matches_the_cpu(dev):
    """Three Trainer steps of a narrow Llama (hidden 512, 4 q over 2 kv
    heads of 128, 2 layers) in fp32: the card (the kernels, every
    training kernel launched) against the CPU (the plain versions), same
    weights and batches.  Losses and grad norms agree to 1e-5; AdamW
    normalizes each step, so an element whose gradient is within
    rounding of zero can move by up to lr in one run and not the other:
    parameters agree within 2 x the summed lr everywhere and within 1e-5
    on all but 0.1% of elements."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = LlamaConfig.tiny(hidden_size=512, num_attention_heads=4,
                           num_key_value_heads=2, intermediate_size=1536,
                           vocab_size=4096, compute_dtype=torch.float32,
                           use_flash_attention=False)
    cpu_model = LlamaLMHeadModel(cfg, device="cpu", seed=0)
    gpu_model = LlamaLMHeadModel(cfg, device=dev, seed=0)
    gpu_model.load_state_dict(cpu_model.state_dict())
    mods = (tfused_norm, tswiglu, trotary, tadam)
    before = [(m.launches, getattr(m, "bwd_launches", 0)) for m in mods]
    on_card, card_params = _three_steps(gpu_model, dev)
    after = [(m.launches, getattr(m, "bwd_launches", 0)) for m in mods]
    L, n_micro, steps = cfg.num_hidden_layers, 2, 3
    per_step = {tfused_norm: (2 * L * n_micro, L * n_micro),
                tswiglu: (2 * L * n_micro, L * n_micro),
                trotary: (2 * L * n_micro, L * n_micro),
                tadam: (len(card_params), 0)}
    for m, b, a in zip(mods, before, after):
        assert (a[0] - b[0], a[1] - b[1]) == tuple(
            steps * n for n in per_step[m]), m.__name__
    on_cpu, cpu_params = _three_steps(cpu_model, "cpu")
    for c, g in zip(on_cpu, on_card):
        for k in ("loss", "grad_norm", "lr"):
            assert abs(c[k] - g[k]) <= 1e-5 * abs(c[k]), (k, c, g)
    bound = 2 * sum(m["lr"] for m in on_cpu)
    for a, b in zip(card_params, cpu_params):
        d = (a - b).abs()
        assert d.max() <= bound
        assert (d > 1e-5).float().mean() <= 1e-3
