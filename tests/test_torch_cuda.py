"""The PyTorch port's hand-written CUDA kernels against their plain
versions, on the card.

This file imports no JAX, so it runs on a GPU machine that has none:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(`--noconftest` skips tests/conftest.py, which sets JAX up).  Every test
is marked `cuda` and skips where there is no card; whether there is one
is decided in a fixture at run time, never at import, so every pytest
worker collects the same tests.  Tolerances: the plain versions repeat
the kernels' fp32 arithmetic, so rotary and SwiGLU agree within one
bf16 ulp, paged attention within 1e-4 on fp32 pools; on bf16 pools its
output, rounded once to bf16, lies within half a bf16 ulp (plus 1e-5
for fp32 summation order) of the plain version on the same values in
fp32, which a wrong rounding or a dropped key breaks.
"""
from __future__ import annotations

import pytest
import torch

from hetu_tpu_torch.models.llama import LlamaConfig, LlamaLMHeadModel
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
    _bf16_close(tq, rq)
    _bf16_close(tk, rk)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_swiglu_matches_plain_on_strided_views(dev, dtype):
    gu = _normal((3, 7, 2, 384), 6, dev, dtype)
    before = tswiglu.launches
    out = tswiglu.fused_swiglu(gu[:, :, 0], gu[:, :, 1])
    assert tswiglu.launches == before + 1
    _bf16_close(out, tswiglu.swiglu_plain(gu[:, :, 0], gu[:, :, 1]))


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
