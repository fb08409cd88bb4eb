"""fp16 serving in the PyTorch port against the JAX reference, on the CPU.

What is held against what:

  * `LlamaConfig.llama2_7b` / `llama2_13b` field for field against the
    reference's presets;
  * the fp16 arms' plain versions (the yardsticks their CUDA kernels are
    held to on the card) against the reference's Pallas kernels in fp16,
    in interpret mode (HETU_TPU_PALLAS=1) where the reference's gate
    takes the shape: paged decode and verify over exact, int8 and int4
    pages within one fp16 ulp + 1e-5 (both round once to fp16 from fp32
    values that differ in summation order alone); the blockwise quantize
    (scales within the fp32 ulp the reference allows its kernel, the
    payload bit for bit wherever the scales agree) and the KV page write
    (`write_kv_tokens` against the reference pool's `write_tokens`) bit
    for bit; the dequantize to fp16 equal to the reference's fp32 output
    cast; the fused sampler's tokens equal on
    every row whose top-two gap after noise exceeds 1e-3 (the others
    counted, as on the card);
  * `load_jax_params` into a model with fp16 parameters: the forward's
    logits against the reference's fp16 forward;
  * a tiny fp16 Llama with as many kv heads as query heads (Llama-2's
    attention) served by the port's engine and the reference's from the
    same fp16 weights, greedy and sampled requests with n-gram
    speculation on int8 pages: tokens and speculation counts equal (a
    difference only after a near-tie, which these seeds do not meet);
  * a tiny fp16 GPT with a tied head and an fp16 draft model (resident
    int8, its working copy in fp16) with the prefix cache on fp16 exact
    pages, greedy and sampled requests (the stochastic p/q rule over the
    draft's fp16 proposals): the reference engine's tokens, drafts
    proposed and accepted, and prefix hits.

The reference's params are drawn in numpy by its init's law
(`_reference_params`) and its forward is jitted, so no reference init
compiles: the module's tests take about 24 s on one CPU process.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from hetu_tpu import serving as jserving
from hetu_tpu.comm import compress as jcompress
from hetu_tpu.models.gpt import GPTConfig as JGPTConfig
from hetu_tpu.models.gpt import GPTLMHeadModel as JGPTLMHeadModel
from hetu_tpu.models.llama import LlamaConfig as JLlamaConfig
from hetu_tpu.models.llama import LlamaLMHeadModel as JLlamaLMHeadModel
from hetu_tpu.obs.metrics import MetricsRegistry as JMetricsRegistry
from hetu_tpu.ops.pallas import paged_attention as jpaged
from hetu_tpu.ops.pallas import quant as jpquant
from hetu_tpu.ops.pallas import sample as jpsample
from hetu_tpu.serving import kv_pool as jkv_pool
from hetu_tpu.serving import sampling as jsampling
from hetu_tpu.serving import spec_decode as jspec
from hetu_tpu_torch import serving as tserving
from hetu_tpu_torch.models.gpt import GPTConfig, GPTLMHeadModel
from hetu_tpu_torch.models.llama import (LlamaConfig, LlamaLMHeadModel,
                                         load_jax_params)
from hetu_tpu_torch.ops.cuda import kv_write as tkv
from hetu_tpu_torch.ops.cuda import paged_attention as tpaged
from hetu_tpu_torch.ops.cuda import quant as tq
from hetu_tpu_torch.ops.cuda import sample as tsample
from hetu_tpu_torch.serving import spec_decode as tspec
from test_torch_fp16 import _f16_close
from test_torch_moe import _reference_params
from test_torch_spec import _jax_kw, _pages, _port_kw

F16 = torch.float16
PAGED_ATOL = 1e-5
ENGINE = dict(num_slots=3, page_size=8, max_len=64, prefill_chunk=8)
#: Llama-2's attention (as many kv heads as query heads) at head dim 128
MHA128 = dict(hidden_size=256, num_attention_heads=2, num_key_value_heads=2,
              intermediate_size=512)
#: a tied-head GPT at head dim 128
GPT128 = dict(hidden_size=256, num_attention_heads=2)
_TABLE = np.array([[1, 2, 3, 0], [4, 5, 0, 0], [6, 7, 8, 0], [0, 0, 0, 0]],
                  np.int32)


@pytest.fixture
def pallas(monkeypatch):
    monkeypatch.setenv("HETU_TPU_PALLAS", "1")
    monkeypatch.setenv("HETU_TPU_PALLAS_KERNELS",
                       "paged_attn,paged_verify,sample,quant")


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _j16(a):
    return jnp.asarray(np.asarray(a, np.float32), jnp.float16)


# ------------------------------------------------------------- presets
@pytest.mark.parametrize("preset", ["llama2_7b", "llama2_13b"])
def test_llama2_presets_equal_the_reference(preset):
    """Every field both configs have, equal (dtypes by name)."""
    mine = getattr(LlamaConfig, preset)()
    ref = getattr(JLlamaConfig, preset)()
    names = {f.name for f in dataclasses.fields(mine)} & \
        {f.name for f in dataclasses.fields(ref)}
    assert {"vocab_size", "hidden_size", "intermediate_size",
            "num_hidden_layers", "num_attention_heads",
            "num_key_value_heads", "max_position_embeddings",
            "rope_theta", "rms_norm_eps"} <= names
    for name in sorted(names):
        a, b = getattr(mine, name), getattr(ref, name)
        if isinstance(a, torch.dtype):
            assert str(a).replace("torch.", "") == np.dtype(b).name, name
        else:
            assert a == b, name
    assert mine.head_dim == ref.head_dim == 128
    assert mine.num_key_value_heads == mine.num_attention_heads


# ------------------------------------------------------ paged attention
@pytest.mark.parametrize("C", [1, 5])
@pytest.mark.parametrize("quant", ["none", "int8", "int4"])
def test_paged_fp16_plain_matches_pallas_kernel(pallas, quant, C):
    """fp16 queries (and fp16 exact pages) over a slot table whose verify
    block runs past slot 2's table row: within one fp16 ulp + 1e-5 of
    the Pallas kernel in fp16."""
    k, v, ks, vs = _pages(11 + C, quant)
    q = np.random.default_rng(12 + C).standard_normal(
        (4, C, 4, 128)).astype(np.float32)
    positions = np.array([20, 9, 30 - C, 0], np.int32)
    if quant == "none":
        jk, jv, tk, tv = _j16(k), _j16(v), _t(k, F16), _t(v, F16)
    else:
        jk, jv, tk, tv = jnp.asarray(k), jnp.asarray(v), _t(k), _t(v)
    args_j = (jnp.asarray(_TABLE), jnp.asarray(positions))
    args_t = (_t(_TABLE), _t(positions))
    if C == 1:
        ref = jpaged.paged_attention(_j16(q[:, 0]), jk, jv, *args_j,
                                     **_jax_kw(ks, vs, quant))
        out = tpaged.paged_attention(_t(q[:, 0], F16), tk, tv, *args_t,
                                     device="cpu", **_port_kw(ks, vs, quant))
    else:
        ref = jpaged.paged_verify(_j16(q), jk, jv, *args_j,
                                  **_jax_kw(ks, vs, quant))
        out = tpaged.paged_verify(_t(q, F16), tk, tv, *args_t, device="cpu",
                                  **_port_kw(ks, vs, quant))
    assert ref.dtype == jnp.float16 and out.dtype == F16
    _f16_close(out, np.asarray(ref, np.float32), PAGED_ATOL)
    # the split-then-merge form the kernel computes, at a split that cuts
    # pages, within the same bound
    split = tpaged.paged_verify_split_plain(
        _t(q, F16)[:, :C], tk, tv, *args_t, 1.0 / np.sqrt(128.0),
        **({} if quant == "none" else dict(k_scale=_t(ks), v_scale=_t(vs),
                                           quant=quant)),
        keys_per_split=12)
    _f16_close(split.reshape(out.shape), np.asarray(ref, np.float32),
               PAGED_ATOL)


# ------------------------------------- quantize, page write, dequantize
@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_fp16_is_the_pallas_kernels_bits(pallas, bits):
    """fp16 blocks (wide dynamic range, one block of zeros) against the
    Pallas quantize in fp16 and the reference's XLA path: the scales
    within the one fp32 ulp the reference allows its kernel (its
    division by qmax may round the other way), the payload bit for bit
    wherever the scales agree (fp16 values sit on a coarse grid, so a
    quotient can land on a half exactly, where a scale one ulp off rounds
    it the other way); and the bits of the input's exact fp32 widening."""
    rng = np.random.default_rng(bits)
    x = (rng.standard_normal((24, 128)) *
         rng.exponential(size=(24, 1)) * 50).astype(np.float16)
    x[3] = 0
    jq, js = jpquant.quantize_blockwise_pallas(jnp.asarray(x), 128,
                                               bits=bits)
    q, s = tq.quantize_blockwise(_t(x), 128, bits=bits, device="cpu")
    xq, xs = jcompress.quantize_blockwise(jnp.asarray(x.reshape(-1)), 128,
                                          bits=bits)
    for rq, rs in ((jq, js), (xq, xs)):
        np.testing.assert_array_max_ulp(s.numpy(), np.asarray(rs), maxulp=1)
        agree = s.numpy() == np.asarray(rs)
        assert agree.sum() >= len(agree) // 2
        np.testing.assert_array_equal(q.numpy()[agree], np.asarray(rq)[agree])
    q32, s32 = tq.quantize_blockwise(_t(x).float(), 128, bits=bits,
                                     device="cpu")
    assert torch.equal(q, q32) and torch.equal(s, s32)


@pytest.mark.parametrize("quant", ["none", "int8", "int4"])
def test_page_write_fp16_is_the_reference_pools_bits(quant):
    """A verify step's fp16 K and V block (C = 3, slot 2 past its table
    row) into fp16 exact pages or int8 / int4 pages: every pool byte and
    scale as the reference pool's `write_tokens` leaves them."""
    L, P, ps, n_kv, hd = 1, 9, 8, 2, 128
    rng = np.random.default_rng(31)
    S, C = 4, 3
    k = (rng.standard_normal((S, C, n_kv, hd)) * 3).astype(np.float16)
    v = (rng.standard_normal((S, C, n_kv, hd)) * 3).astype(np.float16)
    positions = np.array([20, 9, 30, 0], np.int32)
    jpool = jkv_pool.PagePool(num_layers=L, num_pages=P - 1, page_size=ps,
                              num_kv_heads=n_kv, head_dim=hd,
                              dtype=jnp.float16, quant=quant)
    pos = positions[:, None] + np.arange(C, dtype=np.int32)
    jout = jkv_pool.PoolArrays.from_tree(jpool.write_tokens(
        jpool.arrays.tree(), jnp.asarray(_TABLE), jnp.asarray(pos),
        jnp.asarray(k)[None], jnp.asarray(v)[None]))
    hd_p = hd // 2 if quant == "int4" else hd
    pay = {"none": F16, "int8": torch.int8, "int4": torch.uint8}[quant]
    kp = torch.zeros((P, ps, n_kv, hd_p), dtype=pay)
    vp = torch.zeros_like(kp)
    scales = {}
    if quant != "none":
        scales = dict(k_scale=torch.zeros((P, ps, n_kv)),
                      v_scale=torch.zeros((P, ps, n_kv)))
    tkv.write_kv_tokens(kp, vp, _t(_TABLE), _t(positions), _t(k), _t(v),
                        quant=quant, device="cpu", **scales)
    for mine, ref in ((kp, jout.k), (vp, jout.v)):
        np.testing.assert_array_equal(
            mine.view(torch.uint8 if pay != F16 else torch.int16).numpy(),
            np.asarray(ref[0]).view(np.uint8 if pay != F16 else np.int16))
    if quant != "none":
        np.testing.assert_array_equal(scales["k_scale"].numpy(),
                                      np.asarray(jout.k_scale[0]))
        np.testing.assert_array_equal(scales["v_scale"].numpy(),
                                      np.asarray(jout.v_scale[0]))


def test_dequantize_to_fp16_is_the_reference_output_cast(pallas):
    """The fp16 arm's plain version: the reference's fp32 dequantize,
    cast once to fp16 (values past fp16's range go to inf as the cast
    takes them)."""
    rng = np.random.default_rng(5)
    q = rng.integers(-127, 128, (32, 128)).astype(np.int8)
    s = (rng.exponential(size=32) * 0.05).astype(np.float32)
    s[7] = 700.0                            # 127 x 700 > 65504
    ref = jpquant.dequantize_blockwise_pallas(jnp.asarray(q), jnp.asarray(s))
    out = tq.dequantize_blockwise(_t(q), _t(s), out_dtype=F16, device="cpu")
    assert out.dtype == F16
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(ref, np.float32).astype(np.float16))
    assert bool(torch.isinf(out[7 * 128:8 * 128]).any())


# ------------------------------------------------------------- sampler
def test_fused_sample_fp16_matches_pallas_kernel(pallas):
    """fp16 hidden rows and head; rows greedy, temperature, top-k, top-p
    and both: tokens equal to the Pallas kernel's on every row whose top
    two after noise lie more than 1e-3 apart."""
    rng = np.random.default_rng(9)
    R, H, V = 15, 128, 256
    hidden = rng.standard_normal((R, H)).astype(np.float16)
    w = (0.3 * rng.standard_normal((H, V))).astype(np.float16)
    temps = np.array([0.0, 1.0, 0.8, 0.9, 0.7] * 3, np.float32)
    top_ks = np.array([0, 0, 20, 0, 20] * 3, np.int32)
    top_ps = np.array([0.0, 0.0, 0.0, 0.9, 0.9] * 3, np.float32)
    seeds = np.arange(R, dtype=np.int32) * 7 + 1
    positions = np.arange(R, dtype=np.int32) + 10
    words = np.asarray(jsampling.key_words(jnp.asarray(seeds),
                                           jnp.asarray(positions)))
    ref = np.asarray(jpsample.fused_sample(
        jnp.asarray(hidden), jnp.asarray(w), jnp.asarray(words),
        jnp.asarray(temps), jnp.asarray(top_ks), jnp.asarray(top_ps)))
    args = (_t(words.astype(np.int64)), _t(temps), _t(top_ks), _t(top_ps))
    out = tsample.fused_sample(_t(hidden), _t(w), *args, device="cpu")
    logits = _t(hidden).float() @ _t(w).float()
    noisy = tsample.filtered_logits(logits, *args[1:]) + tsample.gumbel(
        args[0][:, :1], args[0][:, 1:], torch.arange(V)[None])
    noisy = torch.where(_t(temps)[:, None] > 0, noisy, logits)
    top2 = noisy.topk(2, dim=-1).values
    clear = ((top2[:, 0] - top2[:, 1]) > 1e-3).numpy()
    assert clear.sum() >= R - 1
    np.testing.assert_array_equal(out.numpy()[clear], ref[clear])
    # the draw over existing fp16 logits: the plain sampler's tokens
    lg16 = logits.to(F16)
    assert torch.equal(tsample.sample_logits(lg16, *args, device="cpu"),
                       tsample.sample_plain(lg16.float(), *args))


# --------------------------------------------------------------- models
def _fp16_pair(family, seed=3, **cfg):
    """(JAX model, JAX params, port model on the CPU): fp16 parameters and
    fp16 compute on both sides, the params drawn in numpy by the
    reference's init law (`_reference_params`) and carried by
    `load_jax_params`."""
    f16 = dict(param_dtype=jnp.float16, compute_dtype=jnp.float16,
               use_flash_attention=False)
    t16 = dict(param_dtype=F16, compute_dtype=F16)
    if family == "llama":
        cfg = cfg or MHA128
        jmodel = JLlamaLMHeadModel(JLlamaConfig.tiny(remat=False, **f16,
                                                     **cfg))
        tcls, tcfg = LlamaLMHeadModel, LlamaConfig.tiny(**t16, **cfg)
    else:
        jmodel = JGPTLMHeadModel(JGPTConfig.tiny(**f16, **GPT128))
        tcls, tcfg = GPTLMHeadModel, GPTConfig.tiny(**t16, **GPT128)
    jparams = _reference_params(jmodel, seed)
    tmodel = tcls(tcfg, device="cpu")
    load_jax_params(tmodel, jax.tree_util.tree_map(np.asarray, jparams))
    return jmodel, jparams, tmodel


@pytest.fixture(scope="module")
def pairs():
    return {family: _fp16_pair(family) for family in ("llama", "gpt")}


@pytest.mark.parametrize("family", ["llama", "gpt"])
def test_load_jax_params_fp16_forward_matches_reference(pairs, family):
    """Every parameter fp16 and bit for bit the reference's; the logits
    of a batch within 2e-2 of the reference's fp16 forward (fp16
    activations, each product rounded in its own order)."""
    jmodel, jparams, tmodel = pairs[family]
    assert all(p.dtype == F16 for p in tmodel.parameters())
    ids = np.random.default_rng(4).integers(
        0, tmodel.config.vocab_size, (2, 16)).astype(np.int32)
    ref = np.asarray(jax.jit(jmodel.apply)(jparams, jnp.asarray(ids)),
                     np.float32)
    with torch.no_grad():
        out = tmodel(torch.from_numpy(ids).long())
    assert out.dtype == F16
    np.testing.assert_allclose(out.float().numpy(), ref, atol=2e-2)


def _requests(pkg, vocab):
    """4 requests, the odd ones seeded-sampled, prompts with repeats for
    the n-gram drafter (tests/test_torch_spec.py's trace)."""
    rng = np.random.default_rng(21)
    out = []
    for i in range(4):
        base = rng.integers(0, vocab, 5)
        prompt = np.concatenate([base, base[:3], rng.integers(0, vocab, 4),
                                 base[:2]]).astype(np.int32)
        sp = pkg.GREEDY
        if i % 2:
            sp = pkg.SamplingParams(temperature=0.9, top_k=40, top_p=0.9,
                                    seed=70 + i)
        out.append(pkg.Request(rid=i, prompt=prompt[: 8 + 2 * i],
                               max_new_tokens=6, sampling=sp,
                               arrival_t=0.01 * i))
    return out


def _same_tokens_and_drafts(tres, jres, n_new):
    for t, j in zip(tres, jres):
        assert t.tokens == j.tokens, f"request {t.rid} diverged"
        assert len(t.tokens) == n_new
        assert (t.stats.spec_proposed, t.stats.spec_accepted) == \
            (j.stats.spec_proposed, j.stats.spec_accepted), t.rid


def test_fp16_engine_matches_reference(pairs):
    """The engine serves the fp16 Llama (Llama-2's attention) with n-gram
    speculation on int8 pages of fp16 K and V, greedy and seeded-sampled
    requests side by side: the reference engine's tokens and speculation
    counts, drafts accepted, every page back."""
    jmodel, jparams, tmodel = pairs["llama"]
    cfg = dict(ENGINE, sampling=True, spec_decode="ngram", spec_k=3,
               kv_quant="int8")
    jeng = jserving.ServingEngine(jmodel, jparams,
                                  jserving.ServeConfig(**cfg),
                                  registry=JMetricsRegistry())
    teng = tserving.ServingEngine(tmodel, tserving.ServeConfig(**cfg),
                                  device="cpu").warmup()
    assert teng.pool.k.dtype == torch.int8
    assert all(t.dtype == F16 for t in teng._new_scratch())
    vocab = tmodel.config.vocab_size
    tres = teng.run(_requests(tserving, vocab))
    _same_tokens_and_drafts(tres, jeng.run(_requests(jserving, vocab)), 6)
    teng.scheduler.check_invariants()
    assert teng.pool.free_count == teng.pool.num_pages
    assert sum(r.stats.spec_accepted for r in tres) > 0


#: the reference's test draft model (test_serving_decode.py `_draft_llama`)
DRAFT = dict(vocab_size=256, hidden_size=32, intermediate_size=64,
             num_hidden_layers=1, num_attention_heads=2,
             num_key_value_heads=1)


def test_fp16_model_drafter_with_prefix_cache_matches_reference(pairs):
    """spec_decode='model' with an fp16 Llama draft (resident int8, its
    working copy dequantized straight to fp16) drafting for the fp16 GPT
    with its tied head, the prefix cache on fp16 exact pages: greedy
    requests and requests sampled at temperature 0.9 (the stochastic p/q
    rule over the draft's fp16 proposals) give the reference engine's
    tokens, drafts proposed and accepted, and prefix hits (one per
    request after the first)."""
    jmodel, jparams, tmodel = pairs["gpt"]
    jdraft, jdparams, tdraft = _fp16_pair("llama", seed=7, **DRAFT)
    vocab = tmodel.config.vocab_size
    sysp = np.random.default_rng(2).integers(0, vocab, 16).astype(np.int32)

    def trace(pkg):
        r = np.random.default_rng(3)
        return [pkg.Request(
            rid=i, prompt=np.concatenate(
                [sysp, r.integers(0, vocab, 5).astype(np.int32)]),
            max_new_tokens=6, arrival_t=100.0 * i,
            sampling=(pkg.SamplingParams(temperature=0.9, seed=40 + i)
                      if i % 2 else pkg.GREEDY))
            for i in range(4)]
    cfg = dict(ENGINE, sampling=True, spec_decode="model", spec_k=2,
               prefix_cache=True)
    jreg = JMetricsRegistry()
    # a window shorter than the prompts: the reference compiles its draft
    # forward once per context length
    jeng = jserving.ServingEngine(
        jmodel, jparams, jserving.ServeConfig(**cfg), registry=jreg,
        drafter=jspec.ModelDrafter(jdraft, jdparams, window=8))
    teng = tserving.ServingEngine(
        tmodel, tserving.ServeConfig(**cfg), device="cpu",
        drafter=tspec.ModelDrafter(tdraft, window=8)).warmup()
    assert teng.spec_stochastic and teng.pool.k.dtype == F16
    copy = tspec._dequantize_resident(teng.drafter.params_q,
                                      teng.drafter._spec)
    assert {copy[name].dtype for name in teng.drafter._spec} == {F16}
    tres = teng.run(trace(tserving))
    _same_tokens_and_drafts(tres, jeng.run(trace(jserving)), 6)
    teng.scheduler.check_invariants()
    assert teng.registry.counter_value("serve.prefix_hits") == \
        jreg.counter_value("serve.prefix_hits") == 3
    assert sum(r.stats.spec_accepted for r in tres[1::2]) > 0
