"""The port's sampling and quantization pieces against the JAX
reference, on the CPU.

Seeded sampling (hetu_tpu_torch/serving/sampling.py and the plain
versions of ops/cuda/sample.py): the key words of fold_in(key(seed),
position) and the counter hash are bit-identical to JAX's; the Gumbel
noise agrees to the rounding of `log` (XLA's CPU log and PyTorch's are
different approximations, a few fp32 ulps apart), so the tokens drawn
are identical on inputs without near-ties, including greedy ties and
disabled filters.  The fused sampler's plain version is held against
the Pallas `fused_sample` in interpret mode.  Quantization
(ops/cuda/quant.py, ops/quantization.py, serving/kv_pool.py): payloads
identical, scales within rtol 1e-7 of the reference's XLA path and
within one fp32 ulp of its Pallas kernel in interpret mode (the bound
the reference holds its kernel to: XLA may divide by qmax as a multiply
by its reciprocal).
"""
from __future__ import annotations

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from hetu_tpu.comm import compress as jcompress
from hetu_tpu.ops import quantization as jquant
from hetu_tpu.ops.pallas import sample as jpsample
from hetu_tpu.serving import kv_pool as jkv_pool
from hetu_tpu.serving import sampling as jsampling
from hetu_tpu_torch.ops import quantization as tquant
from hetu_tpu_torch.ops.cuda import quant as tq
from hetu_tpu_torch.ops.cuda import sample as tsample
from hetu_tpu_torch.serving import kv_pool as tkv_pool
from hetu_tpu_torch.serving import sampling as tsampling

_PALLAS = "paged_attn,paged_verify,sample,quant"


@pytest.fixture
def pallas(monkeypatch):
    """Route the reference through its Pallas kernels (interpret mode on
    the CPU), as tests/test_serving_decode.py does."""
    monkeypatch.setenv("HETU_TPU_PALLAS", "1")
    monkeypatch.setenv("HETU_TPU_PALLAS_KERNELS", _PALLAS)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------- the keys
def test_key_words_are_jax_fold_in_bit_for_bit():
    rng = np.random.default_rng(0)
    seeds = np.concatenate([rng.integers(0, 2 ** 32, 300, dtype=np.uint64),
                            [0, 1, 2 ** 31, 2 ** 32 - 1]]).astype(np.uint32)
    pos = np.concatenate([rng.integers(0, 2 ** 31, 300),
                          [0, 1, 2 ** 31 - 1, 2 ** 31 + 3]]).astype(np.uint32)
    ref = np.asarray(jsampling.key_words(jnp.asarray(seeds),
                                         jnp.asarray(pos)))
    out = tsampling.key_words(_t(seeds.astype(np.int64)),
                              _t(pos.astype(np.int64)))
    np.testing.assert_array_equal(out.numpy(), ref.astype(np.int64))


def _words(n, seed=1):
    rng = np.random.default_rng(seed)
    seeds = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    pos = rng.integers(0, 4096, n).astype(np.uint32)
    return np.asarray(jsampling.key_words(jnp.asarray(seeds),
                                          jnp.asarray(pos)))


@pytest.mark.parametrize("lane", [0, 1, 2])
def test_hash_uniform_is_bit_exact(lane):
    w = _words(16)
    idx = np.arange(4000, dtype=np.uint32)
    ref = np.asarray(jpsample.hash_uniform(
        jnp.asarray(w[:, :1]), jnp.asarray(w[:, 1:]), jnp.asarray(idx)[None],
        lane))
    wt = _t(w.astype(np.int64))
    out = tsample.hash_uniform(wt[:, :1], wt[:, 1:],
                               _t(idx.astype(np.int64))[None], lane)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_gumbel_agrees_to_the_rounding_of_log():
    w = _words(16, seed=2)
    idx = np.arange(4000, dtype=np.uint32)
    ref = np.asarray(jpsample.gumbel(jnp.asarray(w[:, :1]),
                                     jnp.asarray(w[:, 1:]),
                                     jnp.asarray(idx)[None]))
    wt = _t(w.astype(np.int64))
    out = tsample.gumbel(wt[:, :1], wt[:, 1:],
                         _t(idx.astype(np.int64))[None]).numpy()
    # the same uniforms through two fp32 log implementations: a few
    # ulps of the largest noise (|g| < 18)
    np.testing.assert_allclose(out, ref, rtol=0, atol=4e-6)


# -------------------------------------------------------------- filters
def _sampling_case(V=256, seed=5):
    """Rows covering greedy, temperature only, top-k, top-p, both, and
    the disabled settings (k = 0, k >= V, p = 0, p = 1); ties at the top
    of two rows (the first index wins) and duplicated values at the
    top-k boundary of another."""
    R = 12
    rng = np.random.default_rng(seed)
    logits = (3.0 * rng.standard_normal((R, V))).astype(np.float32)
    logits[0, [7, 40]] = logits[0].max() + 1.0       # greedy tie
    logits[3, [5, 9, 11]] = logits[3].max() + 0.5    # sampled tie at top
    top = np.sort(logits[4])[::-1]
    logits[4, np.argsort(logits[4])[-12:-9]] = top[10]  # dups at k = 10
    temps = np.array([0, 1.0, 0.7, 0.8, 1.0, 1.3, 0.9, 1.0, 1.0, 1.0, 0.0,
                      2.0], np.float32)
    top_ks = np.array([0, 0, 20, 5, 10, 0, 30, 0, V, 1, 7, 3],
                      np.int32)
    top_ps = np.array([0, 0, 0, 0.9, 0, 0.8, 0.95, 1.0, 0.5, 0.3, 0.9,
                       0.0], np.float32)
    seeds = rng.integers(0, 2 ** 32, R, dtype=np.uint64).astype(np.uint32)
    positions = rng.integers(0, 2000, R).astype(np.int32)
    return logits, seeds, positions, temps, top_ks, top_ps


def test_filtered_logits_match_reference():
    logits, _, _, temps, top_ks, top_ps = _sampling_case()
    ref = np.asarray(jsampling.filtered_logits(
        jnp.asarray(logits), jnp.asarray(temps), jnp.asarray(top_ks),
        jnp.asarray(top_ps)))
    out = tsample.filtered_logits(_t(logits), _t(temps), _t(top_ks),
                                  _t(top_ps)).numpy()
    np.testing.assert_array_equal(out <= -1e29, ref <= -1e29)
    np.testing.assert_allclose(out, ref, rtol=1e-6)


def test_sample_tokens_match_reference():
    logits, seeds, positions, temps, top_ks, top_ps = _sampling_case()
    ref = np.asarray(jsampling.sample_tokens(
        jnp.asarray(logits), jnp.asarray(seeds), jnp.asarray(positions),
        jnp.asarray(temps), jnp.asarray(top_ks), jnp.asarray(top_ps)))
    out = tsampling.sample_tokens(
        _t(logits), _t(seeds.astype(np.int64)), _t(positions), _t(temps),
        _t(top_ks), _t(top_ps), device="cpu")
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)
    assert out[0] == 7                 # greedy: the first of a tie


def test_sampled_rows_differ_from_greedy_and_replay():
    """The draw is a pure function of (seed, position): the same keys
    replay the same tokens, other positions draw others."""
    logits, seeds, positions = _sampling_case()[:3]
    temps = np.ones(12, np.float32)
    args = [_t(logits), _t(seeds.astype(np.int64)), _t(positions),
            _t(temps), _t(np.zeros(12, np.int32)),
            _t(np.zeros(12, np.float32))]
    a = tsampling.sample_tokens(*args, device="cpu")
    assert torch.equal(a, tsampling.sample_tokens(*args, device="cpu"))
    args[2] = args[2] + 1
    b = tsampling.sample_tokens(*args, device="cpu")
    greedy = torch.argmax(_t(logits), dim=-1).int()
    assert not torch.equal(a, b) and not torch.equal(a, greedy)


def test_fused_sample_matches_pallas_kernel(pallas):
    """The fused epilogue's plain version (fp32 product + the sort-based
    sampler) against the Pallas `fused_sample` (its bisection filters)
    in interpret mode."""
    _, seeds, positions, temps, top_ks, top_ps = _sampling_case()
    rng = np.random.default_rng(9)
    R, H, V = 12, 128, 256
    hidden = rng.standard_normal((R, H)).astype(np.float32)
    w = (0.3 * rng.standard_normal((H, V))).astype(np.float32)
    words = np.asarray(jsampling.key_words(jnp.asarray(seeds),
                                           jnp.asarray(positions)))
    ref = np.asarray(jpsample.fused_sample(
        jnp.asarray(hidden), jnp.asarray(w), jnp.asarray(words),
        jnp.asarray(temps), jnp.asarray(top_ks), jnp.asarray(top_ps)))
    out = tsample.fused_sample(_t(hidden), _t(w), _t(words.astype(np.int64)),
                               _t(temps), _t(top_ks), _t(top_ps),
                               device="cpu")
    np.testing.assert_array_equal(out.numpy(), ref)
    grid = tsampling.sample_hidden_grid(
        _t(hidden).reshape(4, 3, H), _t(w), _t(seeds[:4].astype(np.int64)),
        _t(positions).reshape(4, 3), _t(temps[:4]), _t(top_ks[:4]),
        _t(top_ps[:4]), device="cpu")
    ref_grid = np.asarray(jsampling.sample_hidden_grid(
        jnp.asarray(hidden).reshape(4, 3, H), jnp.asarray(w),
        jnp.asarray(seeds[:4]), jnp.asarray(positions).reshape(4, 3),
        jnp.asarray(temps[:4]), jnp.asarray(top_ks[:4]),
        jnp.asarray(top_ps[:4])))
    np.testing.assert_array_equal(grid.numpy(), ref_grid)


@pytest.mark.parametrize("V", [256, 1001])
def test_fused_sample_over_a_tied_table_matches_the_reference(monkeypatch,
                                                              V):
    """The port's fused sampler over a tied head, the transposed view
    `table.t()` of a [V, H] table (as `lm_head_weight()` returns GPT's
    `wte`), against the reference's `sample_hidden` over the same head:
    its Pallas `fused_sample` in interpret mode at V = 256; at the ragged
    V = 1001, which the Pallas kernel refuses (V % 128), the route the
    reference itself takes off the TPU (the fp32 product, then its
    sampler).  The view and its contiguous copy give the same tokens."""
    if V % 128 == 0:
        monkeypatch.setenv("HETU_TPU_PALLAS", "1")
        monkeypatch.setenv("HETU_TPU_PALLAS_KERNELS", _PALLAS)
    _, seeds, positions, temps, top_ks, top_ps = _sampling_case()
    rng = np.random.default_rng(11)
    R, H = 12, 128
    hidden = rng.standard_normal((R, H)).astype(np.float32)
    table = (0.3 * rng.standard_normal((V, H))).astype(np.float32)
    assert jpsample.compatible((R, H), (H, V)) == (V % 128 == 0)
    ref = np.asarray(jsampling.sample_hidden(
        jnp.asarray(hidden), jnp.asarray(table).T, jnp.asarray(seeds),
        jnp.asarray(positions), jnp.asarray(temps), jnp.asarray(top_ks),
        jnp.asarray(top_ps)))
    words = _t(np.asarray(jsampling.key_words(
        jnp.asarray(seeds), jnp.asarray(positions))).astype(np.int64))
    head = _t(table).t()
    assert head.shape == (H, V) and head.stride() == (1, H)
    args = (words, _t(temps), _t(top_ks), _t(top_ps))
    out = tsample.fused_sample(_t(hidden), head, *args, device="cpu")
    np.testing.assert_array_equal(out.numpy(), ref)
    dense = tsample.fused_sample(_t(hidden), head.contiguous(), *args,
                                 device="cpu")
    assert torch.equal(out, dense)


def _head(layout, dtype=torch.bfloat16, H=64, V=1001):
    """A head [H, V] in one of the layouts the product meets."""
    if layout == "table_t":        # a tied [V, H] table's transposed view
        return torch.zeros((V, H), dtype=dtype).t()
    if layout == "dense":          # an untied [H, V] parameter
        return torch.zeros((H, V), dtype=dtype)
    if layout == "padded":         # rows of whole 16-byte runs, V ragged
        return torch.zeros((H, (V + 7) // 8 * 8), dtype=dtype)[:, :V]
    if layout == "col_strided":    # neither stride is 1
        return torch.zeros((H, 2 * V), dtype=dtype)[:, ::2]
    if layout == "off_16_bytes":   # a table view one element in
        return torch.zeros(V * H + 1, dtype=dtype)[1:].view(V, H).t()
    raise ValueError(layout)


@pytest.mark.parametrize("layout,V,dtype,H,arm", [
    ("table_t", 50257, torch.bfloat16, 1280, "k_major"),   # GPT's wte.t()
    ("table_t", 1001, torch.bfloat16, 64, "k_major"),
    ("dense", 128256, torch.bfloat16, 64, "n_major"),      # Llama's head
    ("padded", 1001, torch.bfloat16, 64, "n_major"),
    ("dense", 1001, torch.bfloat16, 64, "fma"),    # rows off 16-byte runs
    ("col_strided", 1000, torch.bfloat16, 64, "fma"),
    ("off_16_bytes", 1001, torch.bfloat16, 64, "fma"),
    ("table_t", 1001, torch.bfloat16, 60, "fma"),  # H not a multiple of 8
    ("table_t", 1001, torch.float32, 64, "fma"),
    ("dense", 1000, torch.float32, 64, "fma")])
def test_lm_head_route_by_layout(layout, V, dtype, H, arm):
    """The product's arm follows dtype, strides and alignment alone: the
    tensor cores take both layouts of a bf16 head that the port's models
    pass (an untied [H, V] head, a tied table's `.t()`, ragged V), the
    FMAs only fp32 and strides neither layout covers."""
    head = _head(layout, dtype, H, V)
    assert head.shape == (H, V)
    hidden = torch.zeros((8, H), dtype=dtype)
    assert tsample.lm_head_route(hidden, head) == arm


def _words_with_infinite_noise(idx, w0=0x12345678):
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


def test_filtered_entry_with_infinite_noise_wins_like_the_reference(pallas):
    """A filtered entry (-1e30) whose noise is +inf is +inf in the
    reference's argmax and wins it: rows with top-k, top-p and both
    filtering the row's smallest logit, and a row keeping it."""
    rng = np.random.default_rng(13)
    R, H, V = 4, 128, 256
    hidden = rng.standard_normal((R, H)).astype(np.float32)
    w = (0.3 * rng.standard_normal((H, V))).astype(np.float32)
    target = (hidden @ w).argmin(axis=-1)
    words = np.array([_words_with_infinite_noise(int(t), 17 * r + 1)
                      for r, t in enumerate(target)], np.uint32)
    hash_ = tsample.hash_uniform(_t(words[:, :1].astype(np.int64)),
                                 _t(words[:, 1:].astype(np.int64)),
                                 _t(target.astype(np.int64))[:, None])
    assert bool((hash_ == 1.0).all())
    temps = np.array([1.0, 0.8, 0.9, 1.0], np.float32)
    top_ks = np.array([5, 0, 20, 0], np.int32)
    top_ps = np.array([0.0, 0.5, 0.9, 0.0], np.float32)
    ref = np.asarray(jpsample.fused_sample(
        jnp.asarray(hidden), jnp.asarray(w), jnp.asarray(words),
        jnp.asarray(temps), jnp.asarray(top_ks), jnp.asarray(top_ps)))
    out = tsample.fused_sample(_t(hidden), _t(w), _t(words.astype(np.int64)),
                               _t(temps), _t(top_ks), _t(top_ps),
                               device="cpu")
    np.testing.assert_array_equal(ref, target)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_sample_token_grid_matches_reference():
    logits, seeds, positions, temps, top_ks, top_ps = _sampling_case()
    lg = logits.reshape(4, 3, -1)
    ref = np.asarray(jsampling.sample_token_grid(
        jnp.asarray(lg), jnp.asarray(seeds[:4]),
        jnp.asarray(positions).reshape(4, 3), jnp.asarray(temps[:4]),
        jnp.asarray(top_ks[:4]), jnp.asarray(top_ps[:4])))
    out = tsampling.sample_token_grid(
        _t(lg), _t(seeds[:4].astype(np.int64)), _t(positions).reshape(4, 3),
        _t(temps[:4]), _t(top_ks[:4]), _t(top_ps[:4]), device="cpu")
    np.testing.assert_array_equal(out.numpy(), ref)


def test_sampler_wrappers_count_no_cpu_launch():
    logits, seeds, positions, temps, top_ks, top_ps = _sampling_case()
    before = (tsample.launches, tsample.logits_launches)
    tsampling.sample_tokens(_t(logits), _t(seeds.astype(np.int64)),
                            _t(positions), _t(temps), _t(top_ks),
                            _t(top_ps), device="cpu")
    assert (tsample.launches, tsample.logits_launches) == before
    with pytest.raises(ValueError):
        tsample.sample_logits(_t(logits), torch.zeros(3, 2, dtype=torch.long),
                              _t(temps), _t(top_ks), _t(top_ps),
                              device="cpu")


# --------------------------------------------------------- quantization
def _blocks(seed=0, n=512, bs=128):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, bs)).astype(np.float32)
    x *= rng.exponential(size=(n, 1)).astype(np.float32)
    x[3] = 0.0                                   # an all-zero block
    x[5, :7] = np.float32(0.5) * x[5].max() / 127 * 127   # near .5 steps
    return x


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("route", ["xla", "pallas"])
def test_quantize_blockwise_matches_reference(bits, route, monkeypatch):
    if route == "pallas":
        monkeypatch.setenv("HETU_TPU_PALLAS", "1")
        monkeypatch.setenv("HETU_TPU_PALLAS_KERNELS", "quant")
    x = _blocks(bits)
    jq, js = jcompress.quantize_blockwise(jnp.asarray(x.reshape(-1)), 128,
                                          bits=bits)
    tq_, ts = tq.quantize_blockwise(_t(x), 128, bits=bits, device="cpu")
    assert tq_.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq_.numpy(), np.asarray(jq))
    if route == "xla":
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-7)
    else:   # the reference holds its kernel to the XLA path within 1 ulp
        np.testing.assert_array_max_ulp(ts.numpy(), np.asarray(js), maxulp=1)


def test_quantize_blockwise_bf16_input_is_its_fp32_widening():
    x = torch.from_numpy(_blocks(3)).bfloat16()
    a = tq.quantize_blockwise(x, 128, device="cpu")
    b = tq.quantize_blockwise(x.float(), 128, device="cpu")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_quantize_blockwise_refuses_what_it_does_not_take():
    with pytest.raises(ValueError):
        tq.quantize_blockwise(torch.zeros(100), 128, device="cpu")
    with pytest.raises(ValueError):
        tq.quantize_blockwise(torch.zeros(128), 128, bits=2, device="cpu")
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        tq.quantize_blockwise(torch.zeros(128), 128, stochastic=True,
                              device="cpu")


def test_nibble_packing_matches_reference():
    rng = np.random.default_rng(4)
    u = rng.integers(0, 16, (6, 64)).astype(np.uint8)
    ref = np.asarray(jquant.pack_nibbles(jnp.asarray(u), even_high=False))
    out = tquant.pack_nibbles(_t(u))
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(tquant.unpack_nibbles(out).numpy(), u)
    x = _blocks(6, n=64, bs=64)
    jp, js = jquant.quantize_int4(jnp.asarray(x), block_size=64)
    tp, ts = tquant.quantize_int4(_t(x), block_size=64)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-7)
    np.testing.assert_array_equal(
        tquant.dequantize_int4(tp, ts, x.shape).numpy(),
        np.asarray(jquant.dequantize_int4(jp, js, x.shape)))


@pytest.mark.parametrize("bits", [8, 4])
def test_head_vector_quantization_matches_the_pool(bits):
    x = _blocks(7, n=2 * 5 * 3, bs=128).reshape(2, 5, 3, 128)
    jq, js = jkv_pool.quantize_heads(jnp.asarray(x), bits)
    tq_, ts = tkv_pool.quantize_heads(_t(x), bits)
    np.testing.assert_array_equal(tq_.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-7)
    np.testing.assert_allclose(
        tquant.dequantize_heads(tq_, ts, bits).numpy(),
        np.asarray(jkv_pool.dequantize_heads(jq, js, bits)), rtol=1e-7)
    for mode in ("fp32", "bf16", "int8", "int4"):
        assert tkv_pool.kv_bytes_per_token(32, 8, 128, mode) == \
            jkv_pool.kv_bytes_per_token(32, 8, 128, mode)
