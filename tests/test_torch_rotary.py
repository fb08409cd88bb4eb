"""RoPE read in place from the fused QKV projection, against the JAX
reference, on the CPU.

The LLaMA attention hands `fused_rotary_qk` the slices of its fused
projection qkv [b, s, n_kv, group+2, hd] that `LlamaAttention.split`
yields — q as the grouped view [b, s, n_kv, group, hd], k as [b, s,
n_kv, hd], neither copied.  Here the wrapper runs its plain
version on those views (the CUDA kernel reads the same strides on the
card: tests/test_torch_cuda.py), and the JAX side runs its Pallas kernel
in interpret mode on q reshaped to [b, s, nq, hd], as the reference's
attention does.  Inputs are seeded numpy arrays handed to both.
Tolerances: 1e-5 per op in fp32, one bf16 ulp for bf16 outputs rounded
once, 1e-4 across an attention block, a decode step and a prefill chunk
(docs/kernels.md).
"""
from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from hetu_tpu import ops as jops
from hetu_tpu.models import generation as jgen
from hetu_tpu.ops.pallas import rotary as jrotary
from hetu_tpu_torch.models import generation as tgen
from hetu_tpu_torch.models.llama import LlamaConfig
from hetu_tpu_torch.models.llama.model import LlamaAttention
from hetu_tpu_torch.ops import rotary
from hetu_tpu_torch.ops.cuda import rotary as trotary

from test_torch_kernels import _bf16_close
from test_torch_parity import MODEL_TOL, jax_llama_and_port

FWD_TOL = 1e-5

#: GQA with two kv heads of 128 (the reference's paged kernel takes head
#: dim 128), so k's slice is strided across heads as well as rows
GQA128 = dict(hidden_size=512, num_attention_heads=4, num_key_value_heads=2,
              intermediate_size=512)


def _qkv_case(seed, b, s, n_kv, group, hd):
    """A fused projection qkv [b, s, n_kv, group+2, hd], RoPE positions
    and their rows: (qkv, pos, cos_t, sin_t) as numpy."""
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((b, s, n_kv, group + 2, hd)).astype(np.float32)
    pos = rng.integers(0, 64, size=(b, s)).astype(np.int32)
    cos, sin = jops.build_rope_cache(64, hd, 10000.0)
    return qkv, pos, np.asarray(cos)[pos], np.asarray(sin)[pos]


def _jax_rotate(q, k, pos, cos_t, sin_t):
    """The reference's RoPE on q and k: its Pallas kernel where the head
    dim is lane-aligned (% 128), else the composition its dispatcher
    routes there."""
    hd = q.shape[-1]
    if hd % 128 == 0:
        return jrotary.fused_rotary_qk(q, k, jnp.asarray(cos_t),
                                       jnp.asarray(sin_t))
    cos, sin = jops.build_rope_cache(64, hd, 10000.0)
    return jops.apply_rotary_qk(q, k, cos, sin, jnp.asarray(pos),
                                use_pallas=False)


def _split(qkv: torch.Tensor, n_kv: int, group: int, hd: int):
    """The port's attention's own split of qkv into views."""
    cfg = LlamaConfig.tiny(hidden_size=n_kv * group * hd,
                           num_attention_heads=n_kv * group,
                           num_key_value_heads=n_kv)
    return LlamaAttention(cfg, "cpu").split(qkv)


def _jax_qk(qkv, group):
    """The reference attention's q [b, s, nq, hd] and k of qkv."""
    b, s, n_kv, _, hd = qkv.shape
    return (qkv[..., :group, :].reshape(b, s, n_kv * group, hd),
            qkv[..., group, :])


@pytest.mark.parametrize("b,s,n_kv,group,hd", [(2, 5, 2, 4, 128),
                                               (1, 7, 1, 2, 64),
                                               (3, 4, 2, 1, 36)])
def test_split_views_match_reference(b, s, n_kv, group, hd):
    qkv, pos, cos_t, sin_t = _qkv_case(0, b, s, n_kv, group, hd)
    q, k, _ = _split(torch.from_numpy(qkv), n_kv, group, hd)
    assert q.shape == (b, s, n_kv, group, hd) and not q.is_contiguous()
    assert not k.is_contiguous()
    assert k.data_ptr() - q.data_ptr() == group * hd * 4   # views of qkv
    tq, tk = trotary.fused_rotary_qk(q, k, torch.from_numpy(cos_t),
                                     torch.from_numpy(sin_t), device="cpu")
    assert tq.shape == (b, s, n_kv * group, hd) and tq.is_contiguous()
    jq, jk = _jax_rotate(*map(jnp.asarray, _jax_qk(qkv, group)), pos, cos_t,
                         sin_t)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=FWD_TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=FWD_TOL)


def test_split_views_bf16_match_pallas_kernel():
    qkv, pos, cos_t, sin_t = _qkv_case(1, 2, 6, 2, 4, 128)
    q, k, _ = _split(torch.from_numpy(qkv).bfloat16(), 2, 4, 128)
    tq, tk = trotary.fused_rotary_qk(q, k, torch.from_numpy(cos_t),
                                     torch.from_numpy(sin_t), device="cpu")
    jq, jk = _jax_rotate(
        *(jnp.asarray(t, jnp.bfloat16) for t in _jax_qk(qkv, 4)), pos,
        cos_t, sin_t)
    _bf16_close(tq, jq)
    _bf16_close(tk, jk)


@pytest.mark.parametrize("group", [1, 4])
def test_split_views_gradient_matches_pallas_vjp(group):
    """The gradient of qkv through the strided views: the Function
    returns dq in the grouped view's shape, and autograd's slice
    backward scatters it into qkv's gradient (v's slice stays zero) —
    against `jax.vjp` of the Pallas kernel's custom VJP on the same
    cotangents."""
    b, s, n_kv, hd = 2, 5, 2, 128
    qkv, pos, cos_t, sin_t = _qkv_case(2, b, s, n_kv, group, hd)
    rng = np.random.default_rng(3)
    dq = rng.standard_normal((b, s, n_kv * group, hd)).astype(np.float32)
    dk = rng.standard_normal((b, s, n_kv, hd)).astype(np.float32)
    tqkv = torch.from_numpy(qkv).requires_grad_(True)
    q, k, _ = _split(tqkv, n_kv, group, hd)
    tq, tk = trotary.fused_rotary_qk(q, k, torch.from_numpy(cos_t),
                                     torch.from_numpy(sin_t), device="cpu")
    torch.autograd.backward((tq, tk), (torch.from_numpy(dq),
                                       torch.from_numpy(dk)))
    _, vjp = jax.vjp(lambda x: _jax_rotate(*_jax_qk(x, group), pos, cos_t,
                                           sin_t), jnp.asarray(qkv))
    (jgrad,) = vjp((jnp.asarray(dq), jnp.asarray(dk)))
    np.testing.assert_allclose(tqkv.grad.numpy(), np.asarray(jgrad),
                               atol=FWD_TOL)
    assert not tqkv.grad[..., group + 1, :].any()


@pytest.fixture(scope="module")
def gqa_pair():
    return jax_llama_and_port(seed=5, **GQA128)


def test_attention_block_matches_reference(gqa_pair):
    """One attention block (fused projection, RoPE on its views, causal
    attention, o_proj) and its input gradient against the reference's
    `LlamaAttention` with the same layer-0 weights."""
    jmodel, jparams, tmodel = gqa_pair
    c = tmodel.config
    jattn = jmodel.model.layers.block.attn
    jp = jax.tree_util.tree_map(
        lambda a: a[0], jparams["model"]["layers"]["layers"]["attn"])
    b, s = 2, 9
    x = np.random.default_rng(6).standard_normal(
        (b, s, c.hidden_size)).astype(np.float32)
    dy = np.random.default_rng(7).standard_normal(
        (b, s, c.hidden_size)).astype(np.float32)
    jc, js = jops.build_rope_cache(c.max_position_embeddings, c.head_dim,
                                   c.rope_theta)

    def jfwd(xx):
        return jattn(jp, xx, cos=jc, sin=js)
    jy, vjp = jax.vjp(jfwd, jnp.asarray(x))
    (jdx,) = vjp(jnp.asarray(dy))
    tc, ts = rotary.build_rope_cache(c.max_position_embeddings, c.head_dim,
                                     c.rope_theta)
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = tmodel.model.layers[0].attn(tx, *rotary.rope_tables(tc, ts, b, s))
    ty.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               atol=MODEL_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx),
                               atol=MODEL_TOL)


def test_decode_step_paged_matches_reference_gqa(gqa_pair):
    """A paged decode step (RoPE on `serve_qkv`'s views) with two kv
    heads: logits and the written pools against the reference's
    `decode_step_paged` (its Pallas kernel in interpret mode)."""
    jmodel, jparams, tmodel = gqa_pair
    c = tmodel.config
    rng = np.random.default_rng(8)
    S, P, ps = 3, 7, 8
    shape = (c.num_hidden_layers, P, ps, c.num_key_value_heads, c.head_dim)
    kp = rng.standard_normal(shape).astype(np.float32)
    vp = rng.standard_normal(shape).astype(np.float32)
    table = np.array([[1, 2, 3], [4, 0, 0], [5, 6, 0]], np.int32)
    positions = np.array([19, 3, 12], np.int32)
    tokens = rng.integers(0, c.vocab_size, size=S).astype(np.int32)
    jl, jk, jv = jgen.decode_step_paged(
        jmodel, jparams, jnp.asarray(tokens), jnp.asarray(kp),
        jnp.asarray(vp), jnp.asarray(table), jnp.asarray(positions))
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    tl, _, _ = tgen.decode_step_paged(
        tmodel, torch.as_tensor(tokens), tk, tv, torch.as_tensor(table),
        torch.as_tensor(positions))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=MODEL_TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=MODEL_TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=MODEL_TOL)


def test_extend_cache_matches_reference_gqa(gqa_pair):
    """A prefill chunk at a nonzero start (RoPE on `serve_qkv`'s views):
    logits and the written cache against the reference's
    `extend_cache`."""
    jmodel, jparams, tmodel = gqa_pair
    c = tmodel.config
    rng = np.random.default_rng(9)
    shape = (c.num_hidden_layers, 1, 24, c.num_key_value_heads, c.head_dim)
    cache = rng.standard_normal(shape).astype(np.float32)
    ids = rng.integers(0, c.vocab_size, size=(1, 8)).astype(np.int32)
    jl, jcache = jgen.extend_cache(jmodel, jparams, jnp.asarray(ids),
                                   (jnp.asarray(cache), jnp.asarray(cache)),
                                   5)
    tl, tcache = tgen.extend_cache(
        tmodel, torch.as_tensor(ids),
        (torch.from_numpy(cache.copy()), torch.from_numpy(cache.copy())), 5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=MODEL_TOL)
    for t, j in zip(tcache, jcache):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=MODEL_TOL)
