"""Parity of the PyTorch port (hetu_tpu_torch) with the JAX reference at
the model level, on the CPU.

`jax_llama_and_port` is the one conversion path every test_torch_*.py
file uses: it builds a JAX Llama, draws its params from a seed, turns
them into numpy and loads them into the port with `load_jax_params`.
Inputs are numpy arrays made from a seed and handed to both packages.
Everything runs in float32; the model-level tolerance is 1e-4
(docs/kernels.md: fp32 forward parity 1e-5 per kernel, reassociated
sums across a whole forward a decade looser).
"""
from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from hetu_tpu.models import generation as jgen
from hetu_tpu.models.llama import LlamaConfig as JLlamaConfig
from hetu_tpu.models.llama import LlamaLMHeadModel as JLlamaLMHeadModel
from hetu_tpu_torch.models import generation as tgen
from hetu_tpu_torch.models.llama import (LlamaConfig, LlamaLMHeadModel,
                                         load_jax_params)

MODEL_TOL = 1e-4

#: a config whose head dim (128) the reference's paged kernel accepts,
#: with GQA (two q heads per kv head)
HD128 = dict(hidden_size=256, num_attention_heads=2, num_key_value_heads=1,
             intermediate_size=512)


def jax_llama_and_port(seed: int = 0, **cfg_kw):
    """(JAX model, JAX params, port model on the CPU) sharing one set of
    weights: `LlamaConfig.tiny(**cfg_kw)` in float32 on both sides, the
    params drawn by the reference's own init from `seed`."""
    jcfg = JLlamaConfig.tiny(remat=False, compute_dtype=jnp.float32,
                             use_flash_attention=False, **cfg_kw)
    jmodel = JLlamaLMHeadModel(jcfg)
    jparams = jmodel.init(jax.random.key(seed))
    tmodel = LlamaLMHeadModel(
        LlamaConfig.tiny(compute_dtype=torch.float32, **cfg_kw),
        device="cpu")
    load_jax_params(tmodel, jax.tree_util.tree_map(np.asarray, jparams))
    return jmodel, jparams, tmodel


@pytest.fixture(scope="module")
def hd128_pair():
    return jax_llama_and_port(seed=3, **HD128)


# ---------------------------------------------------------------- weights
def test_load_jax_params_fills_every_parameter(hd128_pair):
    _, jparams, tmodel = hd128_pair
    layers = jparams["model"]["layers"]["layers"]
    for i, layer in enumerate(tmodel.model.layers):
        np.testing.assert_array_equal(
            layer.attn.wqkv.numpy(), np.asarray(layers["attn"]["wqkv"][i]))
        np.testing.assert_array_equal(
            layer.mlp.down_proj.weight.numpy(),
            np.asarray(layers["mlp"]["down_proj"]["weight"][i]))
    np.testing.assert_array_equal(tmodel.lm_head.numpy(),
                                  np.asarray(jparams["lm_head"]))
    np.testing.assert_array_equal(
        tmodel.model.embed.weight.numpy(),
        np.asarray(jparams["model"]["embed"]["weight"]))


@pytest.mark.parametrize("fault", ["missing", "extra", "shape", "layers"])
def test_load_jax_params_refuses_a_mismatched_tree(hd128_pair, fault):
    _, jparams, tmodel = hd128_pair
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    if fault == "missing":
        del tree["lm_head"]
    elif fault == "extra":
        tree["model"]["bias"] = np.zeros(3, np.float32)
    elif fault == "shape":
        tree["model"]["final_norm"]["weight"] = np.ones(7, np.float32)
    else:
        norm = tree["model"]["layers"]["layers"]["input_norm"]
        norm["weight"] = np.concatenate([norm["weight"]] * 2)
    before = tmodel.model.final_norm.weight.clone()
    with pytest.raises(ValueError):
        load_jax_params(tmodel, tree)
    # nothing is filled before the whole tree checks out
    assert torch.equal(tmodel.model.final_norm.weight, before)


def test_tied_embeddings_share_the_table():
    jmodel, jparams, tmodel = jax_llama_and_port(seed=1,
                                                 tie_word_embeddings=True)
    assert not hasattr(tmodel, "lm_head")
    np.testing.assert_array_equal(
        tmodel.lm_head_weight().numpy(),
        np.asarray(jgen.lm_head_weight(jmodel, jparams)))


# ------------------------------------------------------------- forwards
def _chunk_ids(rng, vocab, C):
    return rng.integers(0, vocab, size=(1, C)).astype(np.int32)


def test_extend_cache_matches_reference(hd128_pair):
    """Two consecutive prefill chunks: logits and the written cache
    match the reference's `extend_cache`."""
    jmodel, jparams, tmodel = hd128_pair
    c = tmodel.config
    rng = np.random.default_rng(7)
    L, M, C = c.num_hidden_layers, 32, 8
    shape = (L, 1, M, c.num_key_value_heads, c.head_dim)
    jcache = (jnp.zeros(shape), jnp.zeros(shape))
    tcache = (torch.zeros(shape), torch.zeros(shape))
    for start in (0, C):
        ids = _chunk_ids(rng, c.vocab_size, C)
        jl, jcache = jgen.extend_cache(jmodel, jparams, jnp.asarray(ids),
                                       jcache, start)
        tl, tcache = tgen.extend_cache(tmodel, torch.as_tensor(ids),
                                       tcache, start)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=MODEL_TOL)
    for t, j in zip(tcache, jcache):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=MODEL_TOL)


def _paged_case(c, rng):
    """Three slots at mixed depths plus one inactive slot pinned to the
    null page; pools hold seeded values (page 0 too)."""
    S, ps, mp = 4, 8, 4
    P = 10
    shape = (c.num_hidden_layers, P, ps, c.num_key_value_heads, c.head_dim)
    kp = rng.standard_normal(shape).astype(np.float32)
    vp = rng.standard_normal(shape).astype(np.float32)
    table = np.array([[1, 2, 3, 0], [4, 5, 0, 0], [6, 7, 8, 9],
                      [0, 0, 0, 0]], np.int32)
    positions = np.array([20, 9, 31, 0], np.int32)
    tokens = rng.integers(0, c.vocab_size, size=S).astype(np.int32)
    return tokens, kp, vp, table, positions


def test_decode_step_paged_matches_reference(hd128_pair):
    """The port's gather-free decode (plain paged attention on the CPU)
    against the reference's `decode_step_paged` (its Pallas kernel in
    interpret mode): logits and the written pools."""
    jmodel, jparams, tmodel = hd128_pair
    tokens, kp, vp, table, positions = _paged_case(
        tmodel.config, np.random.default_rng(11))
    jl, jk, jv = jgen.decode_step_paged(
        jmodel, jparams, jnp.asarray(tokens), jnp.asarray(kp),
        jnp.asarray(vp), jnp.asarray(table), jnp.asarray(positions))
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    tl, tk2, tv2 = tgen.decode_step_paged(
        tmodel, torch.as_tensor(tokens), tk, tv, torch.as_tensor(table),
        torch.as_tensor(positions))
    assert tk2 is tk and tv2 is tv          # updated in place
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=MODEL_TOL)
    # real pages match; page 0 takes the inactive row's write on both
    # sides, so it is compared too
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=MODEL_TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=MODEL_TOL)


def test_decode_step_paged_matches_dense_decode(hd128_pair):
    """The same step against the reference's dense-cache decode
    (`decode_step_slots` over the gathered pages) — the program the
    reference engine runs where its paged kernel is not routed."""
    jmodel, jparams, tmodel = hd128_pair
    tokens, kp, vp, table, positions = _paged_case(
        tmodel.config, np.random.default_rng(12))
    dense = lambda pool: jnp.asarray(
        pool[:, table].reshape(pool.shape[0], table.shape[0], -1,
                               *pool.shape[3:]))
    jl, _, _ = jgen.decode_step_slots(
        jmodel, jparams, jnp.asarray(tokens), (dense(kp), dense(vp)),
        jnp.asarray(positions))
    tl, _, _ = tgen.decode_step_paged(
        tmodel, torch.as_tensor(tokens), torch.from_numpy(kp.copy()),
        torch.from_numpy(vp.copy()), torch.as_tensor(table),
        torch.as_tensor(positions))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=MODEL_TOL)


def test_context_length_guard():
    _, _, tmodel = jax_llama_and_port(seed=0)
    with pytest.raises(ValueError):
        tgen._check_context_length(
            tmodel.config, tmodel.config.max_position_embeddings + 1)
