"""The port's HF weight converters (`hetu_tpu_torch/models/{gpt,llama}/
convert.py`) against the reference's, on the CPU.

HF models are initialized at random from a seed, as
tests/test_hf_convert.py does, so nothing is downloaded.  Held: the
port's converted tree equals the reference's array for array (both are
the same regrouping of the same tensors, so exactly); a port model
loaded from it (`load_jax_params`) gives HF's logits at the reference's
own tolerance (2e-3: HF and the port reassociate differently, and GPT-2's
"gelu_new" is the tanh form the port computes); `export_*` returns the
HF state dict (1e-6).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from hetu_tpu.models.gpt import GPTConfig as JGPTConfig  # noqa: E402
from hetu_tpu.models.gpt import convert as jgpt_convert  # noqa: E402
from hetu_tpu.models.llama import LlamaConfig as JLlamaConfig  # noqa: E402
from hetu_tpu.models.llama import convert as jllama_convert  # noqa: E402
from hetu_tpu_torch.models.gpt import GPTConfig, GPTLMHeadModel  # noqa: E402
from hetu_tpu_torch.models.gpt.convert import (  # noqa: E402
    convert_hf_gpt2, export_hf_gpt2)
from hetu_tpu_torch.models.llama import (  # noqa: E402
    LlamaConfig, LlamaLMHeadModel, load_jax_params)
from hetu_tpu_torch.models.llama.convert import (  # noqa: E402
    convert_hf_llama, export_hf_llama)


def _hf_llama(tie: bool):
    cfg = transformers.LlamaConfig(
        vocab_size=256, hidden_size=64, intermediate_size=176,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=256, rms_norm_eps=1e-5, rope_theta=10000.0,
        tie_word_embeddings=tie, attn_implementation="eager")
    torch.manual_seed(0)
    return transformers.LlamaForCausalLM(cfg).eval()


def _hf_gpt2():
    cfg = transformers.GPT2Config(
        vocab_size=256, n_embd=64, n_layer=2, n_head=4, n_positions=256,
        resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0,
        layer_norm_epsilon=1e-5)
    torch.manual_seed(1)
    return transformers.GPT2LMHeadModel(cfg).eval()


def _same_tree(mine, ref):
    flat_m = jax.tree_util.tree_leaves_with_path(mine)
    flat_r = jax.tree_util.tree_leaves_with_path(ref)
    assert [p for p, _ in flat_m] == [p for p, _ in flat_r]
    for (path, a), (_, b) in zip(flat_m, flat_r):
        assert isinstance(a, np.ndarray) and a.dtype == np.float32, path
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=str(path))


def _hf_logits(hf, ids):
    with torch.no_grad():
        return hf(torch.tensor(ids)).logits.numpy()


def _ids(seed):
    return np.random.default_rng(seed).integers(0, 256, (2, 32))


@pytest.mark.parametrize("tie", [False, True])
def test_llama_converter_matches_the_reference_and_hf(tie):
    hf = _hf_llama(tie)
    sd = hf.state_dict()
    tree = convert_hf_llama(sd, LlamaConfig.tiny(tie_word_embeddings=tie))
    _same_tree(tree, jllama_convert.convert_hf_llama(sd, JLlamaConfig.tiny(
        tie_word_embeddings=tie, compute_dtype=jnp.float32)))
    model = LlamaLMHeadModel(LlamaConfig.tiny(
        tie_word_embeddings=tie, compute_dtype=torch.float32), device="cpu")
    load_jax_params(model, tree)
    ids = _ids(0)
    with torch.no_grad():
        ours = model(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(ours, _hf_logits(hf, ids), rtol=2e-3,
                               atol=2e-3)
    back = export_hf_llama(tree, LlamaConfig.tiny(tie_word_embeddings=tie))
    for k, v in back.items():
        np.testing.assert_allclose(v, sd[k].float().numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    assert set(back) == {k for k in sd if not k.endswith("rotary_emb.inv_freq")
                         and not (tie and k == "lm_head.weight")}


def test_gpt2_converter_matches_the_reference_and_hf():
    hf = _hf_gpt2()
    sd = hf.state_dict()
    tree = convert_hf_gpt2(sd, GPTConfig.tiny())
    _same_tree(tree, jgpt_convert.convert_hf_gpt2(sd, JGPTConfig.tiny(
        compute_dtype=jnp.float32)))
    model = GPTLMHeadModel(GPTConfig.tiny(compute_dtype=torch.float32),
                           device="cpu")
    load_jax_params(model, tree)
    ids = _ids(1)
    with torch.no_grad():
        ours = model(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(ours, _hf_logits(hf, ids), rtol=2e-3,
                               atol=2e-3)
    back = export_hf_gpt2(tree, GPTConfig.tiny())
    for k, v in back.items():
        np.testing.assert_allclose(v, sd[k].float().numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    # every HF weight comes back (its attention masks are buffers; the
    # tied lm_head.weight is wte's)
    assert set(back) == {k for k in sd if not k.endswith(".attn.bias")
                         and not k.endswith(".attn.masked_bias")
                         and k != "lm_head.weight"}
