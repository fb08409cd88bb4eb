"""HuggingFace <-> reference-tree weight conversion for the LLaMA family,
the port of `hetu_tpu/models/llama/convert.py`.

`convert_hf_llama` maps an HF `LlamaForCausalLM` state dict (torch
tensors; `transformers` is never imported) to the reference's parameter
tree with numpy fp32 leaves, in the stacked (`use_scan=True`) layout,
which `load_jax_params` loads into a port `LlamaLMHeadModel`: HF's
[out, in] projections are transposed and regrouped into the fused,
kv-group-aligned `wqkv` [h, n_kv, group + 2, hd] and the fused
`w_gate_up` [h, 2, inter].  `export_hf_llama` is the inverse.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np

from hetu_tpu_torch.models.llama.config import LlamaConfig


def _t(x) -> np.ndarray:
    """torch tensor / array -> numpy float32."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().float().numpy()
    return np.asarray(x, np.float32)


def convert_hf_llama(state_dict: Dict[str, Any],
                     config: LlamaConfig) -> Dict[str, Any]:
    """HF LlamaForCausalLM state dict -> the reference's params tree
    (numpy fp32, per-layer weights stacked on a leading dim)."""
    c = config
    h, hd = c.hidden_size, c.head_dim
    nq, nkv = c.num_attention_heads, c.num_key_value_heads
    g = nq // nkv

    def get(name):
        return _t(state_dict[name])

    wqkv, o_proj, gate_up, down, in_norm, post_norm = [], [], [], [], [], []
    for i in range(c.num_hidden_layers):
        pre = f"model.layers.{i}."
        # HF stores [out, in]; the reference's is [in, out]
        q = get(pre + "self_attn.q_proj.weight").T.reshape(h, nkv, g, hd)
        k = get(pre + "self_attn.k_proj.weight").T.reshape(h, nkv, 1, hd)
        v = get(pre + "self_attn.v_proj.weight").T.reshape(h, nkv, 1, hd)
        wqkv.append(np.concatenate([q, k, v], axis=2))  # [h, nkv, g+2, hd]
        o_proj.append(get(pre + "self_attn.o_proj.weight").T)
        gate = get(pre + "mlp.gate_proj.weight").T      # [h, I]
        up = get(pre + "mlp.up_proj.weight").T
        gate_up.append(np.stack([gate, up], axis=1))    # [h, 2, I]
        down.append(get(pre + "mlp.down_proj.weight").T)
        in_norm.append(get(pre + "input_layernorm.weight"))
        post_norm.append(get(pre + "post_attention_layernorm.weight"))
    layers = {
        "attn": {"wqkv": np.stack(wqkv),
                 "o_proj": {"weight": np.stack(o_proj)}},
        "mlp": {"w_gate_up": np.stack(gate_up),
                "down_proj": {"weight": np.stack(down)}},
        "input_norm": {"weight": np.stack(in_norm)},
        "post_norm": {"weight": np.stack(post_norm)},
    }
    params: Dict[str, Any] = {"model": {
        "embed": {"weight": get("model.embed_tokens.weight")},
        "layers": {"layers": layers},
        "final_norm": {"weight": get("model.norm.weight")},
    }}
    if not c.tie_word_embeddings:
        lm = state_dict.get("lm_head.weight",
                            state_dict["model.embed_tokens.weight"])
        params["lm_head"] = _t(lm).T
    return params


def export_hf_llama(params: Dict[str, Any],
                    config: LlamaConfig) -> Dict[str, np.ndarray]:
    """Inverse mapping: the reference's params tree (stacked) -> HF
    state dict (numpy fp32)."""
    c = config
    h, hd = c.hidden_size, c.head_dim
    nq, nkv = c.num_attention_heads, c.num_key_value_heads
    g = nq // nkv
    mp = params["model"]
    layers = mp["layers"]["layers"]
    out: Dict[str, np.ndarray] = {
        "model.embed_tokens.weight": _t(mp["embed"]["weight"]),
        "model.norm.weight": _t(mp["final_norm"]["weight"]),
    }
    wqkv = _t(layers["attn"]["wqkv"])
    o = _t(layers["attn"]["o_proj"]["weight"])
    gu = _t(layers["mlp"]["w_gate_up"])
    dn = _t(layers["mlp"]["down_proj"]["weight"])
    inn = _t(layers["input_norm"]["weight"])
    pon = _t(layers["post_norm"]["weight"])
    for i in range(c.num_hidden_layers):
        pre = f"model.layers.{i}."
        out[pre + "self_attn.q_proj.weight"] = \
            wqkv[i][:, :, :g, :].reshape(h, nq * hd).T
        out[pre + "self_attn.k_proj.weight"] = \
            wqkv[i][:, :, g, :].reshape(h, nkv * hd).T
        out[pre + "self_attn.v_proj.weight"] = \
            wqkv[i][:, :, g + 1, :].reshape(h, nkv * hd).T
        out[pre + "self_attn.o_proj.weight"] = o[i].T
        out[pre + "mlp.gate_proj.weight"] = gu[i][:, 0, :].T
        out[pre + "mlp.up_proj.weight"] = gu[i][:, 1, :].T
        out[pre + "mlp.down_proj.weight"] = dn[i].T
        out[pre + "input_layernorm.weight"] = inn[i]
        out[pre + "post_attention_layernorm.weight"] = pon[i]
    if "lm_head" in params:
        out["lm_head.weight"] = _t(params["lm_head"]).T
    return out
