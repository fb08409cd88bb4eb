"""HuggingFace <-> reference-tree weight conversion for the GPT family,
the port of `hetu_tpu/models/gpt/convert.py`.

`convert_hf_gpt2` maps an HF `GPT2LMHeadModel` state dict (torch
tensors; `transformers` is never imported) to the reference's parameter
tree with numpy fp32 leaves, in the stacked (`use_scan=True`) layout,
which `load_jax_params` loads into a port `GPTLMHeadModel` (casting to
its `param_dtype`).  HF GPT-2's Conv1D weights are stored [in, out],
the reference's orientation, so the mapping is regrouping: c_attn's
packed [h, 3h] splits into the per-head [h, heads, 3, hd] fused QKV,
and per-layer tensors stack onto a leading layer axis.
`export_hf_gpt2` is the inverse.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np

from hetu_tpu_torch.models.gpt.config import GPTConfig


def _t(x) -> np.ndarray:
    """torch tensor / array -> numpy float32."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().float().numpy()
    return np.asarray(x, np.float32)


def convert_hf_gpt2(state_dict: Dict[str, Any],
                    config: GPTConfig) -> Dict[str, Any]:
    """HF GPT2LMHeadModel state dict -> the reference's params tree
    (numpy fp32, per-layer weights stacked on a leading dim)."""
    c = config
    h, hd, nh = c.hidden_size, c.head_dim, c.num_attention_heads

    def get(name):
        return _t(state_dict[name])

    cols = {k: [] for k in ("wqkv", "bqkv", "ow", "ob", "ln1w", "ln1b",
                            "ln2w", "ln2b", "uw", "ub", "dw", "db")}
    for i in range(c.num_hidden_layers):
        pre = f"transformer.h.{i}."
        w = get(pre + "attn.c_attn.weight")          # [h, 3h], [q|k|v]
        b = get(pre + "attn.c_attn.bias")            # [3h]
        cols["wqkv"].append(np.stack(
            [w[:, j * h:(j + 1) * h].reshape(h, nh, hd) for j in range(3)],
            axis=2))                                 # [h, nh, 3, hd]
        cols["bqkv"].append(np.stack(
            [b[j * h:(j + 1) * h].reshape(nh, hd) for j in range(3)],
            axis=1))                                 # [nh, 3, hd]
        cols["ow"].append(get(pre + "attn.c_proj.weight"))
        cols["ob"].append(get(pre + "attn.c_proj.bias"))
        cols["ln1w"].append(get(pre + "ln_1.weight"))
        cols["ln1b"].append(get(pre + "ln_1.bias"))
        cols["ln2w"].append(get(pre + "ln_2.weight"))
        cols["ln2b"].append(get(pre + "ln_2.bias"))
        cols["uw"].append(get(pre + "mlp.c_fc.weight"))      # [h, 4h]
        cols["ub"].append(get(pre + "mlp.c_fc.bias"))
        cols["dw"].append(get(pre + "mlp.c_proj.weight"))    # [4h, h]
        cols["db"].append(get(pre + "mlp.c_proj.bias"))
    stack = {k: np.stack(v) for k, v in cols.items()}
    blocks = {
        "ln1": {"weight": stack["ln1w"], "bias": stack["ln1b"]},
        "attn": {"wqkv": stack["wqkv"], "bqkv": stack["bqkv"],
                 "o_proj": {"weight": stack["ow"], "bias": stack["ob"]}},
        "ln2": {"weight": stack["ln2w"], "bias": stack["ln2b"]},
        "mlp": {"w_up": stack["uw"], "b_up": stack["ub"],
                "down": {"weight": stack["dw"], "bias": stack["db"]}},
    }
    params: Dict[str, Any] = {"model": {
        "wte": {"weight": get("transformer.wte.weight")},
        "wpe": get("transformer.wpe.weight"),
        "blocks": blocks,
        "final_ln": {"weight": get("transformer.ln_f.weight"),
                     "bias": get("transformer.ln_f.bias")},
    }}
    if not c.tie_word_embeddings:
        lm = state_dict.get("lm_head.weight",
                            state_dict["transformer.wte.weight"])
        params["lm_head"] = _t(lm).T
    return params


def export_hf_gpt2(params: Dict[str, Any],
                   config: GPTConfig) -> Dict[str, np.ndarray]:
    """Inverse mapping: the reference's params tree (stacked) -> HF
    state dict (numpy fp32)."""
    c = config
    h, hd, nh = c.hidden_size, c.head_dim, c.num_attention_heads
    mp = params["model"]
    blocks = mp["blocks"]
    out: Dict[str, np.ndarray] = {
        "transformer.wte.weight": _t(mp["wte"]["weight"]),
        "transformer.wpe.weight": _t(mp["wpe"]),
        "transformer.ln_f.weight": _t(mp["final_ln"]["weight"]),
        "transformer.ln_f.bias": _t(mp["final_ln"]["bias"]),
    }
    wqkv, bqkv = _t(blocks["attn"]["wqkv"]), _t(blocks["attn"]["bqkv"])
    leaves = {
        "attn.c_proj.weight": blocks["attn"]["o_proj"]["weight"],
        "attn.c_proj.bias": blocks["attn"]["o_proj"]["bias"],
        "ln_1.weight": blocks["ln1"]["weight"],
        "ln_1.bias": blocks["ln1"]["bias"],
        "ln_2.weight": blocks["ln2"]["weight"],
        "ln_2.bias": blocks["ln2"]["bias"],
        "mlp.c_fc.weight": blocks["mlp"]["w_up"],
        "mlp.c_fc.bias": blocks["mlp"]["b_up"],
        "mlp.c_proj.weight": blocks["mlp"]["down"]["weight"],
        "mlp.c_proj.bias": blocks["mlp"]["down"]["bias"],
    }
    leaves = {k: _t(v) for k, v in leaves.items()}
    for i in range(c.num_hidden_layers):
        pre = f"transformer.h.{i}."
        out[pre + "attn.c_attn.weight"] = np.concatenate(
            [wqkv[i][:, :, j, :].reshape(h, nh * hd) for j in range(3)],
            axis=1)
        out[pre + "attn.c_attn.bias"] = np.concatenate(
            [bqkv[i][:, j, :].reshape(nh * hd) for j in range(3)])
        for k, v in leaves.items():
            out[pre + k] = v[i]
    if "lm_head" in params:
        out["lm_head.weight"] = _t(params["lm_head"]).T
    return out
