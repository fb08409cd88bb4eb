"""Weight carry-over from the JAX reference.

`load_jax_params(model, tree)` takes the reference's parameter pytree
of either family (LLaMA, GPT) with its leaves as numpy arrays and
copies it into the port's parameters key for key.  Both of the
reference's layer layouts load: the stacked `use_scan=True` one, where
every per-layer leaf carries a leading [num_layers] axis, and the
per-layer `use_scan=False` one, with a subtree per layer.  The port
keeps the reference's names and fused layouts, so the mapping is
mechanical; the model names its family's prefixes in `jax_layers`:

    LLaMA  model.layers.layers.<leaf>[i]  ->  model.layers.<i>.<leaf>
           model.layers.layer_<i>.<leaf>  ->  model.layers.<i>.<leaf>
    GPT    model.blocks.<leaf>[i]         ->  model.blocks.<i>.<leaf>
           model.block_<i>.<leaf>         ->  model.blocks.<i>.<leaf>
    anything else                         ->  the same dotted name

A config with a `use_scan` field (GPT's) names the layout it expects,
and the other raises.  A key the port lacks, a port parameter the tree
lacks, or any shape that differs raises ValueError naming it; nothing
is filled partially before the whole tree has been checked.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, name + "."))
        else:
            out[name] = np.asarray(v)
    return out


def load_jax_params(model: torch.nn.Module, tree: Mapping) -> None:
    """Fill `model` (a port `LlamaLMHeadModel` or `GPTLMHeadModel`) from
    the reference's param pytree (numpy leaves, stacked or per-layer).
    Values are cast to each parameter's dtype (through fp32, which holds
    the reference's fp32 and bf16 leaves exactly) and copied to its
    device."""
    flat = _flatten(tree)
    n_layers = model.config.num_hidden_layers
    port, stacked_prefix, per_layer = model.jax_layers
    layer = re.compile(rf"^{re.escape(port)}\.(\d+)\.(.+)$")
    stacked = any(k.startswith(stacked_prefix) for k in flat)
    want = getattr(model.config, "use_scan", stacked)
    if want != stacked:
        raise ValueError(
            f"config.use_scan={want} expects the reference's "
            f"{'stacked' if want else 'per-layer'} layout; the tree holds "
            f"the {'stacked' if stacked else 'per-layer'} one")
    plan = []                               # (param, source array)
    used = set()
    missing = []
    for name, param in model.named_parameters():
        m = layer.match(name)
        key, index = name, None
        if m and stacked:
            key, index = stacked_prefix + m.group(2), int(m.group(1))
        elif m:
            key = per_layer.format(m.group(1)) + m.group(2)
        if key not in flat:
            missing.append(f"{name} (reference key {key})")
            continue
        src = flat[key]
        if index is not None:
            if src.ndim == 0 or src.shape[0] != n_layers:
                raise ValueError(
                    f"{key}: stacked leaf of shape {src.shape} does not "
                    f"lead with the port's {n_layers} layers")
            src = src[index]
        if tuple(src.shape) != tuple(param.shape):
            raise ValueError(f"{name}: reference {key} has shape "
                             f"{tuple(src.shape)}, the port expects "
                             f"{tuple(param.shape)}")
        used.add(key)
        plan.append((param, src))
    if missing:
        raise ValueError("reference tree lacks parameters: "
                         + ", ".join(missing))
    extra = sorted(set(flat) - used)
    if extra:
        raise ValueError("reference tree holds keys the port does not "
                         "have: " + ", ".join(extra))
    with torch.no_grad():
        for param, src in plan:
            param.copy_(torch.from_numpy(np.array(src, dtype=np.float32)))
