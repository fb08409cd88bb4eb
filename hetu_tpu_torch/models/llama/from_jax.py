"""Weight carry-over from the JAX reference.

`load_jax_params(model, tree)` takes the reference's LLaMA parameter
pytree with its leaves as numpy arrays and copies it into the port's
parameters key for key.  Both of the reference's layer layouts load:
the stacked `use_scan=True` one, where every per-layer leaf under
`model.layers.layers` carries a leading [num_layers] axis, and the
per-layer `use_scan=False` one, with a `model.layers.layer_<i>` subtree
per layer.  The port keeps the reference's names and fused layouts, so
the mapping is mechanical:

    model.layers.layers.<leaf>[i]   ->  model.layers.<i>.<leaf>
    model.layers.layer_<i>.<leaf>   ->  model.layers.<i>.<leaf>
    anything else                   ->  the same dotted name

A key the port lacks, a port parameter the tree lacks, or any shape
that differs raises ValueError naming it; nothing is filled partially
before the whole tree has been checked.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_LAYER = re.compile(r"^model\.layers\.(\d+)\.(.+)$")
_STACKED = "model.layers.layers."
_PER_LAYER = "model.layers.layer_{}."


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
    """Fill `model` (a port `LlamaLMHeadModel`) from the reference's
    param pytree (numpy leaves, stacked or per-layer).  Values are cast
    to each parameter's dtype (through fp32, which holds the
    reference's fp32 and bf16 leaves exactly) and copied to its
    device."""
    flat = _flatten(tree)
    n_layers = model.config.num_hidden_layers
    stacked = any(k.startswith(_STACKED) for k in flat)
    plan = []                               # (param, source array)
    used = set()
    missing = []
    for name, param in model.named_parameters():
        m = _LAYER.match(name)
        key, index = name, None
        if m and stacked:
            key, index = _STACKED + m.group(2), int(m.group(1))
        elif m:
            key = _PER_LAYER.format(m.group(1)) + m.group(2)
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
