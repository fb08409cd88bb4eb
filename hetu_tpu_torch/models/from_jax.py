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
and the other raises.  `load_jax_lora(model, tree)` maps the
reference's LoRA tree (`init_lora_params`: {"A", "B"} under each target
leaf's path, [L, in, r] / [L, r, out] under a stacked prefix) the same
way onto the port's per-layer adapters.  A key the port lacks, a port
parameter the tree lacks, or any shape that differs raises ValueError
naming it; nothing is filled partially before the whole tree has been
checked.
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


def _port_names(model, key: str):
    """The reference's dotted leaf path -> [(port name, layer index or
    None)] (one entry a layer for a stacked leaf), by the model's
    `jax_layers`."""
    port, stacked_prefix, per_layer = model.jax_layers
    if key.startswith(stacked_prefix):
        rest = key[len(stacked_prefix):]
        return [(f"{port}.{i}.{rest}", i)
                for i in range(model.config.num_hidden_layers)]
    head, tail = per_layer.split("{}")
    m = re.match(rf"^{re.escape(head)}(\d+){re.escape(tail)}(.+)$", key)
    if m:
        return [(f"{port}.{m.group(1)}.{m.group(2)}", None)]
    return [(key, None)]


def load_jax_lora(model: torch.nn.Module,
                  tree: Mapping) -> Dict[str, Dict[str, torch.Tensor]]:
    """The reference's LoRA tree (numpy leaves) -> {port weight name:
    {"A", "B"}} fp32 on the model's device, stacked factors split per
    layer.  A leaf other than A or B, a weight the port lacks, or
    factors that do not fit their weight raise ValueError."""
    flat = _flatten(tree)
    odd = sorted(k for k in flat if not k.endswith((".A", ".B")))
    if odd:
        raise ValueError(f"LoRA leaves must be A or B, got {odd}")
    params = dict(model.named_parameters())
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for key in sorted({k[:-2] for k in flat}):
        if key + ".A" not in flat or key + ".B" not in flat:
            raise ValueError(f"{key}: a LoRA leaf holds both A and B")
        a, b = flat[key + ".A"], flat[key + ".B"]
        names = _port_names(model, key)
        if names[0][1] is not None and not (
                a.shape[0] == b.shape[0] == len(names)):
            raise ValueError(f"{key}: stacked factors {a.shape} x "
                             f"{b.shape} do not lead with the port's "
                             f"{len(names)} layers")
        for name, index in names:
            if name not in params:
                raise ValueError(f"{key}: the port has no weight {name}")
            w = params[name]
            ai, bi = (a, b) if index is None else (a[index], b[index])
            want = ((w.shape[0], ai.shape[-1]),
                    (ai.shape[-1], int(np.prod(w.shape[1:]))))
            if (tuple(ai.shape), tuple(bi.shape)) != want:
                raise ValueError(f"{name}: LoRA factors {tuple(ai.shape)} x "
                                 f"{tuple(bi.shape)} do not fit its weight "
                                 f"{tuple(w.shape)}")
            out[name] = {f: torch.from_numpy(np.array(t, dtype=np.float32)
                                             ).to(w.device)
                         for f, t in (("A", ai), ("B", bi))}
    return out


def load_jax_params(model: torch.nn.Module, tree: Mapping) -> None:
    """Fill `model` (a port `LlamaLMHeadModel` or `GPTLMHeadModel`) from
    the reference's param pytree (numpy leaves, stacked or per-layer).
    Values are cast to each parameter's dtype (through fp32, which holds
    the reference's fp32, bf16 and fp16 leaves exactly: an fp16 leaf
    reaches an fp16 parameter bit for bit) and copied to its device."""
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
