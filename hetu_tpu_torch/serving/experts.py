"""Resident quantized expert weights for MoE serving, the port of
`hetu_tpu/serving/experts.py`.

The stacked expert leaves of every MoE layer (`w_gate_up` [E, h, 2, I],
`w_down` [E, I, h]) dominate an MoE model's parameters, and every decode
step reads them whole.  Under `ServeConfig(moe_dispatch="int8"|"int4")`
the engine keeps them KV-pool-style: blockwise int payloads at block 256
and one fp32 absmax scale a block — the reference's `comm/compress`
arithmetic, int4 packed two values a byte by `ops/quantization.
pack_nibbles` in the reference's wire layout (the even index in the high
nibble, values offset by 8).  A leaf is quantized from its own values on
the card by the quantize kernel (`ops/cuda/quant.quantize_blockwise`,
which widens bf16 and fp16 in registers: no fp32 copy), zero-padded to a block
multiple as the reference pads it.

Where the reference dequantizes the whole tree on entry to each
compiled program and XLA fuses it into the expert products, eager
PyTorch would hold a dequantized copy of every expert at once.  Here
each MoE layer dequantizes its own two leaves when its forward runs
(`layer_loaders`, bound by `nn.moe.resident_experts`): two launches of
the dequantize kernel a layer a forward, written straight in the
parameters' dtype, and the working copy is dropped when the layer
returns.  Quantization happens once, at engine build, so serving is
deterministic: the engine's tokens are those of the model whose experts
hold the dequantized values (`dequantize_expert_tree`), the reference's
contract.  The model keeps its own parameters.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Tuple

import torch

from hetu_tpu_torch.nn.moe import MoELayer
from hetu_tpu_torch.ops.cuda.quant import (KERNEL_DTYPES,
                                          dequantize_blockwise,
                                          quantize_blockwise)
from hetu_tpu_torch.ops.quantization import pack_nibbles, unpack_nibbles

#: the two stacked expert leaves of an MoE layer
EXPERT_KEYS = ("w_gate_up", "w_down")
#: the reference's quantized-path block (`comm/wire.py` DEFAULT_BLOCK)
DEFAULT_BLOCK = 256


def expert_layers(model) -> List[Tuple[str, MoELayer]]:
    """[(module name, layer)] of every MoE layer of `model`."""
    return [(name, m) for name, m in model.named_modules()
            if isinstance(m, MoELayer)]


def _q_leaf(leaf: torch.Tensor, block: int, bits: int) -> Dict[str, Any]:
    """One expert leaf -> {"q", "s"}: a flat blockwise quantize on the
    leaf's device (one fp32 scale per `block` values; the zero pad
    quantizes to zero and is sliced off on dequant)."""
    flat = leaf.detach().reshape(-1)
    if flat.dtype not in KERNEL_DTYPES:
        flat = flat.float()
    pad = (-flat.numel()) % block
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    q, s = quantize_blockwise(flat, block, bits=bits, device=flat.device)
    if bits == 4:
        q = pack_nibbles((q + 8).to(torch.uint8), even_high=True)
    return {"q": q, "s": s}


def quantize_expert_tree(model, *, bits: int = 8, block: int = DEFAULT_BLOCK
                         ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Every MoE layer's expert leaves, blockwise-quantized.  Returns
    (store, spec): store maps "<layer>.<key>" (the parameter's name) to
    {"q", "s"}; spec maps the same names to {"shape", "dtype", "bits",
    "block"}, what `dequantize_leaf` rebuilds from.  A model without MoE
    layers raises ValueError."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    store: Dict[str, Any] = {}
    spec: Dict[str, Any] = {}
    for name, layer in expert_layers(model):
        for k in EXPERT_KEYS:
            leaf = getattr(layer, k)
            key = f"{name}.{k}"
            spec[key] = {"shape": tuple(leaf.shape), "dtype": leaf.dtype,
                         "bits": bits, "block": block}
            store[key] = _q_leaf(leaf, block, bits)
    if not spec:
        raise ValueError("no MoE expert leaves found: is this an MoE "
                         "model (num_experts > 0)?")
    return store, spec


def dequantize_leaf(node: Dict[str, Any], meta: Dict[str, Any]
                    ) -> torch.Tensor:
    """The leaf of `meta`'s shape and dtype from its {"q", "s"}: int4
    unpacked to int8 (plain PyTorch, as the reference's), then the
    dequantize kernel on the payload's device, written in the leaf's
    dtype (fp32, or bf16 or fp16 rounded once from the fp32 product)."""
    q = node["q"]
    if meta["bits"] == 4:
        q = unpack_nibbles(q, even_high=True).to(torch.int8) - 8
    dtype = meta["dtype"]
    out = dtype if dtype in KERNEL_DTYPES else torch.float32
    flat = dequantize_blockwise(q, node["s"], out_dtype=out, device=q.device)
    n = math.prod(meta["shape"])
    return flat[:n].view(meta["shape"]).to(dtype)


def dequantize_expert_tree(store: Dict[str, Any], spec: Dict[str, Any]
                           ) -> Dict[str, torch.Tensor]:
    """{name: dequantized leaf} of the whole store: every layer's
    working copy at once (what a check loads into a model; the engine
    dequantizes one layer at a time, `layer_loaders`)."""
    return {key: dequantize_leaf(store[key], meta)
            for key, meta in spec.items()}


def layer_loaders(model, store: Dict[str, Any], spec: Dict[str, Any]
                  ) -> Dict[int, Callable[[], Tuple[torch.Tensor,
                                                    torch.Tensor]]]:
    """{id(layer): loader} for `nn.moe.resident_experts`: each loader
    dequantizes its layer's two leaves (two kernel launches) when the
    layer's forward asks for them."""
    def loader(name):
        return lambda: tuple(dequantize_leaf(store[f"{name}.{k}"],
                                             spec[f"{name}.{k}"])
                             for k in EXPERT_KEYS)
    return {id(layer): loader(name) for name, layer in expert_layers(model)}


def expert_bytes(spec: Dict[str, Any]) -> Dict[str, float]:
    """Analytic resident bytes: fp against quantized expert storage (the
    serve.moe_expert_bytes gauges)."""
    fp = q = 0.0
    for meta in spec.values():
        n = math.prod(meta["shape"])
        fp += n * torch.empty(0, dtype=meta["dtype"]).element_size()
        nb = -(-n // meta["block"])          # scales, one fp32 a block
        q += (n if meta["bits"] == 8 else n / 2) + 4.0 * nb
    return {"fp_bytes": fp, "quantized_bytes": q,
            "ratio": (fp / q) if q else None}
