"""LoRA parameter-efficient fine-tuning, the port of
`hetu_tpu/peft/lora.py`.

LoRA lives at the parameter level, as in the reference: one low-rank
pair (A [in, r], B [r, out], fp32) per target weight W [in, *out] of the
frozen base, merged as

    W_eff = W + ((A @ B).reshape(W.shape) * alpha / r).to(W.dtype)

The port's models hold their own weights, so the adapters are bound to
the base's weights for the duration of a forward (`applied`,
`nn.remat.adapters_bound`) rather than merged into a copy of the tree:
every projection of a target weight merges it where it runs, and a
recompute segment keeps W, A and B rather than the merged weight, and
merges again in its backward (`nn/remat.py`).  A multi-task manager
binds one task's adapters at a time over the same base.

Target names are the reference's leaf-path suffixes, matched against
the port's parameter names with "." read as "/" (the port keeps the
reference's names: `model/layers/<i>/attn/wqkv`, `.../o_proj/weight`,
`.../mlp/w_gate_up`, `.../mlp/down_proj/weight`, `lm_head`; GPT's
`.../attn/wqkv`, `.../o_proj/weight`, `.../mlp/w_up`,
`.../mlp/down/weight`).  The port's layers are a ModuleList, so every
adapter is per layer and the reference's `stacked_prefixes` field has
no counterpart; its stacked `[L, in, r]` / `[L, r, out]` factors load
per layer through `models.from_jax.load_jax_lora`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from hetu_tpu_torch.nn import initializers as init
from hetu_tpu_torch.nn.remat import Adapter, adapters_bound, merge_weight


@dataclasses.dataclass
class LoRAConfig:
    rank: int = 8
    alpha: float = 16.0
    # leaf-name suffixes to adapt (matmul weights of attention/MLP)
    targets: Sequence[str] = ("wqkv", "o_proj/weight", "w_gate_up",
                              "down_proj/weight", "lm_head",
                              # GPT-family names
                              "w_up", "down/weight")

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


def _path(name: str) -> str:
    return name.replace(".", "/")


def target_parameters(model: nn.Module, cfg: LoRAConfig
                      ) -> List[Tuple[str, nn.Parameter]]:
    """(name, weight) of every >= 2-D parameter whose path ends with a
    target suffix, in `named_parameters` order."""
    out = [(n, p) for n, p in model.named_parameters()
           if p.dim() >= 2 and any(_path(n).endswith(t)
                                   for t in cfg.targets)]
    if not out:
        raise ValueError(
            f"no parameters matched LoRA targets {tuple(cfg.targets)}; "
            "check the target names against the model's parameter names")
    return out


def init_lora_params(model: nn.Module, cfg: LoRAConfig, *,
                     generator: Optional[torch.Generator] = None,
                     seed: int = 0) -> Dict[str, Dict[str, torch.Tensor]]:
    """{weight name: {"A", "B"}} for every target of `model`: A ~ N(0,
    0.02) drawn from `generator` (else one on the model's device seeded
    with `seed`), B = 0, so training starts at the base model exactly;
    fp32 on the weight's device."""
    targets = target_parameters(model, cfg)
    if generator is None:
        generator = torch.Generator(device=targets[0][1].device)
        generator.manual_seed(seed)
    a_init = init.normal(0.02)
    out = {}
    for name, w in targets:
        d_in, d_out = w.shape[0], math.prod(w.shape[1:])
        out[name] = {
            "A": a_init((d_in, cfg.rank), torch.float32, generator,
                        w.device),
            "B": init.zeros((cfg.rank, d_out), torch.float32,
                            device=w.device)}
    return out


def _bindings(model: nn.Module, lora_params, cfg: LoRAConfig):
    params = dict(model.named_parameters())
    return [(params[name], Adapter(ab["A"], ab["B"], cfg.scale))
            for name, ab in lora_params.items()]


@contextlib.contextmanager
def applied(model: nn.Module, lora_params, cfg: LoRAConfig):
    """Within it, `model`'s forwards use its target weights merged with
    `lora_params`' adapters (gradients reach A and B)."""
    with adapters_bound(_bindings(model, lora_params, cfg)):
        yield


def merge_lora_params(model: nn.Module, lora_params,
                      cfg: LoRAConfig) -> Dict[str, torch.Tensor]:
    """{name: W_eff} over every parameter of `model`: the target weights
    merged (the reference's arithmetic, module docstring), the others
    passed through; the model is left as it was."""
    return {name: (merge_weight(w, Adapter(lora_params[name]["A"],
                                           lora_params[name]["B"],
                                           cfg.scale))
                   if name in lora_params else w)
            for name, w in model.named_parameters()}


def _key(name: str, factor: str) -> str:
    return f"{_path(name)}/{factor}"


class LoRAWrappedModel(nn.Module):
    """A frozen base model with one set of adapters: the training
    forward of the base with its target weights merged.  The base's
    parameters get requires_grad False; the adapters (`lora`, a
    ParameterDict keyed by the reference's leaf path and "A" / "B") are
    the trainable parameters.  `lora_params` ({weight name: {"A",
    "B"}}) starts from given factors; else they are drawn from `seed`
    (`init_lora_params`)."""

    def __init__(self, base_model: nn.Module, cfg: LoRAConfig,
                 lora_params=None, *, seed: int = 0):
        super().__init__()
        self.base_model = base_model.requires_grad_(False)
        self.cfg = cfg
        self.config, self.device = base_model.config, base_model.device
        if lora_params is None:
            lora_params = init_lora_params(base_model, cfg, seed=seed)
        self._names = list(lora_params)
        self.lora = nn.ParameterDict({
            _key(name, f): nn.Parameter(lora_params[name][f])
            for name in self._names for f in ("A", "B")})

    @property
    def lora_params(self) -> Dict[str, Dict[str, nn.Parameter]]:
        """{weight name: {"A", "B"}}: the live adapter parameters."""
        return {name: {f: self.lora[_key(name, f)] for f in ("A", "B")}
                for name in self._names}

    def forward(self, *args, **kwargs):
        with applied(self.base_model, self.lora_params, self.cfg):
            return self.base_model(*args, **kwargs)

    def num_trainable_params(self) -> int:
        return sum(p.numel() for p in self.lora.parameters())


def _leaves(adapters) -> List[torch.Tensor]:
    return [ab[f] for ab in adapters.values() for f in ("A", "B")]


class MultiLoRAManager:
    """Multi-task LoRA over one frozen base (the reference's
    MultiLoraLayers): one adapter set per task, each drawn from
    (`seed`, task index); `forward(task, ...)` runs the base with that
    task's adapters, `loss_and_grads(task, loss_fn)` differentiates that
    task's adapters alone, `schedule(stream)` groups a mixed (task,
    sample) stream into per-task lists."""

    def __init__(self, base_model: nn.Module, cfg: LoRAConfig,
                 tasks: Sequence[str], *, seed: int = 0):
        self.base_model = base_model.requires_grad_(False)
        self.cfg = cfg
        self.adapters: Dict[str, Dict[str, Dict[str, torch.Tensor]]] = {}
        for i, task in enumerate(tasks):
            gen = torch.Generator(device=base_model.device)
            gen.manual_seed(int(np.random.SeedSequence(
                [seed, i]).generate_state(1)[0]))
            params = init_lora_params(base_model, cfg, generator=gen)
            for t in _leaves(params):
                t.requires_grad_(True)
            self.adapters[task] = params

    def tasks(self) -> List[str]:
        return list(self.adapters)

    def parameters(self, task: str) -> List[torch.Tensor]:
        """The task's adapter leaves, A and B of each target in order."""
        return _leaves(self.adapters[task])

    def forward(self, task: str, *args, **kwargs):
        with applied(self.base_model, self.adapters[task], self.cfg):
            return self.base_model(*args, **kwargs)

    def loss_and_grads(self, task: str, loss_fn: Callable[[Any], Any]):
        """(loss_fn(adapters), d loss / d adapters as {name: {"A",
        "B"}}), the gradient of that task's adapters alone."""
        adapters = self.adapters[task]
        loss = loss_fn(adapters)
        grads = iter(torch.autograd.grad(loss, _leaves(adapters)))
        return loss, {name: {f: next(grads) for f in ("A", "B")}
                      for name in adapters}

    @staticmethod
    def schedule(batch_stream):
        """Group a mixed (task, sample) stream into per-task lists."""
        by_task: Dict[str, List[Any]] = {}
        for task, sample in batch_stream:
            by_task.setdefault(task, []).append(sample)
        return by_task
