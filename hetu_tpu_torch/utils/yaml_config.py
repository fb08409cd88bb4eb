"""YAML experiment configs, the port of `hetu_tpu/utils/yaml_config.py`:
the reference's section layout (`parallel`, `model`, `trainer`, `rpc`)
merged into the port's typed configs, the model built on `device`.

```yaml
parallel: {dp: 1}          # degrees above 1 and ZeRO: the multi-GPU slice
model:
  family: llama            # llama | gpt
  preset: llama3_8b        # a config constructor, or explicit fields
  overrides: {num_hidden_layers: 4}
trainer:                   # TrainingConfig fields
  global_batch_size: 8
  seq_len: 2048
```

A dict works as well as a path; PyYAML is imported only to read a file.
The port runs on one device, so `load_experiment` returns `None` where
the reference returns its `ParallelStrategy`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

from hetu_tpu_torch.engine.trainer_config import TrainingConfig

_MULTI_GPU = "the multi-GPU slice (ROADMAP Queue A item 5)"
_CONTROL_PLANE = "the control-plane slice (ROADMAP Queue A item 6)"

#: the reference's `parallel` keys: mesh degrees, then ParallelStrategy's
#: fields (every one of them a multi-device behaviour)
_DEGREES = ("dp", "cp", "tp", "pp", "ep")
_STRATEGY_FIELDS = ("sequence_parallel", "cp_tp_eff", "cp_split",
                    "pp_tp_eff", "zero", "zero_stage")


def load_yaml_config(path_or_dict) -> Dict[str, Any]:
    if isinstance(path_or_dict, dict):
        return path_or_dict
    import yaml
    with open(path_or_dict) as f:
        return yaml.safe_load(f)


def parse_parallel(cfg: Dict[str, Any]) -> None:
    """Check the `parallel` section: unknown keys raise ValueError (the
    reference's rule); a degree above 1 or any strategy field set (a
    ZeRO stage, sequence parallelism, ...) raises NotImplementedError
    naming the multi-GPU slice.  One device: returns None."""
    p = dict(cfg.get("parallel") or {})
    unknown = set(p) - set(_DEGREES) - set(_STRATEGY_FIELDS)
    if unknown:
        raise ValueError(f"unknown parallel config keys: {sorted(unknown)}")
    multi = {k: v for k, v in p.items()
             if (v if k in _STRATEGY_FIELDS else int(v) > 1)}
    if multi:
        raise NotImplementedError(
            f"parallel {multi} is not in the port yet; it arrives with "
            f"{_MULTI_GPU}")
    return None


def parse_trainer(cfg: Dict[str, Any]) -> TrainingConfig:
    t = dict(cfg.get("trainer") or {})
    known = {f.name for f in dataclasses.fields(TrainingConfig)}
    unknown = set(t) - known
    if unknown:
        raise ValueError(f"unknown trainer config keys: {sorted(unknown)}")
    return TrainingConfig(**t)


def parse_model(cfg: Dict[str, Any], *, device="cuda", seed: int = 0):
    """Build the port model of the `model:` section on `device`
    (weights drawn from `seed`)."""
    m = dict(cfg.get("model") or {})
    family = m.get("family", "llama")
    preset = m.get("preset", "tiny")
    overrides = m.get("overrides", {}) or {}
    if family == "llama":
        from hetu_tpu_torch.models.llama import LlamaConfig, LlamaLMHeadModel
        mk = getattr(LlamaConfig, preset)
        return LlamaLMHeadModel(mk(**overrides), device=device, seed=seed)
    if family == "gpt":
        from hetu_tpu_torch.models.gpt import GPTConfig, GPTLMHeadModel
        mk = getattr(GPTConfig, preset, None)
        cfg_obj = mk(**overrides) if mk else GPTConfig(**overrides)
        return GPTLMHeadModel(cfg_obj, device=device, seed=seed)
    raise ValueError(f"unknown model family {family!r}")


def load_experiment(path_or_dict, *, device="cuda", seed: int = 0
                    ) -> Tuple[Any, TrainingConfig, None, Dict]:
    """(model, training_config, None, raw) from one YAML file or dict
    (the reference's (model, config, strategy, raw)); an `rpc` section
    raises NotImplementedError naming the control-plane slice."""
    raw = load_yaml_config(path_or_dict)
    if "rpc" in raw:
        raise NotImplementedError(
            f"the rpc section is not in the port yet; it arrives with "
            f"{_CONTROL_PLANE}")
    strategy = parse_parallel(raw)
    trainer_cfg = parse_trainer(raw)
    model = parse_model(raw, device=device, seed=seed)
    return model, trainer_cfg, strategy, raw
