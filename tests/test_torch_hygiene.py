"""Import and device hygiene of the PyTorch port (hetu_tpu_torch).

The port imports torch and numpy only: never jax, never the JAX package
(importing any `hetu_tpu` module runs its package `__init__`, which
loads JAX), never transformers (its HF converters take state dicts, and
its `HFTokenizer` imports transformers in its constructor alone).
Importing it builds nothing.  Its entry points run on the card unless
the caller asks for the CPU, and raise where there is no card.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from hetu_tpu_torch.engine import Trainer, TrainingConfig
from hetu_tpu_torch.models.llama import LlamaConfig, LlamaLMHeadModel
from hetu_tpu_torch.ops.cuda import build
from hetu_tpu_torch.serving import (Request, SamplingParams, ServeConfig,
                                    ServingEngine)

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, json, pkgutil, sys
import hetu_tpu_torch
names = [m.name for m in pkgutil.walk_packages(hetu_tpu_torch.__path__,
                                               "hetu_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "hetu_tpu", "transformers"))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_port_imports_neither_jax_nor_the_jax_package(tmp_path):
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    probe = json.loads(out.stdout.strip().splitlines()[-1])
    assert probe["bad"] == []
    # the walk reached the whole slice
    for name in ("hetu_tpu_torch.serving.engine",
                 "hetu_tpu_torch.models.generation",
                 "hetu_tpu_torch.ops.cuda.paged_attention",
                 "hetu_tpu_torch.ops.cuda.rotary",
                 "hetu_tpu_torch.ops.cuda.swiglu",
                 "hetu_tpu_torch.engine.trainer",
                 "hetu_tpu_torch.optim.optimizer",
                 "hetu_tpu_torch.ops.cuda.fused_norm",
                 "hetu_tpu_torch.ops.cuda.adam",
                 "hetu_tpu_torch.ops.cuda.flash_attention",
                 "hetu_tpu_torch.ops.cuda.quant",
                 "hetu_tpu_torch.ops.cuda.sample",
                 "hetu_tpu_torch.serving.sampling",
                 "hetu_tpu_torch.serving.spec_decode",
                 "hetu_tpu_torch.models.gpt.model",
                 "hetu_tpu_torch.models.gpt.convert",
                 "hetu_tpu_torch.models.llama.convert",
                 "hetu_tpu_torch.models.from_jax",
                 "hetu_tpu_torch.core.dtypes",
                 "hetu_tpu_torch.data.bucket",
                 "hetu_tpu_torch.data.data_collator",
                 "hetu_tpu_torch.data.dataloader",
                 "hetu_tpu_torch.data.dataset",
                 "hetu_tpu_torch.data.messages",
                 "hetu_tpu_torch.data.tokenizers.bpe",
                 "hetu_tpu_torch.data.tokenizers.hf",
                 "hetu_tpu_torch.data.tokenizers.sp_model",
                 "hetu_tpu_torch.data.tokenizers.tiktoken_bpe",
                 "hetu_tpu_torch.utils.flags",
                 "hetu_tpu_torch.utils.yaml_config",
                 "hetu_tpu_torch.obs.runlog",
                 "hetu_tpu_torch.obs.numerics",
                 "hetu_tpu_torch.obs.health",
                 "hetu_tpu_torch.nn.initializers",
                 "hetu_tpu_torch.peft.lora",
                 "hetu_tpu_torch.peft.multi_task",
                 "hetu_tpu_torch.engine.sft_trainer",
                 "hetu_tpu_torch.serving.disagg",
                 "hetu_tpu_torch.serving.frontend",
                 "hetu_tpu_torch.serving.fleet",
                 "hetu_tpu_torch.serving.slo_report",
                 "hetu_tpu_torch.serving.tracing",
                 "hetu_tpu_torch.serving.costs",
                 "hetu_tpu_torch.obs.spans",
                 "hetu_tpu_torch.obs.critpath",
                 "hetu_tpu_torch.obs.trace",
                 "hetu_tpu_torch.chaos.plan",
                 "hetu_tpu_torch.chaos.inject"):
        assert name in probe["modules"]


def test_chip_smoke_imports_neither_jax_nor_the_jax_package():
    text = (ROOT / "chip_smoke.py").read_text()
    for line in text.splitlines():
        words = line.split()
        if words[:1] in (["import"], ["from"]):
            mod = words[1].split(".")[0].rstrip(",")
            assert mod not in ("jax", "hetu_tpu"), line


def test_cpu_serving_builds_nothing(monkeypatch):
    """Kernels build at their first launch on a card: a CPU run through
    every wrapper never asks for a build or a library."""
    calls = []
    monkeypatch.setattr(build, "build", lambda *a, **k: calls.append(a))
    monkeypatch.setattr(build, "library", lambda *a, **k: calls.append(a))
    model = LlamaLMHeadModel(LlamaConfig.tiny(), device="cpu")
    eng = ServingEngine(model, ServeConfig(num_slots=2, max_len=32,
                                           prefill_chunk=8), device="cpu")
    eng.warmup()
    eng.run([Request(rid=0, prompt=np.arange(1, 12, dtype=np.int32),
                     max_new_tokens=3)])
    assert calls == []


@pytest.mark.parametrize("opts", [
    {"sampling": True, "spec_decode": "ngram", "kv_quant": "int8"},
    {"sampling": True, "kv_quant": "int4"},
    {"sampling": True, "spec_decode": "model", "kv_quant": "int8",
     "prefix_cache": True}])
def test_cpu_sampled_spec_and_quantized_serving_builds_nothing(monkeypatch,
                                                               opts):
    """The same through the sampler, the verify step, quantized pages,
    and the model drafter with the prefix cache."""
    calls = []
    monkeypatch.setattr(build, "build", lambda *a, **k: calls.append(a))
    monkeypatch.setattr(build, "library", lambda *a, **k: calls.append(a))
    model = LlamaLMHeadModel(LlamaConfig.tiny(), device="cpu")
    draft = {}
    if opts.get("spec_decode") == "model":
        draft["draft_model"] = LlamaLMHeadModel(LlamaConfig.tiny(),
                                                device="cpu", seed=1)
    eng = ServingEngine(model, ServeConfig(num_slots=2, max_len=32,
                                           prefill_chunk=8, **opts),
                        device="cpu", **draft)
    eng.warmup()
    eng.run([Request(rid=0, prompt=np.arange(1, 12, dtype=np.int32),
                     max_new_tokens=3,
                     sampling=SamplingParams(temperature=0.7, top_k=5,
                                             seed=3))])
    assert calls == []


def test_no_library_attention_in_the_port():
    """The port's attention is its own kernels: no file of the package
    names PyTorch's fused attention (chip_smoke.py times it beside the
    kernels as a yardstick, and only there)."""
    named = [str(path.relative_to(ROOT))
             for path in sorted((ROOT / "hetu_tpu_torch").rglob("*"))
             if path.suffix in (".py", ".cu", ".cuh")
             and "scaled_dot_product_attention" in path.read_text()]
    assert named == []
    assert "scaled_dot_product_attention" in (ROOT / "chip_smoke.py"
                                              ).read_text()


def test_no_library_adamw_in_the_port():
    """The port's AdamW is its own kernel: no file of the package names
    PyTorch's fused AdamW (chip_smoke.py times it beside the kernel as a
    yardstick, and only there)."""
    named = [str(path.relative_to(ROOT))
             for path in sorted((ROOT / "hetu_tpu_torch").rglob("*"))
             if path.suffix in (".py", ".cu", ".cuh")
             and "_fused_adam" in path.read_text()]
    assert named == []
    assert "torch._fused_adamw_" in (ROOT / "chip_smoke.py").read_text()


def test_no_library_dequantize_in_the_port():
    """The port's blockwise dequantize is its own kernel: no file of the
    package builds PyTorch's per-channel quantized tensors (chip_smoke.py
    times their `dequantize` beside the kernel as a yardstick, and only
    there)."""
    name = "_make_per_channel_quantized_tensor"
    named = [str(path.relative_to(ROOT))
             for path in sorted((ROOT / "hetu_tpu_torch").rglob("*"))
             if path.suffix in (".py", ".cu", ".cuh")
             and name in path.read_text()]
    assert named == []
    assert name in (ROOT / "chip_smoke.py").read_text()


def test_no_library_norm_in_the_port():
    """The port's fused residual norms are its own kernels: no file of
    the package calls PyTorch's `layer_norm` or `rms_norm` (chip_smoke.py
    times `x + h` and them in one CUDA graph beside the kernels as a
    yardstick, and only there)."""
    names = ("F.layer_norm", "F.rms_norm", "functional.layer_norm",
             "functional.rms_norm", "torch.layer_norm", "torch.rms_norm")
    named = [str(path.relative_to(ROOT))
             for path in sorted((ROOT / "hetu_tpu_torch").rglob("*"))
             if path.suffix in (".py", ".cu", ".cuh")
             and any(n in path.read_text() for n in names)]
    assert named == []
    smoke = (ROOT / "chip_smoke.py").read_text()
    assert "F.layer_norm" in smoke and "F.rms_norm" in smoke


def test_no_library_product_in_the_sampler():
    """The sampler's LM-head product is its own kernel: no file of the
    package calls `torch.mm` (chip_smoke.py times `torch.mm` with an
    fp32 output beside the kernel as a yardstick, and only there)."""
    named = [str(path.relative_to(ROOT))
             for path in sorted((ROOT / "hetu_tpu_torch").rglob("*"))
             if path.suffix in (".py", ".cu", ".cuh")
             and "torch.mm(" in path.read_text()]
    assert named == []
    assert "torch.mm(x, w, out_dtype=torch.float32)" in (
        ROOT / "chip_smoke.py").read_text()


def test_cpu_gpt_training_and_serving_build_nothing(monkeypatch):
    """A GPT Trainer step and a GPT engine run on the CPU take every
    kernel's plain version (the LayerNorm arm's too) and never ask for a
    build or a library."""
    from hetu_tpu_torch.models.gpt import GPTConfig, GPTLMHeadModel
    calls = []
    monkeypatch.setattr(build, "build", lambda *a, **k: calls.append(a))
    monkeypatch.setattr(build, "library", lambda *a, **k: calls.append(a))
    model = GPTLMHeadModel(GPTConfig.tiny(), device="cpu")
    tr = Trainer(model, TrainingConfig(global_batch_size=2,
                                       micro_batch_size=1, seq_len=8),
                 device="cpu")
    ids = np.arange(16, dtype=np.int32).reshape(2, 8)
    tr.train([{"input_ids": ids, "labels": ids}], num_steps=1)
    eng = ServingEngine(model, ServeConfig(num_slots=2, page_size=4,
                                           max_len=32, prefill_chunk=8,
                                           kv_quant="int8"),
                        device="cpu")
    out = eng.run([Request(rid=0, prompt=np.arange(1, 12, dtype=np.int32),
                           max_new_tokens=3)])
    assert tr.global_step == 1 and len(out[0].tokens) == 3
    assert calls == []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GPTLMHeadModel(GPTConfig.tiny())


@pytest.mark.parametrize("flash,policy", [(False, "nothing"),
                                          (True, "dots_attn")])
def test_cpu_training_builds_nothing(monkeypatch, flash, policy):
    """A Trainer on the CPU runs every kernel's plain version, forward
    and backward — with `flash`, the flash kernels' too, under the
    recompute policy that keeps their output — and never asks for a
    build or a library."""
    calls = []
    monkeypatch.setattr(build, "build", lambda *a, **k: calls.append(a))
    monkeypatch.setattr(build, "library", lambda *a, **k: calls.append(a))
    model = LlamaLMHeadModel(LlamaConfig.tiny(remat_policy=policy),
                             device="cpu")
    if flash:       # the CPU's own route is the dense attention
        for layer in model.model.layers:
            layer.attn.use_pallas = True
    tr = Trainer(model, TrainingConfig(global_batch_size=2,
                                       micro_batch_size=1, seq_len=8),
                 device="cpu")
    ids = np.arange(16, dtype=np.int32).reshape(2, 8)
    tr.train([{"input_ids": ids, "labels": ids}], num_steps=1)
    assert tr.global_step == 1
    assert calls == []


def test_default_device_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LlamaLMHeadModel(LlamaConfig.tiny())
    model = LlamaLMHeadModel(LlamaConfig.tiny(), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(model)


def test_engine_refuses_a_model_on_another_device():
    model = LlamaLMHeadModel(LlamaConfig.tiny(), device="cpu")
    with pytest.raises(ValueError):
        ServingEngine(model, device="meta")


def test_model_draws_its_weights_from_the_seed():
    a = LlamaLMHeadModel(LlamaConfig.tiny(), device="cpu", seed=5)
    b = LlamaLMHeadModel(LlamaConfig.tiny(), device="cpu", seed=5)
    c = LlamaLMHeadModel(LlamaConfig.tiny(), device="cpu", seed=6)
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                 b.parameters()))
    assert not torch.equal(a.model.embed.weight, c.model.embed.weight)
    assert a.config.num_params() == sum(p.numel() for p in a.parameters())


def test_lora_sft_defaults_to_the_card_and_builds_nothing_on_the_cpu(
        monkeypatch):
    """`SFTTrainer` and `load_experiment` run on the card unless asked
    for the CPU, and raise without one; a LoRA SFT step with every hook
    flag on, on the CPU, takes the plain versions and asks for no
    build."""
    from hetu_tpu_torch.engine import SFTTrainer
    from hetu_tpu_torch.peft import LoRAConfig
    from hetu_tpu_torch.utils.yaml_config import load_experiment
    calls = []
    monkeypatch.setattr(build, "build", lambda *a, **k: calls.append(a))
    monkeypatch.setattr(build, "library", lambda *a, **k: calls.append(a))
    for flag in ("HEALTH", "NUMERICS"):
        monkeypatch.setenv(f"HETU_TORCH_{flag}", "1")
    model = LlamaLMHeadModel(LlamaConfig.tiny(), device="cpu")
    tr = SFTTrainer(model, TrainingConfig(global_batch_size=2,
                                          micro_batch_size=1, seq_len=8),
                    lora=LoRAConfig(rank=2), device="cpu")
    ids = np.arange(16, dtype=np.int32).reshape(2, 8)
    tr.train([{"input_ids": ids, "labels": ids}], num_steps=1)
    assert tr.global_step == 1 and calls == []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SFTTrainer(model, TrainingConfig(), lora=LoRAConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_experiment({"model": {"family": "llama", "preset": "tiny"}})


def test_grad_scaler_defaults_to_the_card(monkeypatch):
    """`GradScaler.init()` puts the scale state on the card unless the
    caller asks for the CPU, and raises where there is no card."""
    from hetu_tpu_torch.optim.grad_scaler import GradScaler
    assert GradScaler().init(device="cpu")["scale"].device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GradScaler().init()


def test_serving_host_entry_points_default_to_the_card(monkeypatch):
    """The disaggregated prefill tier runs on the card unless asked for
    the CPU, and every serving host path on the CPU (the two-tier
    pipeline on every wire, the frontend) builds nothing."""
    from hetu_tpu_torch.serving import (DisaggCoordinator, Frontend,
                                        PrefillWorker)
    calls = []
    monkeypatch.setattr(build, "build", lambda *a, **k: calls.append(a))
    monkeypatch.setattr(build, "library", lambda *a, **k: calls.append(a))
    model = LlamaLMHeadModel(LlamaConfig.tiny(), device="cpu")
    cfg = ServeConfig(num_slots=2, max_len=32, prefill_chunk=8,
                      kv_quant="int8", preempt=True, retry_budget=1)
    prompt = np.arange(1, 12, dtype=np.int32)
    for wire in ("none", "int8", "int4"):
        eng = ServingEngine(model, cfg, device="cpu")
        coord = DisaggCoordinator(
            PrefillWorker(model, prefill_chunk=8, max_len=32, device="cpu"),
            eng, ship_quant=wire)
        assert len(coord.run([Request(rid=0, prompt=prompt,
                                      max_new_tokens=3)])) == 1
    fe = Frontend([ServingEngine(model, cfg, device="cpu")
                   for _ in range(2)])
    assert len(fe.run([Request(rid=i, prompt=prompt, max_new_tokens=2)
                       for i in range(3)])) == 3
    assert calls == []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PrefillWorker(model, prefill_chunk=8, max_len=32)
