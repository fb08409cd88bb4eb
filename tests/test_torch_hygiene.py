"""Import and device hygiene of the PyTorch port (hetu_tpu_torch).

The port imports torch and numpy only: never jax, never the JAX package
(importing any `hetu_tpu` module runs its package `__init__`, which
loads JAX).  Importing it builds nothing.  Its entry points run on the
card unless the caller asks for the CPU, and raise where there is no
card.
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
             if n == "jax" or n.startswith("jax.")
             or n == "hetu_tpu" or n.startswith("hetu_tpu."))
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
                 "hetu_tpu_torch.serving.spec_decode"):
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
    {"sampling": True, "kv_quant": "int4"}])
def test_cpu_sampled_spec_and_quantized_serving_builds_nothing(monkeypatch,
                                                               opts):
    """The same through the sampler, the verify step and quantized
    pages."""
    calls = []
    monkeypatch.setattr(build, "build", lambda *a, **k: calls.append(a))
    monkeypatch.setattr(build, "library", lambda *a, **k: calls.append(a))
    model = LlamaLMHeadModel(LlamaConfig.tiny(), device="cpu")
    eng = ServingEngine(model, ServeConfig(num_slots=2, max_len=32,
                                           prefill_chunk=8, **opts),
                        device="cpu")
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
