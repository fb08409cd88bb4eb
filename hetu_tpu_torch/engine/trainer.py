"""Trainer, the port of `hetu_tpu/engine/trainer.py` for one device.

    trainer = Trainer(model, TrainingConfig(...), device="cuda")
    metrics = trainer.train(batches, num_steps)

A step, as the reference's `_train_step_impl` with no scaler:

  * the host batch [global_batch, seq] splits into micro-batches
    (`prepare_batch`);
  * each micro-batch runs the model's training forward with the "sum"
    loss and its backward; gradients accumulate in the fp32 parameters'
    .grad, so the whole batch weighs every token alike, not a mean of
    means;
  * the accumulated gradients are divided by the batch's token count,
    clipped by their global norm (`optim.clip_by_global_norm`) and
    applied by AdamW with the cosine schedule (`optim.AdamW`, the fused
    update kernel on every leaf), all in place.

`train_step` returns its metrics (loss, grad_norm, lr) as tensors and
never waits for the card; `train` reads the loss, which waits, only
every `log_every` steps, as the reference does.  The trainer writes
trainer.steps / trainer.tokens counters and the trainer.step_time_s
histogram into its own `MetricsRegistry` (`trainer.registry`).

The reference's options that need a later slice raise
NotImplementedError: those of `TrainingConfig`, `LlamaConfig` and
`GPTConfig` where they are made; here a strategy or mesh, the run-log, health and
numerics hooks, fp16 compute and parameters stored below fp32.
"""
from __future__ import annotations

import logging
import time
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from hetu_tpu_torch.engine.trainer_config import TrainingConfig
from hetu_tpu_torch.obs.metrics import MetricsRegistry
from hetu_tpu_torch.optim.optimizer import (AdamW, clip_by_global_norm,
                                            cosine_schedule)
from hetu_tpu_torch.utils.device import resolve_device

logger = logging.getLogger("hetu_tpu_torch.trainer")

_TRAINING_3 = "the third training slice (ROADMAP Queue A item 2)"
_MULTI_GPU = "the multi-GPU slice (ROADMAP Queue A item 5)"

#: Trainer keyword arguments beyond this slice
_LATER_ARGS = {"strategy": _MULTI_GPU, "mesh": _MULTI_GPU,
               "run_log": _TRAINING_3, "health": _TRAINING_3,
               "numerics": _TRAINING_3}


class Trainer:
    """Single-device training of a `LlamaLMHeadModel` or a
    `GPTLMHeadModel` that lives on `device` ("cuda" by default: the CUDA
    kernels; "cpu": their plain versions).  The model's training
    forward takes (input_ids, labels, position_ids=, segment_ids=,
    loss_reduction="sum") and returns (loss sum, token count)."""

    def __init__(self, model, config: TrainingConfig, *, device="cuda",
                 **later):
        for name in later:
            if name not in _LATER_ARGS:
                raise TypeError(f"Trainer got an unexpected keyword "
                                f"argument {name!r}")
            raise NotImplementedError(
                f"Trainer({name}=...) is not in the port yet; it arrives "
                f"with {_LATER_ARGS[name]}")
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"the model lives on {model.device}, the "
                             f"trainer was asked for {self.device}")
        if (config.loss_scale == "auto"
                and model.config.compute_dtype == torch.float16):
            raise NotImplementedError(
                "fp16 compute needs the dynamic GradScaler, which is not "
                f"in the port yet; it arrives with {_TRAINING_3}")
        if model.config.param_dtype != torch.float32:
            raise NotImplementedError(
                f"param_dtype={model.config.param_dtype} needs fp32 gradient "
                f"accumulators beside the parameters, which are not in the "
                f"port yet; it arrives with {_TRAINING_3}")
        self.model = model
        self.config = c = config
        self.n_micro = c.num_micro_batches(1)
        self.optimizer = AdamW(
            lr=cosine_schedule(c.lr, c.warmup_steps, c.total_steps,
                               c.min_lr_ratio),
            b1=c.beta1, b2=c.beta2, eps=c.eps, weight_decay=c.weight_decay,
            device=self.device)
        self.registry = MetricsRegistry()
        self.params = None
        self.opt_state = None
        self.global_step = 0

    def build(self):
        """Turn gradients on for the model's parameters and create the
        optimizer state (fp32 moments) beside them."""
        self.params = list(self.model.parameters())
        for p in self.params:
            p.requires_grad_(True)
        self.opt_state = self.optimizer.init(self.params)
        return self

    def prepare_batch(self, host_batch: Dict[str, np.ndarray]):
        """{key: [global_batch, seq]} host arrays -> {key: [n_micro,
        micro_batch, seq]} tensors on the device (copied without waiting
        for the card)."""
        out = {}
        for k, v in host_batch.items():
            v = np.asarray(v)
            if v.shape[0] != self.config.global_batch_size:
                raise ValueError(f"batch[{k!r}] has {v.shape[0]} rows, the "
                                 f"config's global_batch_size is "
                                 f"{self.config.global_batch_size}")
            t = torch.from_numpy(np.ascontiguousarray(
                v.reshape(self.n_micro, -1, *v.shape[1:])))
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[k] = t
        return out

    def train_step(self, host_batch: Dict[str, np.ndarray]):
        """One optimizer step over the global batch.  Returns {"loss",
        "grad_norm", "lr"} as 0-d tensors, without waiting for the card."""
        if self.params is None:
            self.build()
        batches = self.prepare_batch(host_batch)
        lsum = csum = None
        for i in range(self.n_micro):
            mb = {k: v[i] for k, v in batches.items()}
            loss, count = self.model(
                mb["input_ids"], mb["labels"],
                position_ids=mb.get("position_ids"),
                segment_ids=mb.get("segment_ids"), loss_reduction="sum")
            loss.backward()
            lsum = loss.detach() if lsum is None else lsum + loss.detach()
            csum = count if csum is None else csum + count
        denom = torch.clamp(csum, min=1.0)
        with torch.no_grad():
            grads = [p.grad for p in self.params]
            for g in grads:
                g.div_(denom)
            grads, gnorm = clip_by_global_norm(grads, self.config.grad_clip)
            self.optimizer.update(grads, self.opt_state, self.params)
        for p in self.params:
            p.grad = None
        self.global_step += 1
        lr = self.optimizer._lr(self.opt_state["step"])
        return {"loss": lsum / denom, "grad_norm": gnorm,
                "lr": torch.tensor(lr, dtype=torch.float32)}

    def train(self, batches: Iterable[Dict[str, np.ndarray]],
              num_steps: Optional[int] = None):
        """The step loop; returns the last step's metrics.  On a
        `log_every` boundary it reads the loss (a wait for the card), so
        that step's time in trainer.step_time_s includes the card's work;
        between boundaries it is the host's time to enqueue the step."""
        c = self.config
        if self.params is None:
            self.build()
        t0 = time.perf_counter()
        tokens = 0
        metrics = {}
        for i, host_batch in enumerate(batches):
            if num_steps is not None and i >= num_steps:
                break
            t_step = time.perf_counter()
            metrics = self.train_step(host_batch)
            log_boundary = self.global_step % c.log_every == 0
            if log_boundary:
                loss = float(metrics["loss"])
            step_s = time.perf_counter() - t_step
            batch_tokens = int(np.prod(np.shape(host_batch["input_ids"])))
            tokens += batch_tokens
            self.registry.inc("trainer.steps")
            self.registry.inc("trainer.tokens", batch_tokens)
            self.registry.observe("trainer.step_time_s", step_s)
            if log_boundary:
                dt = time.perf_counter() - t0
                logger.info(
                    f"step {self.global_step} loss {loss:.4f} "
                    f"lr {float(metrics['lr']):.2e} "
                    f"grad_norm {float(metrics['grad_norm']):.3f} "
                    f"tokens/s {tokens / max(dt, 1e-9):,.0f}")
                t0, tokens = time.perf_counter(), 0
        return metrics
