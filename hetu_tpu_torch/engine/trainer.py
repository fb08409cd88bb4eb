"""Trainer, the port of `hetu_tpu/engine/trainer.py` for one device.

    trainer = Trainer(model, TrainingConfig(...), device="cuda")
    metrics = trainer.train(batches, num_steps)

A step, as the reference's `_train_step_impl`:

  * the host batch [global_batch, seq] splits into micro-batches
    (`prepare_batch`);
  * each micro-batch runs the model's training forward with the "sum"
    loss — and, with `dropout_deterministic=False`, dropout keyed by
    (seed + 1, step, micro-batch) — and its backward; with the dynamic
    loss scale on the fp32 loss sum is multiplied by scale / slots first
    (slots = the batch's token slots), so the cotangents do not grow
    with the batch.  The scale is on under `loss_scale="dynamic"`, and
    under "auto" (the default) iff the model computes in float16, as
    the reference decides it;
  * gradients accumulate in fp32: in the parameters' .grad when they
    are fp32, else in fp32 accumulators beside them, each micro-batch's
    gradient added in (the reference's `jnp.add` on an fp32 zero tree);
    the whole batch weighs every token alike, not a mean of means.  A
    bf16 or fp16 parameter's own .grad is in its dtype, as the
    reference's gradient is: under a large scale an fp16 .grad can
    overflow before it is added, and the inf it carries into the
    accumulator is what the finite check below sees;
  * the sums are divided by the token count (times the scale: the
    unscale folded in), clipped by their global norm
    (`optim.clip_by_global_norm`) and applied by AdamW with the cosine
    schedule (`optim.AdamW`, one launch of the fused kernel over every
    leaf, the bf16 and fp16 arms for bf16 and fp16 parameters), all in
    place;
  * under the scale, the global norm's finiteness — the one
    reduction that already runs over every gradient — decides the step:
    the AdamW launch reads it on the device and writes nothing when it
    is not finite (p, m and v keep their bits), the `GradScaler` state
    grows or backs off on the device, and the host learns of it one step
    later: the flag and the scale are copied to pinned memory without
    waiting, and read when the next update is enqueued (`settle`), which
    takes the skipped step back from AdamW's step count, sets the
    scaler.loss_scale gauge and counts scaler.growth / scaler.backoff.
    Differs from the reference's element-wise check in one corner: a
    finite gradient whose squares overflow fp32 (|g| past ~1.8e19)
    counts as non-finite.

`train_step` returns its metrics (loss, grad_norm, lr, and with the
scaler loss_scale and amp_skipped) as tensors and never waits for the
card; `train` reads the loss, which waits, only every `log_every`
steps, and saves a checkpoint every `ckpt_every` steps when `ckpt_dir`
is set.  `state`, `save`, `restore` (retrying with the scaler's
presence toggled, as the reference does), `restore_latest_valid` and
`evaluate` (token-weighted cross-entropy and perplexity) are the
reference's.  The trainer writes trainer.steps / trainer.tokens
counters, the trainer.step_time_s histogram, the scaler and the
checkpoint series into its own `MetricsRegistry` (`trainer.registry`).

A batch may be padded or packed (`data.pad_batch`, `pack_sequences`,
`DataCollatorForLanguageModel`): its `position_ids` and `segment_ids`
go to the model, whose attention keeps each packed sequence to itself
and whose positions restart with each.  A micro-batch may count zero
tokens (rows of padding alone): the step divides by at least one.

The hooks are the reference's, driven by its flags (read once, when
the trainer is made):

  * the run log (`obs.runlog.RunLog`, at HETU_TORCH_RUNLOG or
    `<ckpt_dir>/runlog.jsonl`): a `step` record every step, with the
    loss when the loop read it (log boundaries; every step under
    HETU_TORCH_HEALTH) and device memory (`torch.cuda.memory_allocated`)
    on log boundaries only; a `scaler` record for each growth or
    backoff of the scale (when `settle` reads it); a `fault` record for
    each checkpoint `restore_latest_valid` walks past; a `summary` when
    `train` ends;
  * HETU_TORCH_HEALTH: `obs.health.HealthMonitor.observe_step` every
    step (the loss and grad norm read each step: the one per-step wait
    the flag opts into), and on a non-finite loss or grad norm an
    emergency `save(wait=True)` when checkpoints are configured
    (best-effort, never raising);
  * HETU_TORCH_NUMERICS: a numerics collector around each step — the
    model's "embed", "hidden" and "logits" taps per micro-batch, folded
    by each stat's rule; "params" and "grads" (the token-divided
    gradients, before the clip) and "scaler"; AdamW's "update" and
    "adam_m" — recorded every HETU_TORCH_NUMERICS_EVERY steps (a wait
    for the card) and fed to the numerics health monitor.

With every flag unset none of them runs, and a step launches what it
launched without them; only a `ckpt_dir` opens the run log beside the
checkpoints, as the reference's does (host records: no wait, no device
operation).  The trainable parameters are the model's
(`_named_trainable`; `SFTTrainer` with LoRA: the adapters alone, the
base frozen, with no `.grad`); the taps, the clip and the checkpoints
cover them alone.

Parameters may be fp32, bf16 or fp16 (`LlamaConfig(param_dtype=)`);
bf16 and fp16 ones take the fp32 accumulators and the kernel's arm of
their dtype, and a checkpoint of another parameter dtype restores cast
to this one, as the reference's orbax restore casts.  The reference's
options that need a later slice raise NotImplementedError: those of
`TrainingConfig`, `LlamaConfig` and `GPTConfig` where they are made;
here a strategy or mesh.  The reference's `Trainer` has no `run_log`,
`health` or `numerics` keywords, and the port's none either.
"""
from __future__ import annotations

import logging
import math
import time
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from hetu_tpu_torch.engine.trainer_config import TrainingConfig
from hetu_tpu_torch.obs import numerics
from hetu_tpu_torch.obs.health import (maybe_health_monitor,
                                       maybe_numerics_health_monitor)
from hetu_tpu_torch.obs.metrics import MetricsRegistry
from hetu_tpu_torch.obs.runlog import RunLog, default_runlog_path
from hetu_tpu_torch.ops.activations import DropoutKey
from hetu_tpu_torch.optim.grad_scaler import GradScaler, classify_transition
from hetu_tpu_torch.optim.optimizer import (AdamW, clip_by_global_norm,
                                            cosine_schedule)
from hetu_tpu_torch.utils.checkpoint import CheckpointManager
from hetu_tpu_torch.utils.device import resolve_device

logger = logging.getLogger("hetu_tpu_torch.trainer")

_MULTI_GPU = "the multi-GPU slice (ROADMAP Queue A item 5)"

#: Trainer keyword arguments beyond this slice
_LATER_ARGS = {"strategy": _MULTI_GPU, "mesh": _MULTI_GPU}


class Trainer:
    """Single-device training of a `LlamaLMHeadModel` or a
    `GPTLMHeadModel` that lives on `device` ("cuda" by default: the CUDA
    kernels; "cpu": their plain versions).  The model's training
    forward takes (input_ids, labels, position_ids=, segment_ids=, rng=,
    deterministic=, loss_reduction="sum"; `evaluate` also
    include_aux_loss=False) and returns (loss sum, token count); an MoE
    model's sum holds its router aux loss times the count."""

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
        policy = model.config.policy
        self.model = model
        self.config = c = config
        self.n_micro = c.num_micro_batches(1)
        self.optimizer = AdamW(
            lr=cosine_schedule(c.lr, c.warmup_steps, c.total_steps,
                               c.min_lr_ratio),
            b1=c.beta1, b2=c.beta2, eps=c.eps, weight_decay=c.weight_decay,
            device=self.device)
        self.registry = MetricsRegistry()
        use_scaler = c.loss_scale == "dynamic" or (
            c.loss_scale == "auto"
            and policy.compute_dtype == torch.float16)
        self._scaler = GradScaler() if use_scaler else None
        self.scaler_state = None
        self._ckpt = (CheckpointManager(c.ckpt_dir, c.ckpt_keep,
                                        registry=self.registry)
                      if c.ckpt_dir else None)
        path = default_runlog_path(c.ckpt_dir)
        self.run_log = RunLog(path) if path else None
        self._health = maybe_health_monitor(
            runlog=self.run_log, registry=self.registry,
            emergency_hook=(self._health_emergency_save
                            if self._ckpt is not None else None))
        self._numerics = numerics.numerics_enabled()
        self._numerics_every = numerics.record_every()
        self._num_health = (maybe_numerics_health_monitor(
            runlog=self.run_log, registry=self.registry)
            if self._numerics else None)
        self.params = None
        self.opt_state = None
        self._accum = None
        self._pending = None
        self._pending_step = None
        self._last_loss_scale = None
        self.global_step = 0

    def _named_trainable(self):
        """(name, parameter) of what the trainer trains: every parameter
        of the model."""
        return list(self.model.named_parameters())

    def build(self):
        """Turn gradients on for the trainable parameters and create the
        optimizer state (fp32 moments) beside them, fp32 gradient
        accumulators for parameters stored below fp32, and the scaler's
        state."""
        named = self._named_trainable()
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        for p in self.params:
            p.requires_grad_(True)
        self.opt_state = self.optimizer.init(self.params)
        if any(p.dtype != torch.float32 for p in self.params):
            self._accum = [torch.zeros(p.shape, dtype=torch.float32,
                                       device=p.device)
                           for p in self.params]
        if self._scaler is not None:
            self.scaler_state = self._scaler.init(self.device)
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

    def _micro_grads(self, batches, rng, scale):
        """Each micro-batch's forward and backward, its gradients summed
        in fp32; returns (loss sum, token count)."""
        c = self.config
        lsum = csum = None
        frames = []
        for i in range(self.n_micro):
            mb = {k: v[i] for k, v in batches.items()}
            with numerics.frame() as nf:
                loss, count = self.model(
                    mb["input_ids"], mb["labels"],
                    position_ids=mb.get("position_ids"),
                    segment_ids=mb.get("segment_ids"),
                    rng=None if rng is None else rng.fold(i),
                    deterministic=c.dropout_deterministic,
                    loss_reduction="sum")
            frames.append(nf.stats)
            (loss if scale is None else loss.float() * scale).backward()
            if self._accum is not None:
                with torch.no_grad():
                    for acc, p in zip(self._accum, self.params):
                        if i == 0:
                            acc.copy_(p.grad)
                        else:
                            acc.add_(p.grad)
                        p.grad = None
            lsum = loss.detach() if lsum is None else lsum + loss.detach()
            csum = count if csum is None else csum + count
        # the model's taps, per micro-batch, folded by each stat's rule
        numerics.merge(numerics.reduce_stacked(numerics.stack(frames)))
        return lsum, csum

    def train_step(self, host_batch: Dict[str, np.ndarray]):
        """One optimizer step over the global batch.  Returns {"loss",
        "grad_norm", "lr"} (and with the scaler "loss_scale",
        "amp_skipped"; under HETU_TORCH_NUMERICS "numerics", the step's
        {scope: {stat: tensor}}) as 0-d tensors, without waiting for the
        card."""
        if self.params is None:
            self.build()
        if not self._numerics:
            return self._train_step(host_batch)
        with numerics.collecting() as col:
            metrics = self._train_step(host_batch)
            stats = col.finalize()
        if stats:
            metrics["numerics"] = stats
        return metrics

    def _train_step(self, host_batch):
        c = self.config
        batches = self.prepare_batch(host_batch)
        scale = None
        if self._scaler is not None:
            ids = batches["input_ids"]
            slots = float(ids.shape[0] * ids.shape[1]
                          * max(ids.shape[2] - 1, 1))
            scale = self.scaler_state["scale"] / slots
        rng = None if c.dropout_deterministic else DropoutKey(
            (c.seed + 1, self.global_step))
        lsum, csum = self._micro_grads(batches, rng, scale)
        denom = torch.clamp(csum, min=1.0)
        with torch.no_grad():
            grads = self._accum or [p.grad for p in self.params]
            div = denom if scale is None else denom * scale
            for g in grads:
                g.div_(div)
            if self._numerics:
                numerics.tap_tree("params", self.params)
                numerics.tap_tree("grads", grads)
                if scale is not None:
                    numerics.tap_stats("scaler",
                                       scale=self.scaler_state["scale"])
            grads, gnorm = clip_by_global_norm(grads, c.grad_clip)
            if self._ckpt is not None:
                self._ckpt.fence()
            metrics = {"loss": lsum / denom}
            if self._scaler is None:
                self.optimizer.update(grads, self.opt_state, self.params)
                metrics["grad_norm"] = gnorm
                lr = torch.tensor(self.optimizer._lr(self.opt_state["step"]),
                                  dtype=torch.float32)
            else:
                lr = self._scaled_update(grads, gnorm, metrics)
            metrics["lr"] = lr
        for p in self.params:
            p.grad = None
        self.global_step += 1
        return metrics

    def _scaled_update(self, grads, gnorm, metrics):
        """The dynamic-scale update (module docstring); fills metrics and
        returns the lr tensor."""
        finite = torch.isfinite(gnorm)
        self.settle()
        step = self.opt_state["step"]
        self.optimizer.update(grads, self.opt_state, self.params,
                              skip=(~finite).to(torch.int32))
        self.scaler_state = self._scaler.update(self.scaler_state, finite)
        flag_and_scale = torch.stack([finite.float(),
                                      self.scaler_state["scale"]])
        if self.device.type == "cuda":
            host = torch.empty(2, dtype=torch.float32, pin_memory=True)
            host.copy_(flag_and_scale, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        else:
            host, event = flag_and_scale.clone(), None
        self._pending = (host, event)
        self._pending_step = self.global_step + 1
        metrics["grad_norm"] = torch.where(
            finite, gnorm, torch.full_like(gnorm, math.nan))
        metrics["loss_scale"] = self.scaler_state["scale"]
        metrics["amp_skipped"] = 1.0 - finite.float()
        # filled on the device: a host tensor copied there would wait
        lr_new, lr_old = (torch.full((), self.optimizer._lr(s),
                                     dtype=torch.float32,
                                     device=finite.device)
                          for s in (step + 1, step))
        return torch.where(finite, lr_new, lr_old)

    def settle(self):
        """Read the last scaled step's finite flag and scale (a wait for
        that step alone): take a skipped update back from AdamW's step
        count, set the scaler.loss_scale gauge and count a
        scaler.growth / scaler.backoff transition (and log it as a
        `scaler` run-log record).  A no-op when nothing is pending."""
        if self._pending is None:
            return
        host, event = self._pending
        self._pending = None
        if event is not None:
            event.synchronize()
        finite, scale = (float(v) for v in host.tolist())
        if not finite:
            self.opt_state["step"] -= 1
        self.registry.set_gauge("scaler.loss_scale", scale)
        event_name = classify_transition(self._last_loss_scale, scale)
        if event_name is not None:
            self.registry.inc(f"scaler.{event_name}")
            if self.run_log is not None:
                self.run_log.log("scaler", event=event_name, scale=scale,
                                 prev=self._last_loss_scale,
                                 step=self._pending_step)
        self._last_loss_scale = scale

    def train(self, batches: Iterable[Dict[str, np.ndarray]],
              num_steps: Optional[int] = None):
        """The step loop; returns the last step's metrics.  On a
        `log_every` boundary, and every step under HETU_TORCH_HEALTH, it
        reads the loss (a wait for the card), so that step's time in
        trainer.step_time_s includes the card's work; otherwise it is
        the host's time to enqueue the step.  The hooks run after the
        step (module docstring)."""
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
            loss = None
            if log_boundary or self._health is not None:
                loss = float(metrics["loss"])
            step_s = time.perf_counter() - t_step
            batch_tokens = int(np.prod(np.shape(host_batch["input_ids"])))
            tokens += batch_tokens
            self.registry.inc("trainer.steps")
            self.registry.inc("trainer.tokens", batch_tokens)
            self.registry.observe("trainer.step_time_s", step_s)
            nstats = metrics.pop("numerics", None)
            if (nstats is not None
                    and self.global_step % self._numerics_every == 0):
                rec = numerics.record(nstats, step=self.global_step,
                                      registry=self.registry,
                                      runlog=self.run_log)
                if self._num_health is not None and rec is not None:
                    self._num_health.observe(self.global_step,
                                             rec["scopes"])
            if self._health is not None:
                self._health.observe_step(
                    self.global_step, step_s, loss=loss,
                    grad_norm=float(metrics["grad_norm"]))
            if log_boundary:
                dt = time.perf_counter() - t0
                logger.info(
                    f"step {self.global_step} loss {loss:.4f} "
                    f"lr {float(metrics['lr']):.2e} "
                    f"grad_norm {float(metrics['grad_norm']):.3f} "
                    f"tokens/s {tokens / max(dt, 1e-9):,.0f}")
                t0, tokens = time.perf_counter(), 0
            if self.run_log is not None:
                self.run_log.step(
                    self.global_step, step_s, loss=loss,
                    tokens_per_s=batch_tokens / max(step_s, 1e-9),
                    device_mem_bytes=(self._device_mem_bytes()
                                      if log_boundary else None),
                    plan=self._plan(host_batch))
            if self._ckpt is not None and self.global_step % c.ckpt_every == 0:
                self.save()
        self.settle()
        if self.run_log is not None:
            self.run_log.log("summary", metrics=self.registry.snapshot())
        return metrics

    def _device_mem_bytes(self) -> Optional[int]:
        """Device memory allocated by PyTorch (None on the CPU)."""
        if self.device.type != "cuda":
            return None
        return torch.cuda.memory_allocated(self.device)

    @staticmethod
    def _plan(host_batch) -> str:
        """The step's plan, as the reference fingerprints it: the
        strategy ("single": one device) and the batch shapes."""
        shapes = ",".join(f"{k}:{'x'.join(map(str, np.shape(v)))}"
                          for k, v in sorted(host_batch.items()))
        return f"single|{shapes}"

    def _health_emergency_save(self):
        """The health monitor's emergency hook on a non-finite loss or
        grad norm: a checkpoint now, written before returning."""
        self.save(wait=True)

    def close(self):
        """Write a `summary` record and close the run log.  Safe to call
        more than once; training after it leaves no run events."""
        if self.run_log is not None:
            self.run_log.log("summary", metrics=self.registry.snapshot())
            self.run_log.close()

    # ------------------------------------------------------------------
    def evaluate(self, batches: Iterable[Dict[str, np.ndarray]],
                 max_batches: Optional[int] = None) -> Dict[str, float]:
        """Token-weighted cross-entropy over whole batches [rows, seq]
        (no dropout, no graph; an MoE model's router aux loss left out,
        as the reference's) and its perplexity."""
        if self.params is None:
            self.build()
        total, count = 0.0, 0.0
        for i, host_batch in enumerate(batches):
            if max_batches is not None and i >= max_batches:
                break
            batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(
                self.device) for k, v in host_batch.items()}
            with torch.no_grad():
                lsum, csum = self.model(
                    batch["input_ids"], batch["labels"],
                    position_ids=batch.get("position_ids"),
                    segment_ids=batch.get("segment_ids"),
                    loss_reduction="sum", include_aux_loss=False)
            total += float(lsum)
            count += float(csum)
        loss = total / max(count, 1.0)
        return {"loss": loss, "perplexity": float(np.exp(min(loss, 30.0))),
                "tokens": count}

    # ------------------------------------------------------------------
    def state(self):
        """The resumable state: the step, the parameters and AdamW's fp32
        moments by parameter name, and the scaler's state when it is on
        (live tensors: a save copies them)."""
        if self.params is None:
            self.build()
        self.settle()
        s = {"params": dict(zip(self.names, self.params)),
             "opt_state": {"step": self.opt_state["step"],
                           "m": dict(zip(self.names, self.opt_state["m"])),
                           "v": dict(zip(self.names, self.opt_state["v"]))},
             "step": self.global_step}
        if self.scaler_state is not None:
            s["scaler"] = self.scaler_state
        return s

    def _manager(self) -> CheckpointManager:
        if self._ckpt is None:
            raise ValueError("no ckpt_dir configured")
        return self._ckpt

    def save(self, wait: bool = False):
        """Checkpoint `state()` as the current step; in the background
        unless `wait`."""
        self._manager().save(self.global_step, self.state(), wait=wait)

    def restore(self, step: Optional[int] = None):
        """Resume from checkpoint `step` (the latest by default), into
        the live tensors, a saved tensor of another float dtype cast to
        the live one's (a bf16-parameter checkpoint into an fp16 run).
        When the scaler's presence differs between the checkpoint and
        this trainer, retry with it toggled: a missing scaler keeps its
        fresh state."""
        mgr = self._manager()
        target = self.state()
        try:
            restored = mgr.restore(step, target=target)
        except ValueError:
            if "scaler" in target:
                target = {k: v for k, v in target.items() if k != "scaler"}
            else:
                target = dict(target, scaler=GradScaler().init(self.device))
            restored = mgr.restore(step, target=target)
        self.opt_state["step"] = int(restored["opt_state"]["step"])
        self.global_step = int(restored["step"])
        self._last_loss_scale = None
        return self

    def restore_latest_valid(self):
        """Resume from the newest checkpoint that verifies, walking back
        past corrupt or torn saves (each counts ckpt.fallbacks and leaves
        a `fault` run-log record; checksum failures are quarantined),
        through `restore`.  FileNotFoundError when there is none,
        `CheckpointCorruptError` when none restores."""

        def note_fallback(step, why):
            if self.run_log is not None:
                self.run_log.log("fault", fault="ckpt_corrupt", step=step,
                                 detail=why)

        self._manager().restore_latest_valid(restore_fn=self.restore,
                                             on_fallback=note_fallback)
        return self
