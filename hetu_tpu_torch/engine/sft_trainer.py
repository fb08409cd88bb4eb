"""Supervised fine-tuning, the port of `hetu_tpu/engine/sft_trainer.py`:
the next-token loss on response tokens only, and with LoRA the frozen
base plus trainable adapters.

    trainer = SFTTrainer(model, TrainingConfig(...),
                         lora=LoRAConfig(rank=16), device="cuda")
    trainer.train(batches, num_steps)   # labels from mask_prompt_labels

With `lora`, the model is wrapped in a `peft.LoRAWrappedModel` whose
adapters are drawn from `TrainingConfig.seed`, as the reference's
`Trainer.build` draws them; only the adapters take gradients, fp32
gradient accumulators (none: they are fp32), AdamW moments (AdamW's
fp32 arm), the clip and the `params` / `grads` numerics taps; the
base's parameters get requires_grad False and never a `.grad`.  The
base may be fp32, bf16 or fp16 (Llama-2 as published): the adapters
stay fp32, each merge rounds its delta to the base's dtype, and with
fp16 compute the loss scale is on under "auto" (the reference's
decides from its LoRA wrapper, which has no config, and leaves it off:
ROADMAP Queue C).  Checkpoints hold the adapters (names `lora.<the
reference's leaf path>/A|B`), their moments and the step.  A port
model holds its own weights, so the reference's `base_params=` has no
counterpart and is refused with TypeError.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from hetu_tpu_torch.engine.trainer import Trainer
from hetu_tpu_torch.engine.trainer_config import TrainingConfig
from hetu_tpu_torch.peft.lora import LoRAConfig, LoRAWrappedModel


def mask_prompt_labels(input_ids: np.ndarray, prompt_lens: Sequence[int],
                       seq_lens: Optional[Sequence[int]] = None,
                       pad_id: Optional[int] = 0) -> np.ndarray:
    """labels with prompt positions and padding set to -100 — only response
    tokens contribute loss (the SFT objective).

    Padding is masked by position: via `seq_lens` when given (exact), else
    by the trailing run of `pad_id` with its first element kept — when
    eos == pad (the common GPT-2/LLaMA setup) that first trailing token is
    the response's terminating eos, which must keep its loss so the model
    learns to stop."""
    ids = np.asarray(input_ids)
    labels = ids.astype(np.int32).copy()
    n, L = labels.shape
    for i, plen in enumerate(prompt_lens):
        labels[i, :plen] = -100
    if seq_lens is not None:
        for i, slen in enumerate(seq_lens):
            labels[i, slen:] = -100
    elif pad_id is not None:
        for i in range(n):
            j = L
            while j > 0 and ids[i, j - 1] == pad_id:
                j -= 1
            # keep position j (the presumed eos terminator) when a run exists
            keep_eos = j < L and j > int(prompt_lens[i])
            labels[i, (j + 1 if keep_eos else j):] = -100
    return labels


class SFTTrainer(Trainer):
    """Trainer whose batches carry prompt-masked labels; with `lora`, the
    base model is frozen and only its adapters (and their small
    optimizer state) train."""

    def __init__(self, model, config: TrainingConfig, strategy=None,
                 lora: Optional[LoRAConfig] = None, *, device="cuda", **kw):
        if "base_params" in kw:
            raise TypeError(
                "SFTTrainer(base_params=...) has no counterpart in the "
                "port: a port model holds its own weights, so pass the "
                "base model alone")
        if strategy is not None:
            kw["strategy"] = strategy
        self.lora_cfg = lora
        if lora is not None:
            model = LoRAWrappedModel(model, lora, seed=config.seed)
        super().__init__(model, config, device=device, **kw)

    def _named_trainable(self):
        if self.lora_cfg is None:
            return super()._named_trainable()
        return [(f"lora.{n}", p)
                for n, p in self.model.lora.named_parameters()]

    def train_step(self, host_batch: Dict[str, np.ndarray]):
        """Counts the label slots that carry loss (`sft.loss_tokens`) and
        those masked (`sft.masked_tokens`), so a run whose response
        share collapses (bad masking, over-padding) shows in the
        registry."""
        labels = host_batch.get("labels")
        if labels is not None:
            lab = np.asarray(labels)
            masked = int((lab == -100).sum())
            self.registry.inc("sft.masked_tokens", masked)
            self.registry.inc("sft.loss_tokens", int(lab.size - masked))
        return super().train_step(host_batch)
