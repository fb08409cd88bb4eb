"""SFT message templates + chat rendering with exact loss masks.

Rebuild of the reference's message layer (reference: python/hetu/data/
messages/{message_template,prompt_template,utils}.py — dataset-sample ->
message-list templates, and a jinja renderer that TRACKS character spans to
recover which tokens are maskable).  Same surface, different mechanism:
messages are tokenized ONE AT A TIME and concatenated, so the mask is exact
by construction — no rendered-string position tracking needed — and the
result is collator/scheduler-ready (labels use -100 on masked spans, the
convention every loss in ops.losses honors).

Templates convert one dataset sample into [{role, content, masked}, ...]:
  * InputOutputTemplate — {input, output} -> user/assistant turns
  * AlpacaTemplate      — {instruction, input?, output} in the Alpaca prompt
  * ShareGPTTemplate    — {conversations: [{from, value}, ...]}
  * OpenAITemplate      — {messages: [{role, content}, ...]}
masked=True turns contribute tokens but not loss (train_on_input=False).

The port's copy of `hetu_tpu/data/messages.py`, unchanged but for its
imports (host code: the port never imports the JAX package).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np

Role = str
Message = Dict[str, Any]   # {"role", "content", "masked"}


def _msg(role: Role, content: str, masked: bool) -> Message:
    return {"role": role, "content": content, "masked": masked}


class InputOutputTemplate:
    """{input, output} -> a user/assistant exchange (reference:
    message_template.py InputOutputTemplate)."""

    def __init__(self, train_on_input: bool = False,
                 column_map: Optional[Dict[str, str]] = None,
                 new_system_prompt: Optional[str] = None):
        self.train_on_input = train_on_input
        # partial maps remap only the named columns (same .get(k, k)
        # fallback as every sibling template)
        self.column_map = column_map or {}
        self.new_system_prompt = new_system_prompt

    def __call__(self, sample: Mapping[str, Any]) -> List[Message]:
        col = lambda k: self.column_map.get(k, k)  # noqa: E731
        out = [
            _msg("user", sample[col("input")], not self.train_on_input),
            _msg("assistant", sample[col("output")], False),
        ]
        if self.new_system_prompt is not None:
            out.insert(0, _msg("system", self.new_system_prompt, True))
        return out


class AlpacaTemplate:
    """Alpaca instruction format (reference: AlpacaTemplate — the standard
    prompt_input / prompt_no_input pair)."""

    PROMPT_INPUT = (
        "Below is an instruction that describes a task, paired with an "
        "input that provides further context. Write a response that "
        "appropriately completes the request.\n\n"
        "### Instruction:\n{instruction}\n\n### Input:\n{input}\n\n"
        "### Response:\n")
    PROMPT_NO_INPUT = (
        "Below is an instruction that describes a task. Write a response "
        "that appropriately completes the request.\n\n"
        "### Instruction:\n{instruction}\n\n### Response:\n")

    def __init__(self, train_on_input: bool = False,
                 column_map: Optional[Dict[str, str]] = None):
        self.train_on_input = train_on_input
        self.column_map = column_map or {}

    def __call__(self, sample: Mapping[str, Any]) -> List[Message]:
        col = lambda k: self.column_map.get(k, k)  # noqa: E731
        instruction = sample[col("instruction")]
        inp = sample.get(col("input"), "")
        output = sample[col("output")]
        prompt = (self.PROMPT_INPUT.format(instruction=instruction,
                                           input=inp) if inp
                  else self.PROMPT_NO_INPUT.format(instruction=instruction))
        return [_msg("user", prompt, not self.train_on_input),
                _msg("assistant", output, False)]


class ShareGPTTemplate:
    """{conversations: [{from: human|gpt|system, value}, ...]}
    (reference: ShareGPTTemplate)."""

    ROLE_MAP = {"human": "user", "gpt": "assistant", "system": "system"}

    def __init__(self, train_on_input: bool = False,
                 column_map: Optional[Dict[str, str]] = None):
        self.train_on_input = train_on_input
        self.column_map = column_map or {}

    def __call__(self, sample: Mapping[str, Any]) -> List[Message]:
        key = self.column_map.get("conversations", "conversations")
        out = []
        for turn in sample[key]:
            role = self.ROLE_MAP.get(turn["from"], turn["from"])
            masked = (role != "assistant") and not self.train_on_input
            out.append(_msg(role, turn["value"], masked))
        return out


class OpenAITemplate:
    """{messages: [{role, content}, ...]} (reference: OpenAITemplate)."""

    def __init__(self, train_on_input: bool = False,
                 column_map: Optional[Dict[str, str]] = None):
        self.train_on_input = train_on_input
        self.column_map = column_map or {}

    def __call__(self, sample: Mapping[str, Any]) -> List[Message]:
        key = self.column_map.get("messages", "messages")
        return [
            _msg(m["role"], m["content"],
                 (m["role"] != "assistant") and not self.train_on_input)
            for m in sample[key]]


@dataclasses.dataclass
class ChatFormat:
    """Role framing applied around each message's content before
    tokenization (the prompt_template.py analog: a template turning
    messages into model text).  Defaults are a minimal llama-chat-like
    framing; swap per model family."""
    role_prefix: Dict[str, str] = dataclasses.field(default_factory=lambda: {
        "system": "<<SYS>>\n", "user": "[INST] ", "assistant": " "})
    role_suffix: Dict[str, str] = dataclasses.field(default_factory=lambda: {
        "system": "\n<</SYS>>\n", "user": " [/INST]", "assistant": ""})

    def frame(self, m: Message) -> str:
        return (self.role_prefix.get(m["role"], "") + m["content"]
                + self.role_suffix.get(m["role"], ""))


def render_messages(messages: Sequence[Message], encode: Callable[[str],
                    Sequence[int]], *, chat_format: Optional[ChatFormat]
                    = None, bos_id: Optional[int] = None,
                    eos_id: Optional[int] = None,
                    max_len: Optional[int] = None):
    """messages -> (input_ids [n], labels [n]) with -100 labels on masked
    spans.  Tokenizing per message makes the mask exact (the reference
    recovers it by tracking rendered-string spans through jinja,
    messages/utils.py render_template).  eos_id closes EVERY assistant
    turn (a trained target — multi-turn conversations must learn to
    terminate mid-conversation turns; a text suffix can't do this since
    '</s>' does not encode to eos_id under byte-fallback tokenizers)."""
    fmt = chat_format or ChatFormat()
    ids: List[int] = []
    mask: List[bool] = []   # True = train on this token
    if bos_id is not None:
        ids.append(int(bos_id))
        mask.append(False)
    for m in messages:
        toks = list(encode(fmt.frame(m)))
        ids.extend(int(t) for t in toks)
        mask.extend([not m.get("masked", False)] * len(toks))
        if eos_id is not None and m["role"] == "assistant":
            ids.append(int(eos_id))
            mask.append(not m.get("masked", False))
    if max_len is not None:
        ids, mask = ids[:max_len], mask[:max_len]
    input_ids = np.asarray(ids, np.int32)
    labels = np.where(np.asarray(mask), input_ids, -100).astype(np.int32)
    return input_ids, labels


def build_sft_example(sample: Mapping[str, Any], template,
                      encode: Callable[[str], Sequence[int]], **kw):
    """One-stop: dataset sample -> (input_ids, labels) via a template
    (reference: the sft dataset pipeline chaining message + prompt
    templates)."""
    return render_messages(template(sample), encode, **kw)
