"""LLaMA model, single device: the port of `hetu_tpu/models/llama/model.py`
(LlamaAttention, LlamaMLP, LlamaBlock, LlamaModel, LlamaLMHeadModel).

The parameter layout is the reference's, so JAX weights load key for
key (`from_jax.load_jax_params`):

  * attention: fused kv-group-aligned `wqkv` [h, n_kv, group+2, hd] —
    per kv head, its group of q heads, then k, then v — and `o_proj`;
  * MLP: fused `w_gate_up` [h, 2, inter] and `down_proj`;
  * `lm_head` [h, vocab] unless the embeddings are tied.

The reference stacks the layers for `lax.scan`; here they are an
`nn.ModuleList`.  `LlamaLMHeadModel.forward` is the training forward
(logits, or the next-token loss given labels), each block recomputed
in the backward when `config.remat` is on.  The serving forwards
(chunked prefill and paged decode) live in `models/generation.py`,
which drives these modules layer by layer because the KV cache is
written between the projection and the attention.
"""
from __future__ import annotations

import torch
from torch import nn

from hetu_tpu_torch.models.llama.config import LlamaConfig
from hetu_tpu_torch.nn.layers import Embedding, Linear, RMSNorm
from hetu_tpu_torch.nn.remat import remat
from hetu_tpu_torch.ops.activations import swiglu
from hetu_tpu_torch.ops.attention import flash_attention
from hetu_tpu_torch.ops.cuda.rotary import fused_rotary_qk
from hetu_tpu_torch.ops.losses import softmax_cross_entropy_sparse
from hetu_tpu_torch.ops.rotary import build_rope_cache, rope_tables
from hetu_tpu_torch.utils.device import resolve_device


class LlamaAttention(nn.Module):
    def __init__(self, config: LlamaConfig, device):
        super().__init__()
        c = config
        self.n_q, self.n_kv = c.num_attention_heads, c.num_key_value_heads
        self.group = self.n_q // self.n_kv   # q heads per kv head
        self.head_dim = c.head_dim
        self.init_std = c.initializer_range
        self.use_flash = c.use_flash_attention
        self.wqkv = nn.Parameter(torch.empty(
            (c.hidden_size, self.n_kv, self.group + 2, self.head_dim),
            dtype=c.param_dtype, device=device), requires_grad=False)
        self.o_proj = Linear(c.hidden_size, c.hidden_size,
                             dtype=c.param_dtype, device=device,
                             init_std=c.initializer_range)

    def reset_parameters(self, generator: torch.Generator):
        self.wqkv.normal_(0.0, self.init_std, generator=generator)
        self.o_proj.reset_parameters(generator)

    def project_qkv(self, x: torch.Tensor):
        """x [b, s, h] -> q [b, s, nq, hd], k and v [b, s, n_kv, hd]."""
        b, s, _ = x.shape
        qkv = torch.einsum("bsh,hkgd->bskgd", x, self.wqkv.to(x.dtype))
        q = qkv[..., : self.group, :].reshape(b, s, self.n_q, self.head_dim)
        return q, qkv[..., self.group, :], qkv[..., self.group + 1, :]

    def forward(self, x: torch.Tensor, cos_t: torch.Tensor,
                sin_t: torch.Tensor, segment_ids=None) -> torch.Tensor:
        """Causal self-attention over x [b, s, h]; cos_t/sin_t [b, s,
        hd/2] are the RoPE rows of the positions (`rope_tables`)."""
        b, s, _ = x.shape
        q, k, v = self.project_qkv(x)
        q, k = fused_rotary_qk(q.contiguous(), k.contiguous(), cos_t, sin_t,
                               device=x.device)
        attn = flash_attention(q, k, v, causal=True, segment_ids=segment_ids,
                               use_pallas=None if self.use_flash else False,
                               device=x.device)
        return self.o_proj(attn.reshape(b, s, -1))


class LlamaMLP(nn.Module):
    """SwiGLU MLP with fused gate+up."""

    def __init__(self, config: LlamaConfig, device):
        super().__init__()
        c = config
        self.init_std = c.initializer_range
        self.w_gate_up = nn.Parameter(torch.empty(
            (c.hidden_size, 2, c.intermediate_size), dtype=c.param_dtype,
            device=device), requires_grad=False)
        self.down_proj = Linear(c.intermediate_size, c.hidden_size,
                                dtype=c.param_dtype, device=device,
                                init_std=c.initializer_range)

    def reset_parameters(self, generator: torch.Generator):
        self.w_gate_up.normal_(0.0, self.init_std, generator=generator)
        self.down_proj.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gu = torch.einsum("bsh,hci->bsci", x, self.w_gate_up.to(x.dtype))
        return self.down_proj(swiglu(gu))


class LlamaBlock(nn.Module):
    """Pre-norm transformer block: input_norm -> attn, post_norm -> mlp."""

    def __init__(self, config: LlamaConfig, device):
        super().__init__()
        c = config
        self.input_norm = RMSNorm(c.hidden_size, eps=c.rms_norm_eps,
                                  dtype=c.param_dtype, device=device)
        self.attn = LlamaAttention(c, device)
        self.post_norm = RMSNorm(c.hidden_size, eps=c.rms_norm_eps,
                                 dtype=c.param_dtype, device=device)
        self.mlp = LlamaMLP(c, device)

    def reset_parameters(self, generator: torch.Generator):
        self.input_norm.reset_parameters()
        self.attn.reset_parameters(generator)
        self.post_norm.reset_parameters()
        self.mlp.reset_parameters(generator)

    def forward(self, x, cos_t, sin_t, segment_ids=None):
        h = self.attn(self.input_norm(x), cos_t, sin_t, segment_ids)
        # the residual add + post-norm pair: one fused kernel
        normed, x = self.post_norm.residual(x, h)
        return x + self.mlp(normed)


class LlamaModel(nn.Module):
    """Backbone: embed + decoder layers + final norm."""

    def __init__(self, config: LlamaConfig, device):
        super().__init__()
        c = config
        self.embed = Embedding(c.vocab_size, c.hidden_size,
                               dtype=c.param_dtype, device=device,
                               init_std=c.initializer_range)
        self.layers = nn.ModuleList(LlamaBlock(c, device)
                                    for _ in range(c.num_hidden_layers))
        self.final_norm = RMSNorm(c.hidden_size, eps=c.rms_norm_eps,
                                  dtype=c.param_dtype, device=device)

    def reset_parameters(self, generator: torch.Generator):
        self.embed.reset_parameters(generator)
        for layer in self.layers:
            layer.reset_parameters(generator)
        self.final_norm.reset_parameters()


class LlamaLMHeadModel(nn.Module):
    """Backbone + LM head.  Parameters are created on `device` and drawn
    from a torch.Generator seeded with `seed` (normal(0,
    initializer_range) weights, unit norms), as the reference's init
    does with its own PRNG; real weights load with `load_jax_params`."""

    def __init__(self, config: LlamaConfig, *, device="cuda", seed: int = 0):
        super().__init__()
        self.config = c = config
        self.device = dev = resolve_device(device)
        self.model = LlamaModel(c, dev)
        if not c.tie_word_embeddings:
            self.lm_head = nn.Parameter(torch.empty(
                (c.hidden_size, c.vocab_size), dtype=c.param_dtype,
                device=dev), requires_grad=False)
        cos, sin = build_rope_cache(c.max_position_embeddings, c.head_dim,
                                    c.rope_theta, device=dev)
        self.register_buffer("rope_cos", cos, persistent=False)
        self.register_buffer("rope_sin", sin, persistent=False)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        self.model.reset_parameters(gen)
        if not c.tie_word_embeddings:
            self.lm_head.normal_(0.0, c.initializer_range, generator=gen)

    def lm_head_weight(self) -> torch.Tensor:
        """The LM head as a [hidden, vocab] matrix (the transposed
        embedding table when tied)."""
        if self.config.tie_word_embeddings:
            return self.model.embed.weight.t()
        return self.lm_head

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        return hidden @ self.lm_head_weight().to(hidden.dtype)

    def forward(self, input_ids: torch.Tensor, labels=None, *,
                position_ids=None, segment_ids=None,
                loss_reduction: str = "mean", labels_shifted: bool = False):
        """The training forward over input_ids [b, s].  Without labels,
        the logits [b, s, vocab].  With labels, the next-token loss:
        logits[t] predicts labels[t + 1] (labels[t] when
        `labels_shifted`), positions labelled -100 ignored; "mean"
        returns the mean loss, "sum" returns (loss sum, token count) so
        that micro-batches weigh by their true token counts."""
        c = self.config
        if loss_reduction not in ("mean", "sum"):
            raise ValueError(f"loss_reduction must be 'mean' or 'sum', got "
                             f"{loss_reduction!r}")
        b, s = input_ids.shape
        x = self.model.embed(input_ids.long()).to(c.compute_dtype)
        cos_t, sin_t = rope_tables(
            self.rope_cos, self.rope_sin, b, s,
            None if position_ids is None else position_ids.long())
        for layer in self.model.layers:
            if c.remat:
                x = remat(layer, x, cos_t, sin_t, segment_ids)
            else:
                x = layer(x, cos_t, sin_t, segment_ids)
        logits = self.logits(self.model.final_norm(x))
        if labels is None:
            return logits
        if labels_shifted:
            lg, tgt = logits, labels
        else:
            lg, tgt = logits[:, :-1, :], labels[:, 1:]
        if loss_reduction == "sum":
            loss = softmax_cross_entropy_sparse(lg, tgt, reduction="sum")
            return loss, (tgt != -100).float().sum()
        return softmax_cross_entropy_sparse(lg, tgt)
