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
(logits, or the next-token loss given labels); when `config.remat` is
on, each block is recomputed in the backward as `config.remat_policy`
says (`nn/remat.py`).  The serving forwards
(chunked prefill and paged decode) live in `models/generation.py`,
which drives these modules layer by layer (`serve_qkv` / `serve_tail`)
because the KV cache is written between the projection and the
attention.
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
        # the dispatcher's route: None = by device (flash kernels on the
        # card, dense attention on the CPU), False = dense everywhere;
        # a check may set True to run flash's plain version on the CPU
        self.use_pallas = None if c.use_flash_attention else False
        self.wqkv = nn.Parameter(torch.empty(
            (c.hidden_size, self.n_kv, self.group + 2, self.head_dim),
            dtype=c.param_dtype, device=device), requires_grad=False)
        self.o_proj = Linear(c.hidden_size, c.hidden_size,
                             dtype=c.param_dtype, device=device,
                             init_std=c.initializer_range)

    def reset_parameters(self, generator: torch.Generator):
        self.wqkv.normal_(0.0, self.init_std, generator=generator)
        self.o_proj.reset_parameters(generator)

    def qkv(self, x: torch.Tensor) -> torch.Tensor:
        """The fused projection: x [b, s, h] -> [b, s, n_kv, group+2, hd]."""
        return torch.einsum("bsh,hkgd->bskgd", x, self.wqkv.to(x.dtype))

    def split(self, qkv: torch.Tensor):
        """qkv -> q [b, s, n_kv, group, hd], k and v [b, s, n_kv, hd]:
        views of qkv, which `fused_rotary_qk` reads in place (q head h
        is q[..., h // group, h % group, :])."""
        return (qkv[..., : self.group, :], qkv[..., self.group, :],
                qkv[..., self.group + 1, :])

    def project_qkv(self, x: torch.Tensor):
        """x [b, s, h] -> q [b, s, n_kv, group, hd], k and v [b, s, n_kv,
        hd]: views of the fused projection, for RoPE to read in place."""
        return self.split(self.qkv(x))

    def heads(self, qkv: torch.Tensor, cos_t: torch.Tensor,
              sin_t: torch.Tensor):
        """qkv -> (q [b, s, nq, hd], k, v) with RoPE on q and k, which the
        kernel reads in place from qkv; cos_t/sin_t [b, s, hd/2] are the
        RoPE rows of the positions (`rope_tables`)."""
        q, k, v = self.split(qkv)
        q, k = fused_rotary_qk(q, k, cos_t, sin_t, device=qkv.device)
        return q, k, v

    def attend(self, q, k, v, segment_ids=None) -> torch.Tensor:
        """Causal self-attention, heads merged: [b, s, nq * hd]."""
        attn = flash_attention(q, k, v, causal=True, segment_ids=segment_ids,
                               use_pallas=self.use_pallas,
                               device=q.device)
        return attn.reshape(*q.shape[:2], -1)

    def forward(self, x: torch.Tensor, cos_t: torch.Tensor,
                sin_t: torch.Tensor, segment_ids=None) -> torch.Tensor:
        """Causal self-attention over x [b, s, h]."""
        q, k, v = self.heads(self.qkv(x), cos_t, sin_t)
        return self.o_proj(self.attend(q, k, v, segment_ids))


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

    def gate_up(self, x: torch.Tensor) -> torch.Tensor:
        """The fused projection: x [b, s, h] -> [b, s, 2, inter]."""
        return torch.einsum("bsh,hci->bsci", x, self.w_gate_up.to(x.dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(swiglu(self.gate_up(x)))


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

    def forward_saving_dots(self, x, cos_t, sin_t, segment_ids=None, *,
                            save_attn: bool):
        """`forward` under the recompute policies "dots" (`save_attn`
        off) and "dots_attn" (on): the four projections run outside any
        checkpoint, so autograd keeps their outputs, and only the
        segments between them — input norm; RoPE (and, under "dots",
        the attention); residual add + post norm; SwiGLU — are
        recomputed in the backward.  Under "dots_attn" the attention
        runs outside too, so its output and lse are kept and its
        forward is not launched again."""
        a = self.attn
        qkv = a.qkv(remat(self.input_norm, x))
        if save_attn:
            attn = a.attend(*remat(a.heads, qkv, cos_t, sin_t), segment_ids)
        else:
            attn = remat(
                lambda t: a.attend(*a.heads(t, cos_t, sin_t), segment_ids),
                qkv)
        normed, x = remat(self.post_norm.residual, x, a.o_proj(attn))
        hidden = remat(swiglu, self.mlp.gate_up(normed))
        return x + self.mlp.down_proj(hidden)

    # -- the serving forwards' two halves (models/generation.py) ----------
    def serve_qkv(self, x: torch.Tensor):
        """q [b, s, n_kv, group, hd], k and v [b, s, n_kv, hd] of the
        block's input, before RoPE: views of the fused projection."""
        return self.attn.project_qkv(self.input_norm(x))

    def serve_tail(self, x: torch.Tensor, attn: torch.Tensor):
        """o_proj + residual, then the MLP on the post-norm + residual."""
        x = x + self.attn.o_proj(attn.reshape(*attn.shape[:2], -1))
        return x + self.mlp(self.post_norm(x))


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

    #: where `load_jax_params` finds the layers: the port's ModuleList,
    #: the reference's stacked subtree and its per-layer prefix
    jax_layers = ("model.layers", "model.layers.layers.",
                  "model.layers.layer_{}.")

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

    # -- the interface the trainer and the serving forwards share --------
    @property
    def layers(self) -> nn.ModuleList:
        return self.model.layers

    def embed_at(self, ids: torch.Tensor, positions=None) -> torch.Tensor:
        """The token embeddings in the compute dtype (positions enter
        through RoPE, `rope_at`)."""
        return self.model.embed(ids.long()).to(self.config.compute_dtype)

    def rope_at(self, b: int, s: int, positions=None):
        """The RoPE rows (cos_t, sin_t) of positions [b, s] (default
        0..s-1)."""
        return rope_tables(self.rope_cos, self.rope_sin, b, s,
                           None if positions is None else positions.long())

    def final_norm(self, x: torch.Tensor) -> torch.Tensor:
        return self.model.final_norm(x)

    def lm_head_weight(self) -> torch.Tensor:
        """The LM head as a [hidden, vocab] matrix (the transposed
        embedding table when tied)."""
        if self.config.tie_word_embeddings:
            return self.model.embed.weight.t()
        return self.lm_head

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        return hidden @ self.lm_head_weight().to(hidden.dtype)

    def hidden(self, input_ids: torch.Tensor, *, position_ids=None,
               segment_ids=None) -> torch.Tensor:
        """The final-norm hidden states [b, s, hidden] of the training
        forward; each block recomputed in the backward by
        `config.remat_policy` when gradients are on."""
        c = self.config
        b, s = input_ids.shape
        x = self.embed_at(input_ids)
        cos_t, sin_t = self.rope_at(b, s, position_ids)
        for layer in self.model.layers:
            if not (c.remat and torch.is_grad_enabled()):
                x = layer(x, cos_t, sin_t, segment_ids)
            elif c.remat_policy == "nothing":
                x = remat(layer, x, cos_t, sin_t, segment_ids)
            else:
                x = layer.forward_saving_dots(
                    x, cos_t, sin_t, segment_ids,
                    save_attn=c.remat_policy == "dots_attn")
        return self.final_norm(x)

    def forward(self, input_ids: torch.Tensor, labels=None, *,
                position_ids=None, segment_ids=None,
                loss_reduction: str = "mean", labels_shifted: bool = False):
        """The training forward over input_ids [b, s].  Without labels,
        the logits [b, s, vocab].  With labels, the next-token loss:
        logits[t] predicts labels[t + 1] (labels[t] when
        `labels_shifted`), positions labelled -100 ignored; "mean"
        returns the mean loss, "sum" returns (loss sum, token count) so
        that micro-batches weigh by their true token counts."""
        if loss_reduction not in ("mean", "sum"):
            raise ValueError(f"loss_reduction must be 'mean' or 'sum', got "
                             f"{loss_reduction!r}")
        logits = self.logits(self.hidden(input_ids,
                                         position_ids=position_ids,
                                         segment_ids=segment_ids))
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
