"""GPT-2/3 model, single device: the port of `hetu_tpu/models/gpt/model.py`
(GPTAttention, GPTMLP, GPTBlock, GPTModel, GPTLMHeadModel) at tp = 1,
without a pipeline.

The parameter layout is the reference's, so JAX weights load key for
key (`models/from_jax.load_jax_params`):

  * attention: fused per-head `wqkv` [h, heads, 3, hd] (q, k, v of each
    head together) with its bias `bqkv` [heads, 3, hd], and `o_proj`
    with a bias;
  * MLP: `w_up` [h, 4h], `b_up`, `down` with a bias; GELU in tanh form;
  * learned positions `wpe` [max_positions, h]; the LM head tied to
    `wte` unless `tie_word_embeddings` is off.

The block is pre-norm: attention on `ln1(x)`, then the residual add and
`ln2` as one pass of the fused residual-LayerNorm kernel
(`LayerNorm.residual`), then the MLP.  `GPTLMHeadModel.forward` is the
training forward (logits, or the next-token loss given labels), each
block recomputed in the backward as `config.remat_policy` says
(`nn/remat.py`).  The serving forwards live in `models/generation.py`;
they reach a block through `serve_qkv` / `serve_tail`, which add the
residual and apply `ln2` unfused, as the reference's serving forwards
do.  Dropout, given a key, at the reference's sites (`LlamaBlock`'s).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from hetu_tpu_torch.models.gpt.config import GPTConfig
from hetu_tpu_torch.nn.layers import Embedding, LayerNorm, Linear, _param
from hetu_tpu_torch.nn.remat import (project, recompute, run_blocks,
                                     weight_of)
from hetu_tpu_torch.ops.activations import dropout, gelu
from hetu_tpu_torch.ops.attention import (attention_keeping_output,
                                          self_attention)
from hetu_tpu_torch.ops.losses import softmax_cross_entropy_sparse
from hetu_tpu_torch.utils.device import resolve_device

_MULTI_GPU = "the multi-GPU slice (ROADMAP Queue A item 5)"


class GPTAttention(nn.Module):
    """MHA with biases."""

    def __init__(self, config: GPTConfig, device):
        super().__init__()
        c = config
        self.n_heads, self.head_dim = c.num_attention_heads, c.head_dim
        self.init_std = c.initializer_range
        self.dropout = c.attention_dropout
        # the dispatcher's route, as LlamaAttention's
        self.use_pallas = None if c.use_flash_attention else False
        self.wqkv = _param((c.hidden_size, self.n_heads, 3, self.head_dim),
                           c.param_dtype, device)
        self.bqkv = _param((self.n_heads, 3, self.head_dim), c.param_dtype,
                           device)
        self.o_proj = Linear(c.hidden_size, c.hidden_size, bias=True,
                             dtype=c.param_dtype, device=device,
                             init_std=c.initializer_range)

    def reset_parameters(self, generator: torch.Generator):
        self.wqkv.normal_(0.0, self.init_std, generator=generator)
        self.bqkv.zero_()
        self.o_proj.reset_parameters(generator)

    def qkv(self, x: torch.Tensor) -> torch.Tensor:
        """The fused product alone: x [b, s, h] -> [b, s, heads, 3, hd]
        (the "dots" policies keep it)."""
        return project(x, self.wqkv)

    def heads(self, qkv: torch.Tensor):
        """The product plus its bias -> q, k, v, each [b, s, heads, hd]."""
        qkv = qkv + self.bqkv.to(qkv.dtype)
        return qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]

    def project_qkv(self, x: torch.Tensor):
        return self.heads(self.qkv(x))

    def attention_kw(self, segment_ids, rng):
        """The attention's route and dropout (`ops.attention`)."""
        return dict(segment_ids=segment_ids, use_pallas=self.use_pallas,
                    dropout_rate=self.dropout,
                    dropout_key=None if rng is None else rng.fold(1))

    def attend(self, q, k, v, segment_ids=None, rng=None) -> torch.Tensor:
        """Causal self-attention, heads merged: [b, s, h]."""
        return self_attention(q, k, v, device=q.device,
                              **self.attention_kw(segment_ids, rng))

    def forward(self, x: torch.Tensor, segment_ids=None,
                rng=None) -> torch.Tensor:
        return self.o_proj(self.attend(*self.project_qkv(x), segment_ids,
                                       rng))


class GPTMLP(nn.Module):
    def __init__(self, config: GPTConfig, device):
        super().__init__()
        c = config
        self.init_std = c.initializer_range
        self.w_up = _param((c.hidden_size, c.intermediate_size),
                           c.param_dtype, device)
        self.b_up = _param((c.intermediate_size,), c.param_dtype, device)
        self.down = Linear(c.intermediate_size, c.hidden_size, bias=True,
                           dtype=c.param_dtype, device=device,
                           init_std=c.initializer_range)

    def reset_parameters(self, generator: torch.Generator):
        self.w_up.normal_(0.0, self.init_std, generator=generator)
        self.b_up.zero_()
        self.down.reset_parameters(generator)

    def up(self, x: torch.Tensor) -> torch.Tensor:
        """The up product alone (the "dots" policies keep it)."""
        return project(x, self.w_up)

    def act(self, u: torch.Tensor) -> torch.Tensor:
        return gelu(u + self.b_up.to(u.dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down(self.act(self.up(x)))


class GPTBlock(nn.Module):
    """Pre-LN block: ln1 -> attention; residual add + ln2 fused -> MLP."""

    def __init__(self, config: GPTConfig, device):
        super().__init__()
        c = config
        kw = dict(eps=c.layer_norm_eps, dtype=c.param_dtype, device=device)
        self.ln1 = LayerNorm(c.hidden_size, **kw)
        self.attn = GPTAttention(c, device)
        self.ln2 = LayerNorm(c.hidden_size, **kw)
        self.mlp = GPTMLP(c, device)
        self.hidden_dropout = c.hidden_dropout

    def reset_parameters(self, generator: torch.Generator):
        self.ln1.reset_parameters()
        self.attn.reset_parameters(generator)
        self.ln2.reset_parameters()
        self.mlp.reset_parameters(generator)

    def drop(self, h, rng, site: int):
        """The hidden dropout at `site` (as `LlamaBlock.drop`)."""
        return dropout(h, self.hidden_dropout,
                       None if rng is None else rng.fold(site),
                       deterministic=False)

    def forward(self, x, segment_ids=None, rng=None):
        h = self.attn(self.ln1(x), segment_ids, rng)
        # the residual add + ln2 pair: one fused kernel
        normed, x = self.ln2.residual(x, self.drop(h, rng, 2))
        return x + self.drop(self.mlp(normed), rng, 3)

    def forward_remat(self, x, segment_ids=None, rng=None, *, policy: str):
        """`forward`, recomputed in the backward as `policy` says, in
        the segments of `LlamaBlock.forward_remat`: ln1 -> qkv (the
        product before its bias); the bias, attention -> o; o's bias,
        residual add + ln2 -> up; up's bias, GELU -> down."""
        if policy == "nothing":
            return recompute(lambda x, seg: self(x, seg, rng), x,
                             segment_ids, adapted=self.parameters())
        a, m = self.attn, self.mlp
        qkv = recompute(self.ln1, x, weight=a.wqkv)
        kw = a.attention_kw(segment_ids, rng)
        if policy == "dots_attn":
            attn = attention_keeping_output(a.heads, qkv, device=qkv.device,
                                            **kw)
            o = recompute(lambda t: t, attn, weight=a.o_proj.weight)
        else:
            o = recompute(
                lambda t: self_attention(*a.heads(t), device=t.device, **kw),
                qkv, weight=a.o_proj.weight)
        bias = a.o_proj.bias
        up, x = recompute(
            lambda x, o: self.ln2.residual(
                x, self.drop(o + bias.to(o.dtype), rng, 2)),
            x, o, weight=m.w_up)
        down = recompute(m.act, up, weight=m.down.weight)
        return x + self.drop(down + m.down.bias.to(down.dtype), rng, 3)

    # -- the serving forwards' two halves (models/generation.py) ----------
    def serve_qkv(self, x: torch.Tensor):
        """q, k, v [b, s, heads, hd] of the block's input."""
        return self.attn.project_qkv(self.ln1(x))

    def serve_tail(self, x: torch.Tensor, attn: torch.Tensor):
        """o_proj + residual, then the MLP on ln2 + residual (unfused,
        as the reference's serving forwards compute it)."""
        x = x + self.attn.o_proj(attn.reshape(*attn.shape[:2], -1))
        return x + self.mlp(self.ln2(x))


class GPTModel(nn.Module):
    """Backbone: token + position embeddings, blocks, final LayerNorm."""

    def __init__(self, config: GPTConfig, device):
        super().__init__()
        c = config
        self.wte = Embedding(c.vocab_size, c.hidden_size, dtype=c.param_dtype,
                             device=device, init_std=c.initializer_range)
        self.wpe = _param((c.max_position_embeddings, c.hidden_size),
                          c.param_dtype, device)
        self.blocks = nn.ModuleList(GPTBlock(c, device)
                                    for _ in range(c.num_hidden_layers))
        self.final_ln = LayerNorm(c.hidden_size, eps=c.layer_norm_eps,
                                  dtype=c.param_dtype, device=device)
        self.init_std = c.initializer_range

    def reset_parameters(self, generator: torch.Generator):
        self.wte.reset_parameters(generator)
        self.wpe.normal_(0.0, self.init_std, generator=generator)
        for block in self.blocks:
            block.reset_parameters(generator)
        self.final_ln.reset_parameters()


class GPTLMHeadModel(nn.Module):
    """Backbone + LM head (tied to `wte` by default).  Parameters are
    created on `device` and drawn from a torch.Generator seeded with
    `seed`, as `LlamaLMHeadModel`'s; real weights load with
    `load_jax_params` (or from HF through `models.gpt.convert`)."""

    #: where `load_jax_params` finds the blocks: the port's ModuleList,
    #: the reference's stacked subtree and its per-layer prefix
    jax_layers = ("model.blocks", "model.blocks.", "model.block_{}.")

    def __init__(self, config: GPTConfig, strategy=None, *, device="cuda",
                 seed: int = 0):
        super().__init__()
        if strategy is not None:
            raise NotImplementedError(
                f"GPTLMHeadModel(strategy=...) is not in the port yet; it "
                f"arrives with {_MULTI_GPU}")
        self.config = c = config
        self.device = dev = resolve_device(device)
        self.model = GPTModel(c, dev)
        if not c.tie_word_embeddings:
            self.lm_head = _param((c.hidden_size, c.vocab_size),
                                  c.param_dtype, dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        self.model.reset_parameters(gen)
        if not c.tie_word_embeddings:
            self.lm_head.normal_(0.0, c.initializer_range, generator=gen)

    # -- the interface the trainer and the serving forwards share --------
    @property
    def layers(self) -> nn.ModuleList:
        return self.model.blocks

    def embed_at(self, ids: torch.Tensor,
                 positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """wte[ids] + wpe[positions] in the compute dtype, added in the
        wider of the parameter and compute dtypes and rounded once (the
        reference adds in the parameter dtype and casts; its compiled
        step keeps the sum of two bf16 tables in fp32 when fp32
        follows).  Positions default to 0..s-1.  The callers check the
        positions against max_position_embeddings first (`hidden`, and
        the serving forwards' context guard): the reference's `jnp.take`
        would clamp one past the end to the last row."""
        if positions is None:
            positions = torch.arange(ids.shape[-1], device=ids.device)
        c = self.config
        acc = torch.promote_types(c.param_dtype, c.compute_dtype)
        x = (self.model.wte(ids.long()).to(acc)
             + self.model.wpe[positions.long()].to(acc))
        return c.policy.cast_to_compute(x)

    def rope_at(self, b: int, s: int, positions=None):
        """GPT has learned positions and applies no RoPE."""
        return None

    def final_norm(self, x: torch.Tensor) -> torch.Tensor:
        return self.model.final_ln(x)

    def lm_head_weight(self) -> torch.Tensor:
        """The LM head as a [hidden, vocab] matrix (the transposed
        token table when tied)."""
        if self.config.tie_word_embeddings:
            return self.model.wte.weight.t()
        return self.lm_head

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        return hidden @ weight_of(self.lm_head_weight()).to(hidden.dtype)

    def hidden(self, input_ids: torch.Tensor, *, position_ids=None,
               segment_ids=None, rng=None,
               deterministic: bool = True) -> torch.Tensor:
        """The final-norm hidden states [b, s, hidden] of the training
        forward; each block recomputed in the backward by
        `config.remat_policy` when gradients are on; dropout with a key
        and `deterministic=False`."""
        c = self.config
        n = input_ids.shape[1] if position_ids is None \
            else int(position_ids.max()) + 1
        if n > c.max_position_embeddings:
            raise ValueError(f"position {n - 1} is past "
                             f"max_position_embeddings "
                             f"{c.max_position_embeddings}")
        x = self.embed_at(input_ids, position_ids)
        x, _ = run_blocks(c, self.model.blocks, x, (segment_ids,),
                          None if deterministic else rng)
        return self.final_norm(x)

    def forward(self, input_ids: torch.Tensor, labels=None, *,
                position_ids=None, segment_ids=None, rng=None,
                deterministic: bool = True,
                loss_reduction: str = "mean", labels_shifted: bool = False,
                include_aux_loss: bool = True):
        """As `LlamaLMHeadModel.forward`: the logits [b, s, vocab], or
        with labels the next-token loss ("mean", or "sum" returning
        (loss sum, token count)); dropout as there.  `include_aux_loss`
        is taken for the MoE-capable family's interface (GPT has no
        router loss), as the reference's is."""
        if loss_reduction not in ("mean", "sum"):
            raise ValueError(f"loss_reduction must be 'mean' or 'sum', got "
                             f"{loss_reduction!r}")
        logits = self.logits(self.hidden(input_ids,
                                         position_ids=position_ids,
                                         segment_ids=segment_ids, rng=rng,
                                         deterministic=deterministic))
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
