"""LLaMA model, single device: the port of `hetu_tpu/models/llama/model.py`
(LlamaAttention, LlamaMLP, LlamaBlock, LlamaModel, LlamaLMHeadModel).

The parameter layout is the reference's, so JAX weights load key for
key (`from_jax.load_jax_params`):

  * attention: fused kv-group-aligned `wqkv` [h, n_kv, group+2, hd] —
    per kv head, its group of q heads, then k, then v — and `o_proj`;
  * MLP: fused `w_gate_up` [h, 2, inter] and `down_proj`; with
    `num_experts > 0` an MoE layer (`nn/moe.py`: `router` [h, E],
    `w_gate_up` [E, h, 2, inter], `w_down` [E, inter, h]) whose block
    returns its aux loss beside x, summed over the layers into the
    training loss;
  * `lm_head` [h, vocab] unless the embeddings are tied.

The reference stacks the layers for `lax.scan`; here they are an
`nn.ModuleList`.  `LlamaLMHeadModel.forward` is the training forward
(logits, or the next-token loss given labels); when `config.remat` is
on, each block is recomputed in the backward as `config.remat_policy`
says (`nn/remat.py`).  Given a dropout key (`rng`, an
`ops.activations.DropoutKey`) and `deterministic=False`, dropout runs at
the reference's three sites a block: the attention probabilities
(fold 1; the attention leaves the flash kernels for the composition),
the attention's output (fold 2) and the MLP's (fold 3), each layer's key
folded from the step's by its index.  The serving forwards
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
from hetu_tpu_torch.nn.moe import MoELayer
from hetu_tpu_torch.nn.remat import (project, recompute, run_blocks,
                                     weight_of)
from hetu_tpu_torch.obs import numerics
from hetu_tpu_torch.ops.activations import dropout, swiglu
from hetu_tpu_torch.ops.attention import (attention_keeping_output,
                                          self_attention)
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
        self.dropout = c.attention_dropout
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
        return project(x, self.wqkv)

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

    def attention_kw(self, segment_ids, rng):
        """The attention's route and dropout (`ops.attention`)."""
        return dict(segment_ids=segment_ids, use_pallas=self.use_pallas,
                    dropout_rate=self.dropout,
                    dropout_key=None if rng is None else rng.fold(1))

    def attend(self, q, k, v, segment_ids=None, rng=None) -> torch.Tensor:
        """Causal self-attention, heads merged: [b, s, nq * hd]."""
        return self_attention(q, k, v, device=q.device,
                              **self.attention_kw(segment_ids, rng))

    def forward(self, x: torch.Tensor, cos_t: torch.Tensor,
                sin_t: torch.Tensor, segment_ids=None,
                rng=None) -> torch.Tensor:
        """Causal self-attention over x [b, s, h]."""
        q, k, v = self.heads(self.qkv(x), cos_t, sin_t)
        return self.o_proj(self.attend(q, k, v, segment_ids, rng))


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
        return project(x, self.w_gate_up)

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
        self.moe = c.num_experts > 0
        if self.moe:
            self.mlp = MoELayer(c.hidden_size, c.intermediate_size,
                                c.moe_config(), param_dtype=c.param_dtype,
                                initializer_range=c.initializer_range,
                                device=device)
        else:
            self.mlp = LlamaMLP(c, device)
        self.hidden_dropout = c.hidden_dropout

    def reset_parameters(self, generator: torch.Generator):
        self.input_norm.reset_parameters()
        self.attn.reset_parameters(generator)
        self.post_norm.reset_parameters()
        self.mlp.reset_parameters(generator)

    def drop(self, h, rng, site: int):
        """The hidden dropout at `site` (2: after the attention, 3: after
        the MLP); h unchanged without a key."""
        return dropout(h, self.hidden_dropout,
                       None if rng is None else rng.fold(site),
                       deterministic=False)

    def forward(self, x, cos_t, sin_t, segment_ids=None, rng=None, *,
                token_ids=None):
        """The block over x [b, s, h]; an MoE block returns (x, its aux
        loss), routing the hash gate by `token_ids` [b, s] (default: the
        flat row index)."""
        h = self.attn(self.input_norm(x), cos_t, sin_t, segment_ids, rng)
        # the residual add + post-norm pair: one fused kernel
        normed, x = self.post_norm.residual(x, self.drop(h, rng, 2))
        if self.moe:
            y, aux = self.mlp(normed, token_ids)
            return x + self.drop(y, rng, 3), aux
        return x + self.drop(self.mlp(normed), rng, 3)

    def forward_remat(self, x, cos_t, sin_t, segment_ids=None, rng=None, *,
                      policy: str, token_ids=None):
        """`forward`, recomputed in the backward as `policy` says
        (`nn/remat.py`).  "nothing": one segment, the block.  The "dots"
        policies: a segment from each kept tensor to the next projection
        — input norm -> qkv; RoPE and attention -> o (under "dots_attn"
        the attention keeps its output); residual add + post norm ->
        gate-up; SwiGLU -> down — so a projection's input is recomputed
        and its output kept.  An MoE block keeps its router logits, the
        one product of the layer without a batch dim (the experts'
        carry the expert dim, which the reference's policy does not
        save): residual add + post norm -> router; then the residual
        add + post norm again, the routing, the experts and the combine
        from (x, o, logits)."""
        if policy == "nothing":
            return recompute(
                lambda x, c, s, seg: self(x, c, s, seg, rng,
                                          token_ids=token_ids),
                x, cos_t, sin_t, segment_ids, adapted=self.parameters())
        a, m = self.attn, self.mlp
        qkv = recompute(self.input_norm, x, weight=a.wqkv)
        kw = a.attention_kw(segment_ids, rng)
        if policy == "dots_attn":
            attn = attention_keeping_output(
                lambda t: a.heads(t, cos_t, sin_t), qkv, device=qkv.device,
                **kw)
            o = recompute(lambda t: t, attn, weight=a.o_proj.weight)
        else:
            o = recompute(
                lambda t, c, s: self_attention(*a.heads(t, c, s),
                                               device=t.device, **kw),
                qkv, cos_t, sin_t, weight=a.o_proj.weight)

        def post(x, o):
            return self.post_norm.residual(x, self.drop(o, rng, 2))

        if self.moe:
            logits = recompute(
                lambda x, o: post(x, o)[0].reshape(-1, x.shape[-1]).float(),
                x, o, weight=m.router)

            def tail(x, o, logits):
                normed, x = post(x, o)
                b, s, h = normed.shape
                y, aux = m.route(normed.reshape(b * s, h), logits,
                                 token_ids)
                return x + self.drop(y.view(b, s, h), rng, 3), aux
            return recompute(tail, x, o, logits,
                             adapted=(m.w_gate_up, m.w_down))
        gu, x = recompute(post, x, o, weight=m.w_gate_up)
        down = recompute(swiglu, gu, weight=m.down_proj.weight)
        return x + self.drop(down, rng, 3)

    # -- the serving forwards' two halves (models/generation.py) ----------
    def serve_qkv(self, x: torch.Tensor):
        """q [b, s, n_kv, group, hd], k and v [b, s, n_kv, hd] of the
        block's input, before RoPE: views of the fused projection."""
        return self.attn.project_qkv(self.input_norm(x))

    def serve_tail(self, x: torch.Tensor, attn: torch.Tensor):
        """o_proj + residual, then the MLP on the post-norm + residual
        (an MoE layer's output without its aux loss, routed by row
        index, as the reference's serving forwards call it)."""
        x = x + self.attn.o_proj(attn.reshape(*attn.shape[:2], -1))
        y = self.mlp(self.post_norm(x))
        return x + (y[0] if self.moe else y)


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
        return self.config.policy.cast_to_compute(self.model.embed(ids.long()))

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
        logits = hidden @ weight_of(self.lm_head_weight()).to(hidden.dtype)
        numerics.tap_tree("logits", logits)
        return logits

    def hidden_aux(self, input_ids: torch.Tensor, *, position_ids=None,
                   segment_ids=None, rng=None, deterministic: bool = True,
                   route_by_ids: bool = True):
        """(hidden, aux): the final-norm hidden states [b, s, hidden] of
        the training forward, and the MoE blocks' summed aux loss (None
        for a dense model).  Each block is recomputed in the backward by
        `config.remat_policy` when gradients are on; dropout with a key
        and `deterministic=False`; the hash gate routes by input_ids,
        or with `route_by_ids=False` by row index (the reference's
        `prefill`).  The numerics taps "embed" and "hidden" (and
        "logits" in `logits`) sit where the reference's do, at the
        model's boundaries."""
        b, s = input_ids.shape
        x = self.embed_at(input_ids)
        numerics.tap_tree("embed", x)
        cos_t, sin_t = self.rope_at(b, s, position_ids)
        x, aux = run_blocks(
            self.config, self.model.layers, x, (cos_t, sin_t, segment_ids),
            None if deterministic else rng,
            input_ids if route_by_ids else None)
        hidden = self.final_norm(x)
        numerics.tap_tree("hidden", hidden)
        return hidden, aux

    def hidden(self, input_ids: torch.Tensor, **kw) -> torch.Tensor:
        """The final-norm hidden states of `hidden_aux`."""
        return self.hidden_aux(input_ids, **kw)[0]

    def forward(self, input_ids: torch.Tensor, labels=None, *,
                position_ids=None, segment_ids=None, rng=None,
                deterministic: bool = True,
                loss_reduction: str = "mean", labels_shifted: bool = False,
                include_aux_loss: bool = True):
        """The training forward over input_ids [b, s].  Without labels,
        the logits [b, s, vocab].  With labels, the next-token loss:
        logits[t] predicts labels[t + 1] (labels[t] when
        `labels_shifted`), positions labelled -100 ignored; "mean"
        returns the mean loss, "sum" returns (loss sum, token count) so
        that micro-batches weigh by their true token counts.  `rng` (a
        DropoutKey) and `deterministic=False` turn dropout on.  An MoE
        model adds its aux loss (scaled by the token count under "sum",
        so that sum / count is the mean loss + aux) unless
        `include_aux_loss=False` (evaluation)."""
        if loss_reduction not in ("mean", "sum"):
            raise ValueError(f"loss_reduction must be 'mean' or 'sum', got "
                             f"{loss_reduction!r}")
        hidden, aux = self.hidden_aux(input_ids, position_ids=position_ids,
                                      segment_ids=segment_ids, rng=rng,
                                      deterministic=deterministic)
        logits = self.logits(hidden)
        if labels is None:
            return logits
        if labels_shifted:
            lg, tgt = logits, labels
        else:
            lg, tgt = logits[:, :-1, :], labels[:, 1:]
        if not include_aux_loss:
            aux = None
        if loss_reduction == "sum":
            loss = softmax_cross_entropy_sparse(lg, tgt, reduction="sum")
            count = (tgt != -100).float().sum()
            return (loss if aux is None else loss + aux * count), count
        loss = softmax_cross_entropy_sparse(lg, tgt)
        return loss if aux is None else loss + aux
