"""Mixture-of-Experts on one device, the port of `hetu_tpu/nn/moe.py`.

Experts are ONE stacked parameter a leaf — `router` [h, E] fp32,
`w_gate_up` [E, h, 2, I], `w_down` [E, I, h] — as the reference holds
them.  Routing is the reference's to the index:

  * gates (`select_experts`): "topk" (GShard, the default), "top1"
    (Switch), "ktop1" (k sequential top-1 picks, each renormalized over
    the experts left), "balance" (Sinkhorn-balanced plan), "hash"
    (token id % E) and "sam" (the best group of experts, then top-k
    inside it); all share the Switch load-balance loss and the router
    z-loss (`aux_losses`), and "sam" adds its alignment hinge;
  * dispatch "sort" (the default): the (token, slot) pairs flattened
    slot-major, stably sorted by expert, positioned by an exclusive
    per-expert count prefix, and dropped past the capacity
    (`sort_routing`); tokens scatter into [E, C, h] buffers, the experts
    run, and each token gathers its k gate-weighted outputs
    (`gather_from_experts`) in the order the reference's serial
    scatter-add takes them (its pairs by expert), so the sum is one
    fixed order on every device; "dense" builds the [T, E, C] one-hot
    masks (`topk_routing`), for parity checks and tiny ablations.

Capacity is the reference's: C = cf * T * k / E rounded up to a
multiple of 8, at least 8 and at most T, over every row of the call
(the serving engine's idle slots and a chunk's padded tail route and
take capacity, as there).  With one device the reference's data groups
collapse to one (no dp/cp), and its expert-parallel dispatch
(`nn/moe_dispatch.py`) resolves to "gspmd".

The experts' two products are batched matrix products (`torch.bmm`),
as the reference's einsums are plain XLA products; between them the
SwiGLU kernel (`ops/activations.swiglu`) runs on the fused [E, C, 2, I]
gate-up, and its backward kernel in training.  The router product is
fp32 (`xt.float() @ router`; PyTorch's default keeps TF32 off).

The serving engine may keep the experts resident in int8 or int4
(`serving/experts.py`): within `resident_experts(...)` a layer takes its
two expert leaves from the loader bound to it — a working copy
dequantized for this forward alone — instead of its parameters.

Router telemetry: when a numerics collector is active, each layer's
per-expert load, its max, the routing entropy and the capacity drops
fold into the "moe" scope (`obs/numerics.py`), which the numerics
record turns into the `moe.*` gauges and the health monitor's
`router_collapse` reads.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from hetu_tpu_torch.nn.remat import project, weight_of
from hetu_tpu_torch.obs import numerics
from hetu_tpu_torch.ops.activations import swiglu

GATES = ("topk", "top1", "ktop1", "balance", "hash", "sam")
DISPATCHES = ("sort", "dense")


@dataclasses.dataclass
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    router_z_loss_coef: float = 1e-3
    load_balance_coef: float = 1e-2
    gate: str = "topk"      # one of GATES
    dispatch: str = "sort"  # "sort" (O(T·k) indices) | "dense" ([T,E,C] masks)
    sinkhorn_iters: int = 4  # balance gate only
    # SAM: experts per locality group (0 = the largest divisor of
    # num_experts <= 8); all k picks land in the token's best group
    sam_group_size: int = 0
    # weight of the SAM alignment hinge; None = load_balance_coef
    sam_alignment_coef: Optional[float] = None

    def __post_init__(self):
        if self.gate not in GATES:
            raise ValueError(f"gate={self.gate!r} not in {GATES}")
        if self.dispatch not in DISPATCHES:
            raise ValueError(f"dispatch={self.dispatch!r} not in "
                             f"{DISPATCHES}")

    def resolved_sam_alignment_coef(self) -> float:
        return (self.load_balance_coef if self.sam_alignment_coef is None
                else self.sam_alignment_coef)

    def resolved_sam_group_size(self) -> int:
        """Experts per SAM locality group (not the group count); checks
        that it divides num_experts and holds top_k."""
        gs = self.sam_group_size
        if gs == 0:
            gs = next(g for g in range(min(8, self.num_experts), 0, -1)
                      if self.num_experts % g == 0)
        if self.num_experts % gs:
            raise ValueError(f"sam_group_size {gs} must divide "
                             f"num_experts {self.num_experts}")
        if max(self.top_k, 1) > gs:
            raise ValueError(
                f"sam gate needs top_k ({self.top_k}) <= group size ({gs}):"
                " all k picks come from one group")
        return gs

    def capacity(self, tokens: int) -> int:
        """Slots an expert holds for `tokens` routed rows: cf * T * k / E
        rounded up to a multiple of 8, within [8, max(T, 8)]."""
        c = int(self.capacity_factor * tokens * max(self.top_k, 1)
                / self.num_experts)
        return max(8, min(tokens, -(-c // 8) * 8))


def _router_probs(logits: torch.Tensor) -> torch.Tensor:
    return torch.softmax(logits.float(), dim=-1)


def _sinkhorn(logits: torch.Tensor, iters: int) -> torch.Tensor:
    """Sinkhorn normalization toward rows summing to 1 and columns to
    T / E (the balanced-assignment relaxation)."""
    log_p = torch.log_softmax(logits, dim=-1)
    T, E = logits.shape
    log_col_target = torch.log(logits.new_tensor(T / E))
    for _ in range(iters):
        log_p = log_p - torch.logsumexp(log_p, dim=0, keepdim=True) \
            + log_col_target
        log_p = log_p - torch.logsumexp(log_p, dim=1, keepdim=True)
    return torch.exp(log_p)


def _one_hot(idx: torch.Tensor, n: int, dtype=torch.float32):
    return torch.nn.functional.one_hot(idx.long(), n).to(dtype)


def select_experts(logits: torch.Tensor, ids: torch.Tensor, moe: MoEConfig
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gate selection: logits [T, E] -> (expert_idx [T, k] int64,
    gate_vals [T, k] fp32).  Shared by both dispatchers."""
    T, E = logits.shape
    probs = _router_probs(logits)
    if moe.gate == "hash":
        return ((ids.long() % E)[:, None],
                torch.ones((T, 1), dtype=torch.float32, device=logits.device))
    if moe.gate == "top1":
        # Switch: the raw router probability is the gate
        gate_vals, expert_idx = torch.topk(probs, 1, dim=-1)
        return expert_idx, gate_vals
    if moe.gate == "ktop1":
        picks, gates = [], []
        remaining = probs
        for _ in range(max(moe.top_k, 1)):
            g, e = torch.topk(remaining, 1, dim=-1)
            denom = remaining.sum(dim=-1, keepdim=True)
            gates.append(g / denom.clamp_min(1e-9))
            picks.append(e)
            remaining = remaining * (1.0 - _one_hot(e[:, 0], E))
        expert_idx = torch.cat(picks, dim=1)
        gate_vals = torch.cat(gates, dim=1)
        return expert_idx, gate_vals / gate_vals.sum(
            dim=-1, keepdim=True).clamp_min(1e-9)
    if moe.gate == "balance":
        plan = _sinkhorn(logits.float(), moe.sinkhorn_iters)
        _, expert_idx = torch.topk(plan, max(moe.top_k, 1), dim=-1)
        gate_vals = torch.gather(probs, 1, expert_idx)
        return expert_idx, gate_vals / gate_vals.sum(
            dim=-1, keepdim=True).clamp_min(1e-9)
    if moe.gate == "sam":
        # the best group by gate mass, then top-k inside it; the raw
        # probabilities of the picks are the gates
        gs = moe.resolved_sam_group_size()
        grouped = probs.reshape(T, E // gs, gs)
        top1_group = torch.argmax(grouped.sum(dim=-1), dim=-1)       # [T]
        group_probs = torch.gather(
            grouped, 1, top1_group[:, None, None].expand(T, 1, gs))[:, 0]
        gate_vals, local_idx = torch.topk(group_probs, max(moe.top_k, 1),
                                          dim=-1)
        return top1_group[:, None] * gs + local_idx, gate_vals
    gate_vals, expert_idx = torch.topk(probs, moe.top_k, dim=-1)
    return expert_idx, gate_vals / gate_vals.sum(
        dim=-1, keepdim=True).clamp_min(1e-9)


def aux_losses(logits: torch.Tensor, expert_idx: torch.Tensor,
               moe: MoEConfig) -> torch.Tensor:
    """Switch load-balance loss + router z-loss (+ the SAM hinge), a 0-d
    fp32 tensor."""
    E = logits.shape[-1]
    probs = _router_probs(logits)
    me = probs.mean(dim=0)
    ce = _one_hot(expert_idx[:, 0], E).mean(dim=0)
    load_balance = E * torch.sum(me * ce)
    z = torch.mean(torch.square(torch.logsumexp(logits.float(), dim=-1)))
    aux = moe.load_balance_coef * load_balance + moe.router_z_loss_coef * z
    if moe.gate == "sam":
        # a hinge on every expert outside the chosen group whose gate
        # exceeds the weakest chosen one
        gs = moe.resolved_sam_group_size()
        chosen = torch.gather(probs, 1, expert_idx)
        tmp = chosen.min(dim=-1, keepdim=True).values
        group_of = torch.div(expert_idx[:, :1], gs, rounding_mode="floor")
        outside = (torch.arange(E, device=logits.device)[None, :] // gs
                   ) != group_of
        hinge = torch.where(outside, torch.clamp_min(probs - tmp, 0.0),
                            torch.zeros_like(probs))
        aux = aux + moe.resolved_sam_alignment_coef() * torch.sum(hinge) \
            / logits.shape[0]
    return aux


def _router_stats(logits: torch.Tensor, load_counts: torch.Tensor,
                  dropped: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Router health for the numerics observatory: the per-expert load
    (the share of TOKENS carrying each expert, summing to ~k), its max,
    the mean routing entropy (nats), the capacity drops and their share
    of the pairs."""
    probs = _router_probs(logits)
    load = load_counts.float() / float(max(logits.shape[0], 1))
    pairs = load_counts.sum().float().clamp_min(1.0)
    entropy = torch.mean(-torch.sum(probs * torch.log(probs + 1e-9),
                                    dim=-1))
    return {"load": load, "load_max": load.max(), "entropy": entropy,
            "dropped": dropped.float(), "drop_frac": dropped.float() / pairs}


def sort_routing(expert_idx: torch.Tensor, gate_vals: torch.Tensor,
                 num_experts: int, capacity: int) -> Dict[str, torch.Tensor]:
    """The sort-based routing plan, [T*k] tensors in sorted order:
    `dest` (flat index into the [E*C] buffers; E*C, a trash row, for a
    dropped pair), `tok` (source token), `gate`, `keep`, `inv` (each
    slot-major pair's position in the sorted order), and `load` ([E]
    routed pairs an expert, before drops) and `dropped` (0-d)."""
    T, k = expert_idx.shape
    TK = T * k
    e_flat = expert_idx.t().reshape(TK)       # slot-major: f = slot*T + t
    g_flat = gate_vals.t().reshape(TK)
    order = torch.argsort(e_flat, stable=True)
    e_s = e_flat[order]
    counts = torch.bincount(e_flat, minlength=num_experts)
    starts = torch.cumsum(counts, 0) - counts  # exclusive prefix
    pos = torch.arange(TK, device=e_flat.device) - starts[e_s]
    keep = pos < capacity
    dest = torch.where(keep, e_s * capacity + pos,
                       torch.full_like(pos, num_experts * capacity))
    inv = torch.empty_like(order)
    inv[order] = torch.arange(TK, device=order.device)
    return {"dest": dest, "tok": order % T, "gate": g_flat[order],
            "keep": keep, "inv": inv, "load": counts,
            "dropped": TK - keep.sum()}


def scatter_to_experts(xt: torch.Tensor, plan, num_experts: int,
                       capacity: int) -> torch.Tensor:
    """xt [T, h] -> [E, C, h].  Every kept pair owns its buffer row; the
    dropped ones land in the trash row, which is discarded, so they add
    exactly zero output and gradient."""
    h = xt.shape[1]
    n = num_experts * capacity
    buf = xt.new_zeros((n + 1, h)).index_add(0, plan["dest"],
                                             xt[plan["tok"]])
    return buf[:n].reshape(num_experts, capacity, h)


def gather_from_experts(out_ec: torch.Tensor, plan,
                        num_tokens: int) -> torch.Tensor:
    """[E, C, h] -> [T, h]: each token sums its k gate-weighted outputs
    (a dropped pair weighs 0), in sorted order (by expert): the order of
    the reference's serial scatter-add, and one fixed order on every
    device."""
    E, C, h = out_ec.shape
    out_flat = out_ec.reshape(E * C, h)
    safe = plan["dest"].clamp(max=E * C - 1)
    w = (plan["keep"] * plan["gate"]).to(out_flat.dtype)
    contrib = out_flat[safe] * w[:, None]               # sorted order
    k = contrib.shape[0] // num_tokens
    by_pair = contrib[plan["inv"]].view(k, num_tokens, h)  # [slot, token]
    if k == 1:
        return by_pair[0]
    rank = torch.argsort(plan["inv"].view(k, num_tokens), dim=0)
    ordered = torch.gather(by_pair, 0,
                           rank[:, :, None].expand(k, num_tokens, h))
    y = ordered[0]
    for j in range(1, k):
        y = y + ordered[j]
    return y


def sort_dispatch_combine(xt, plan, expert_fn: Callable, num_experts: int,
                          capacity: int) -> torch.Tensor:
    """xt [T, h] -> scatter -> expert_fn -> gather -> [T, h']."""
    out = expert_fn(scatter_to_experts(xt, plan, num_experts, capacity))
    return gather_from_experts(out, plan, xt.shape[0])


def topk_routing(logits, ids, moe: MoEConfig, capacity: int):
    """The DENSE plan: (dispatch [T, E, C] bool, combine [T, E, C] fp32,
    aux loss, dropped); the pairs in the sort plan's slot-major drop
    priority, so the two dispatchers route alike.  O(T·E·C) memory."""
    T, E = logits.shape
    expert_idx, gate_vals = select_experts(logits, ids, moe)
    k = expert_idx.shape[1]
    TK = T * k
    e_flat = expert_idx.t().reshape(TK)
    g_flat = gate_vals.t().reshape(TK)
    onehot_e = _one_hot(e_flat, E, torch.int64)                 # [TK, E]
    pos_in_e = torch.cumsum(onehot_e, dim=0) - onehot_e          # exclusive
    pos = torch.gather(pos_in_e, 1, e_flat[:, None])[:, 0]
    keep = pos < capacity
    pos_c = pos.clamp(0, capacity - 1)
    w = keep.float()
    pair_e = _one_hot(e_flat, E) * w[:, None]
    pair_c = _one_hot(pos_c, capacity)
    combine_f = torch.einsum("se,sc->sec", pair_e * g_flat[:, None], pair_c)
    combine = combine_f.reshape(k, T, E, capacity).sum(dim=0)
    disp_f = torch.einsum("se,sc->sec", pair_e, pair_c)
    dispatch = disp_f.reshape(k, T, E, capacity).sum(dim=0) > 0
    dropped = TK - keep.sum()
    return dispatch, combine, aux_losses(logits, expert_idx, moe), dropped


_resident = threading.local()


@contextlib.contextmanager
def resident_experts(loaders: Dict[int, Callable]):
    """Within it, each MoE layer whose id is a key of `loaders` takes
    its expert leaves (w_gate_up, w_down) from loaders[id(layer)]() on
    this thread, once a forward, in place of its parameters (the
    serving engine's resident int8/int4 experts)."""
    prev = getattr(_resident, "map", None)
    _resident.map = loaders
    try:
        yield
    finally:
        _resident.map = prev


class MoELayer(nn.Module):
    """Sparse SwiGLU FFN: router + E experts.  forward(x [b, s, h],
    token_ids=None) -> (y [b, s, h], aux loss)."""

    def __init__(self, hidden_size: int, intermediate_size: int,
                 moe: MoEConfig, *, param_dtype=torch.float32,
                 initializer_range: float = 0.02, device="cpu"):
        super().__init__()
        self.moe = moe
        self.hidden, self.inter = hidden_size, intermediate_size
        self.init_std = initializer_range
        E = moe.num_experts

        def param(shape, dtype):
            return nn.Parameter(torch.empty(shape, dtype=dtype,
                                            device=device),
                                requires_grad=False)
        self.router = param((hidden_size, E), torch.float32)
        self.w_gate_up = param((E, hidden_size, 2, intermediate_size),
                               param_dtype)
        self.w_down = param((E, intermediate_size, hidden_size), param_dtype)

    def reset_parameters(self, generator: torch.Generator):
        for p in (self.router, self.w_gate_up, self.w_down):
            p.normal_(0.0, self.init_std, generator=generator)

    def expert_weights(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(w_gate_up, w_down): the parameters (merged with their bound
        LoRA adapters, `nn.remat.weight_of`), or the working copy of the
        loader bound by `resident_experts`."""
        bound = getattr(_resident, "map", None)
        loader = bound.get(id(self)) if bound else None
        if loader is not None:
            return loader()
        return weight_of(self.w_gate_up), weight_of(self.w_down)

    def _experts(self, buf: torch.Tensor) -> torch.Tensor:
        """buf [E, C, h] -> [E, C, h]: gate-up product, SwiGLU, down
        product, the weights cast to buf's dtype."""
        w_gu, w_dn = self.expert_weights()
        E, C, h = buf.shape
        gu = torch.bmm(buf, w_gu.reshape(E, h, -1).to(buf.dtype))
        hidden = swiglu(gu.view(E, C, 2, self.inter))
        return torch.bmm(hidden, w_dn.to(buf.dtype))

    def logits(self, xt: torch.Tensor) -> torch.Tensor:
        """The router product xt [T, h] -> [T, E], in fp32."""
        return project(xt.float(), self.router)

    def route(self, xt: torch.Tensor, logits: torch.Tensor,
              token_ids: Optional[torch.Tensor] = None):
        """The layer after its router product: xt [T, h] and logits
        [T, E] -> (y [T, h], aux).  token_ids [T] feed the hash gate
        (default: the flat row index)."""
        moe = self.moe
        T = xt.shape[0]
        E = moe.num_experts
        capacity = moe.capacity(T)
        ids = (token_ids.reshape(T) if token_ids is not None
               else torch.arange(T, device=xt.device))
        if moe.dispatch == "dense":
            dispatch, combine, aux, dropped = topk_routing(logits, ids, moe,
                                                           capacity)
            if numerics.active():
                # the pre-drop routing intent, as the sort plan's load
                e_idx, _ = select_experts(logits, ids, moe)
                counts = torch.bincount(e_idx.reshape(-1), minlength=E)
                numerics.merge({"moe": _router_stats(logits, counts,
                                                     dropped)})
            buf = torch.einsum("th,tec->ech", xt, dispatch.to(xt.dtype))
            out = self._experts(buf)
            return torch.einsum("ech,tec->th", out,
                                combine.to(xt.dtype)), aux
        expert_idx, gate_vals = select_experts(logits, ids, moe)
        plan = sort_routing(expert_idx, gate_vals, E, capacity)
        aux = aux_losses(logits, expert_idx, moe)
        if numerics.active():
            # one data group: the reference's fold over groups is the
            # identity here
            numerics.merge({"moe": _router_stats(logits, plan["load"],
                                                 plan["dropped"])})
        y = sort_dispatch_combine(xt, plan, self._experts, E, capacity)
        return y, aux

    def forward(self, x: torch.Tensor,
                token_ids: Optional[torch.Tensor] = None):
        b, s, h = x.shape
        xt = x.reshape(b * s, h)
        y, aux = self.route(xt, self.logits(xt), token_ids)
        return y.view(b, s, h), aux
