"""The third training slice of the PyTorch port against the JAX
reference, on the CPU: parameters stored in bf16, the dynamic loss
scale, dropout, the recompute policies' kept tensors (and "offload"),
and `Trainer.evaluate`.  Checkpoints: tests/test_torch_checkpoint.py.

What is held against what:

  * bf16 parameters: three `Trainer` steps of the port and of the
    reference from the same weights and batches (fp32 compute, so the
    difference is the stored dtype's): losses and grad norms to 1e-4,
    every parameter within one bf16 ulp of the reference's;
  * the dynamic loss scale: the scale and its growth tracker after each
    step equal the reference's (growth at a growth interval of 2), and a
    step whose gradients overflow leaves p, m, v and the step count
    bit-identical, halves the scale and counts a backoff;
  * dropout: off (rate 0, or `deterministic`) the port's bits are those
    of the model without dropout, and the model matches the reference
    to the model tolerance; on, the keep share lies in a 5-sigma
    binomial band and a kept value is exactly x / (1 - r); with every
    mask forced to keep on both sides, the port's sites reproduce the
    reference's (loss and gradients); the gradients are bit-identical
    under every recompute policy and without recompute;
  * the kept set: the bytes a block keeps under each policy equal those
    of `jax.ad_checkpoint.saved_residuals` on the reference block
    (arguments and constants aside), staged on the host under
    "offload";
  * `evaluate`: token-weighted cross-entropy, perplexity and the token
    count against the reference's.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax._src.ad_checkpoint import saved_residuals

from hetu_tpu import ops as jops
from hetu_tpu.engine import Trainer as JTrainer
from hetu_tpu.engine import TrainingConfig as JTrainingConfig
from hetu_tpu.models.gpt import GPTConfig as JGPTConfig
from hetu_tpu.models.gpt import GPTLMHeadModel as JGPTLMHeadModel
from hetu_tpu.models.llama import LlamaConfig as JLlamaConfig
from hetu_tpu.models.llama import LlamaLMHeadModel as JLlamaLMHeadModel
from hetu_tpu.nn.remat import remat_policy as jremat_policy
from hetu_tpu.optim.grad_scaler import GradScaler as JGradScaler
from hetu_tpu_torch.engine import Trainer, TrainingConfig
from hetu_tpu_torch.models.gpt import GPTConfig, GPTLMHeadModel
from hetu_tpu_torch.models.llama import (LlamaConfig, LlamaLMHeadModel,
                                         load_jax_params)
from hetu_tpu_torch.nn import remat as tremat
from hetu_tpu_torch.ops import activations as tact
from hetu_tpu_torch.optim.grad_scaler import GradScaler
from test_torch_parity import HD128, MODEL_TOL

#: GPT at head dim 64, as GPT-2's
HD64 = dict(hidden_size=256, num_attention_heads=4)
FAMILIES = ("llama", "gpt")
POLICIES = ("nothing", "dots", "dots_attn", "offload")
_TRAIN = dict(global_batch_size=4, micro_batch_size=2, seq_len=16,
              warmup_steps=1, total_steps=10, log_every=100, lr=1e-3)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _configs(family, *, bf16=False, **kw):
    """(JAX config, port config) of `family` at the tests' widths, fp32
    compute, the dense attention, parameters in bf16 when `bf16`."""
    jkw, tkw = dict(kw), dict(kw)
    if bf16:
        jkw["param_dtype"], tkw["param_dtype"] = jnp.bfloat16, torch.bfloat16
    if family == "llama":
        return (JLlamaConfig.tiny(compute_dtype=jnp.float32,
                                  use_flash_attention=False, **HD128, **jkw),
                LlamaConfig.tiny(compute_dtype=torch.float32, **HD128, **tkw))
    return (JGPTConfig.tiny(compute_dtype=jnp.float32,
                            use_flash_attention=False, **HD64, **jkw),
            GPTConfig.tiny(compute_dtype=torch.float32, **HD64, **tkw))


def _model_classes(family):
    return ((JLlamaLMHeadModel, LlamaLMHeadModel) if family == "llama"
            else (JGPTLMHeadModel, GPTLMHeadModel))


def _trainers(family, *, bf16=False, cfg=None, train=None, setup=None):
    """The reference Trainer and the port's on the CPU from the same
    params (the reference's init), `setup(jtr, tr)` before either
    builds."""
    jcfg, tcfg = _configs(family, bf16=bf16, **(cfg or {}))
    jcls, tcls = _model_classes(family)
    train = dict(_TRAIN, **(train or {}))
    jtr = JTrainer(jcls(jcfg), JTrainingConfig(**train))
    model = tcls(tcfg, device="cpu")
    tr = Trainer(model, TrainingConfig(**train), device="cpu")
    if setup is not None:
        setup(jtr, tr)
    jtr.build()
    load_jax_params(model, _np(jtr.params))
    return jtr, tr


def _by_name(tree, like):
    """The reference's params tree as {port parameter name: fp32 tensor},
    through the loader's own mapping."""
    scratch = type(like)(like.config, device="cpu")
    load_jax_params(scratch, _np(tree))
    return {n: p.float() for n, p in scratch.named_parameters()}


def _batch(vocab, seed, b=4, s=16):
    ids = np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)
    labels = ids.copy()
    labels[0, 3:7] = -100
    return {"input_ids": ids, "labels": labels}


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each element of x (the spacing at |x|; at zero,
    the smallest normal's)."""
    e = torch.floor(torch.log2(x.abs().float().clamp(min=2.0 ** -126)))
    return torch.exp2(e - 7)


def _adam_direction(m, v, step: int, opt) -> torch.Tensor:
    """AdamW's direction m^ / (sqrt(v^) + eps) from the moments after
    `step`."""
    c1, c2 = 1.0 - opt.b1 ** step, 1.0 - opt.b2 ** step
    return (m / c1) / (torch.sqrt(v / c2) + opt.eps)


# ------------------------------------------------------ bf16 parameters
@pytest.mark.parametrize("family", FAMILIES)
def test_bf16_parameter_steps_match_the_reference(family):
    """Parameters stored in bf16 with fp32 accumulators and AdamW's bf16
    arm: three steps' losses and grad norms to 1e-4; every parameter
    element within one bf16 ulp a step — at the larger of the two sides'
    values after that step, the rounding each step's store makes — plus
    what the two sides' AdamW directions differ by:
    |p - p_ref| <= sum_t (ulp_t + lr_t |u_t - u_ref,t|), u = m^ / (sqrt(v^)
    + eps) from each side's moments after step t.  A wrong update (a sign,
    a skipped or doubled step) moves an element by lr |u| with the moments
    equal, and fails.  Past one ulp of the final value (measured: 67 of
    1.31M elements, 0.005%, LLaMA, in the four projections; 3,742 of
    1.71M, 0.22%, GPT, in every matrix and bias, most in the projections,
    522 in the q/k/v bias): elements near zero (median |p| ~1.5e-4, init
    std 0.02), whose ulp is far below a step of lr ~1e-3, where a bf16
    rounding of the gradient that falls the other way on one side (the
    cast's backward rounds every bf16 parameter's gradient) moves u; and
    a few (GPT: 4) where one side's gradient is a rounding residue, which
    AdamW moves by as much as any gradient (its first step is
    lr sign(g)).  The
    moments to 2^-6 of each leaf's largest entry (measured 0.35-0.83%,
    the same roundings; GPT's tied table sums two such gradients)."""
    jtr, tr = _trainers(family, bf16=True)
    model, opt = tr.model, tr.optimizer
    fp32 = type(model)(dataclasses.replace(model.config,
                                           param_dtype=torch.float32),
                       device="cpu")
    params = dict(model.named_parameters())
    bound = {n: torch.zeros(p.shape) for n, p in params.items()}
    for step in range(1, 4):
        batch = _batch(256, 59 + step)
        jm, tm = jtr.train_step(batch), tr.train_step(batch)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                       err_msg=f"step {step} {k}")
        ref_p = _by_name(jtr.params, model)
        ref_m = _by_name(jtr.opt_state["m"], fp32)
        ref_v = _by_name(jtr.opt_state["v"], fp32)
        for name, m, v in zip(tr.names, tr.opt_state["m"], tr.opt_state["v"]):
            gap = (_adam_direction(m, v, step, opt)
                   - _adam_direction(ref_m[name], ref_v[name], step, opt))
            bound[name] += opt._lr(step) * gap.abs() + _bf16_ulp(
                torch.maximum(params[name].detach().float().abs(),
                              ref_p[name].abs()))
    assert all(p.dtype == torch.bfloat16 for p in tr.params)
    assert all(a.dtype == torch.float32 for a in tr._accum)
    ref = _by_name(jtr.params, model)
    for name, p in params.items():
        d = (p.detach().float() - ref[name]).abs()
        assert bool((d <= bound[name]).all()), \
            (name, float((d / bound[name]).max()))
    for key in ("m", "v"):
        mine = dict(zip(tr.names, tr.opt_state[key]))
        scratch = _by_name(jtr.opt_state[key], fp32)
        for name, m in mine.items():
            scale = float(scratch[name].abs().max())
            assert float((m - scratch[name]).abs().max()) <= 2 ** -6 * scale, \
                (key, name)


# -------------------------------------------------------- the loss scale
def test_grad_scaler_updates_match_the_reference():
    """The scaler's update over a sequence of finite and non-finite
    steps, growth interval 3: scale and tracker equal at every step."""
    flags = [True, True, True, False, True, True, True, True, False, True]
    jsc, tsc = JGradScaler(growth_interval=3), GradScaler(growth_interval=3)
    js, ts = jsc.init(), tsc.init(device="cpu")
    for f in flags:
        js = jsc.update(js, jnp.asarray(f))
        ts = tsc.update(ts, torch.tensor(f))
        assert float(ts["scale"]) == float(js["scale"])
        assert int(ts["growth_tracker"]) == int(js["growth_tracker"])


def _overflowing_batch():
    """One token everywhere: the tied/untied head's row of that token
    takes every position's gradient, which the largest fp32 scale pushes
    past fp32's range."""
    ids = np.full((4, 16), 7, np.int32)
    return {"input_ids": ids, "labels": ids.copy()}


@pytest.mark.parametrize("family", FAMILIES)
def test_dynamic_loss_scale_matches_the_reference(family):
    """`loss_scale="dynamic"`, bf16 parameters, growth interval 2: after
    each of four steps the scale and tracker equal the reference's (two
    growths), as do loss, grad norm and the metrics; then a step at the
    largest fp32 scale overflows on both sides: the port leaves p, m, v
    and the step count bit-identical, the scale halves, the tracker
    resets and the registry counts the transitions, one step late."""
    def setup(jtr, tr):
        jtr._scaler.growth_interval = 2
        tr._scaler.growth_interval = 2
    jtr, tr = _trainers(family, bf16=True, train=dict(loss_scale="dynamic"),
                        setup=setup)
    for step in range(4):
        batch = _batch(256, 70 + step)
        jm, tm = jtr.train_step(batch), tr.train_step(batch)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4)
        assert float(tm["loss_scale"]) == float(jm["loss_scale"])
        assert float(tm["amp_skipped"]) == float(jm["amp_skipped"]) == 0.0
        assert float(tr.scaler_state["scale"]) == float(
            jtr.scaler_state["scale"])
        assert int(tr.scaler_state["growth_tracker"]) == int(
            jtr.scaler_state["growth_tracker"])
    assert float(tr.scaler_state["scale"]) == 2.0 ** 18
    tr.settle()     # read step 4's scale: the growths at steps 2 and 4
    reg = tr.registry
    assert reg.counter_value("scaler.growth") == 2
    assert reg.counter_value("scaler.backoff") == 0
    big = float(np.finfo(np.float32).max)
    jtr.scaler_state = dict(jtr.scaler_state, scale=jnp.float32(big))
    tr.scaler_state["scale"].fill_(big)
    before = tr.state()
    saved = {k: [t.clone() for t in before["opt_state"][k].values()]
             for k in ("m", "v")}
    params = [p.detach().clone() for p in tr.params]
    step_before = before["opt_state"]["step"]
    batch = _overflowing_batch()
    jm, tm = jtr.train_step(batch), tr.train_step(batch)
    assert float(jm["amp_skipped"]) == float(tm["amp_skipped"]) == 1.0
    assert math.isnan(float(tm["grad_norm"]))
    assert float(tr.scaler_state["scale"]) == big * 0.5 == float(
        jtr.scaler_state["scale"])
    assert int(tr.scaler_state["growth_tracker"]) == 0
    after = tr.state()
    assert after["opt_state"]["step"] == step_before == int(
        jtr.opt_state["step"])
    assert after["step"] == 5 and tr.global_step == 5
    for old, new in zip(params, tr.params):
        assert torch.equal(old, new.detach())
    for k in ("m", "v"):
        for old, new in zip(saved[k], after["opt_state"][k].values()):
            assert torch.equal(old, new)
    assert reg.gauge_value("scaler.loss_scale") == big * 0.5


def test_settle_reads_each_step_one_step_late():
    """`settle` reads the pending (finite, scale) pair of the last scaled
    step: a skipped step is taken back from AdamW's count, a lower scale
    counts a backoff, a higher one a growth, the first reading neither."""
    tr = Trainer(LlamaLMHeadModel(LlamaConfig.tiny(), device="cpu"),
                 TrainingConfig(loss_scale="dynamic"), device="cpu").build()
    tr.opt_state["step"] = 5
    for finite, scale in ((1.0, 8.0), (0.0, 4.0), (1.0, 8.0)):
        tr._pending = (torch.tensor([finite, scale]), None)
        tr.settle()
        assert tr._pending is None
        tr.settle()                              # nothing pending: no-op
    assert tr.opt_state["step"] == 4
    reg = tr.registry
    assert reg.counter_value("scaler.backoff") == 1
    assert reg.counter_value("scaler.growth") == 1
    assert reg.gauge_value("scaler.loss_scale") == 8.0


# --------------------------------------------------------------- dropout
@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_keep_share_and_kept_values(rate, dtype):
    """On 2^20 elements the kept share lies within 5 sigma of 1 - rate;
    a kept element is x / (1 - rate) with 1 - rate in x's dtype (JAX's
    weak-typed float), a dropped one 0; the same key draws the same mask
    and another key an independent one; the backward is the same mask,
    scaled."""
    n = 1 << 20
    x = torch.randn(n, generator=torch.Generator().manual_seed(1)).to(dtype)
    x.requires_grad_(True)
    key = tact.DropoutKey((3, 5, 1, 0, 2))
    y = tact.dropout(x, rate, key, deterministic=False)
    keep = y != 0
    share = float(keep.float().mean())
    sigma = math.sqrt(rate * (1 - rate) / n)
    assert abs(share - (1 - rate)) <= 5 * sigma
    q = x.detach() / torch.tensor(1 - rate, dtype=dtype)
    assert torch.equal(y.detach()[keep], q[keep])
    again = tact.dropout(x, rate, key, deterministic=False)
    assert torch.equal(again, y)
    other = tact.dropout(x, rate, key.fold(1), deterministic=False) != 0
    both = float((other == keep).float().mean())
    expect = (1 - rate) ** 2 + rate ** 2
    assert abs(both - expect) <= 5 * math.sqrt(expect * (1 - expect) / n)
    y.sum().backward()
    g = torch.where(keep, torch.ones_like(x) / torch.tensor(
        1 - rate, dtype=dtype), torch.zeros_like(x))
    assert torch.equal(x.grad, g.detach())
    assert tact.dropout(x, rate, key, deterministic=True) is x
    assert tact.dropout(x, 0.0, key, deterministic=False) is x


def _port_loss_and_grads(model, batch, rng=None, deterministic=True):
    for p in model.parameters():
        p.requires_grad_(True)
        p.grad = None
    loss = model(torch.from_numpy(batch["input_ids"]),
                 torch.from_numpy(batch["labels"]), rng=rng,
                 deterministic=deterministic)
    loss.backward()
    return loss.detach(), {n: p.grad.clone()
                           for n, p in model.named_parameters()}


def _pair_models(family, seed=2, **cfg):
    """(JAX model, params, port model) sharing the reference's init."""
    jcfg, tcfg = _configs(family, **cfg)
    jcls, tcls = _model_classes(family)
    jmodel = jcls(jcfg)
    jparams = jmodel.init(jax.random.key(seed))
    tmodel = tcls(tcfg, device="cpu")
    load_jax_params(tmodel, _np(jparams))
    return jmodel, jparams, tmodel


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("off", ["deterministic", "rate_0"])
def test_dropout_off_is_the_model_without_dropout(family, off):
    """Dropout rates 0.1 with `deterministic`, or rates 0 with a key:
    the loss and every gradient have the bits of the configuration
    without dropout; and the model matches the reference's (dropout off
    there too) to the model tolerance."""
    jmodel, jparams, plain = _pair_models(family)
    rates = 0.1 if off == "deterministic" else 0.0
    _, _, dropping = _pair_models(family, attention_dropout=rates,
                                  hidden_dropout=rates)
    batch = _batch(256, 80, b=2)
    ref_loss, ref_grads = _port_loss_and_grads(plain, batch)
    key = tact.DropoutKey((1, 0, 0))
    loss, grads = _port_loss_and_grads(
        dropping, batch, rng=key, deterministic=off == "deterministic")
    assert torch.equal(loss, ref_loss)
    for name, g in grads.items():
        assert torch.equal(g, ref_grads[name]), name
    jloss = jmodel(jparams, jnp.asarray(batch["input_ids"]),
                   labels=jnp.asarray(batch["labels"]))
    np.testing.assert_allclose(float(loss), float(jloss), atol=MODEL_TOL)


@pytest.mark.parametrize("family", FAMILIES)
def test_dropout_sites_match_the_reference_with_every_mask_kept(
        family, monkeypatch):
    """Every mask forced to keep on both sides (the reference's
    `jax.random.bernoulli`, the port's `keep_mask`), rates 0.1: each
    site scales by 1 / 0.9 where the reference's does, so loss and
    every gradient match to the model tolerance (of each leaf's largest
    entry), and the loss differs from the one without dropout."""
    jmodel, jparams, tmodel = _pair_models(family, attention_dropout=0.1,
                                           hidden_dropout=0.1)
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p, shape: jnp.ones(shape, bool))
    monkeypatch.setattr(tact, "keep_mask",
                        lambda shape, rate, key, device: torch.ones(
                            shape, dtype=torch.bool, device=device))
    batch = _batch(256, 81, b=2)
    ids, labels = jnp.asarray(batch["input_ids"]), jnp.asarray(
        batch["labels"])
    jloss, jgrads = jax.value_and_grad(
        lambda p: jmodel(p, ids, labels=labels, rng=jax.random.key(0),
                         deterministic=False))(jparams)
    loss, grads = _port_loss_and_grads(tmodel, batch,
                                       rng=tact.DropoutKey((1, 0, 0)),
                                       deterministic=False)
    np.testing.assert_allclose(float(loss), float(jloss), atol=MODEL_TOL)
    ref = _by_name(jgrads, tmodel)
    for name, g in grads.items():
        scale = float(ref[name].abs().max())
        np.testing.assert_allclose(g.numpy(), ref[name].numpy(),
                                   atol=MODEL_TOL * scale, err_msg=name)
    plain = float(jmodel(jparams, ids, labels=labels))
    assert abs(float(loss) - plain) > 1e-3


@pytest.mark.parametrize("family", FAMILIES)
def test_dropout_gradients_identical_under_every_policy(family):
    """Rates 0.1, one key, the models' bf16 compute: the loss and every
    gradient have the same bits without recompute and under "nothing",
    "dots", "dots_attn" and "offload" (the masks are drawn again, not
    kept).  (In fp32 compute the norms' composition reads x three times
    and the segments sum those gradients in another order: the same to
    rounding, not to the bit.)"""
    key = tact.DropoutKey((9, 4, 1))
    batch = _batch(256, 82, b=2)
    runs = {}
    cls = _model_classes(family)[1]
    ccls, widths = ((LlamaConfig, HD128) if family == "llama"
                    else (GPTConfig, HD64))
    for policy in (None,) + POLICIES:
        cfg = dict(widths, attention_dropout=0.1, hidden_dropout=0.1)
        if policy is None:
            cfg["remat"] = False
        else:
            cfg["remat_policy"] = policy
        model = cls(ccls.tiny(**cfg), device="cpu", seed=5)
        runs[policy] = _port_loss_and_grads(model, batch, rng=key,
                                            deterministic=False)
    loss0, grads0 = runs[None]
    for policy, (loss, grads) in runs.items():
        assert torch.equal(loss, loss0), policy
        for name, g in grads.items():
            assert torch.equal(g, grads0[name]), (policy, name)


# ------------------------------------------------------------ kept bytes
def _reference_kept(family, policy):
    """(device bytes, host bytes) of the reference block's residuals
    under `policy`, arguments and constants aside, dropout on."""
    jcfg = (JLlamaConfig if family == "llama" else JGPTConfig).tiny(
        remat_policy=policy, attention_dropout=0.1, hidden_dropout=0.1)
    jmodel = _model_classes(family)[0](jcfg)
    params = jmodel.init(jax.random.key(0))
    b, s = 2, 16
    x = jnp.ones((b, s, jcfg.hidden_size), jcfg.compute_dtype)
    if family == "llama":
        block = jmodel.model.layers.block
        lp = jax.tree.map(lambda a: a[0], params["model"]["layers"]["layers"])
        cos, sin = jops.build_rope_cache(jcfg.max_position_embeddings,
                                         jcfg.head_dim, jcfg.rope_theta,
                                         dtype=jnp.float32)

        def fn(lp, x, rng):
            return block(lp, x, cos=cos, sin=sin, rng=rng,
                         deterministic=False)[0]
    else:
        block = jmodel.model.block
        lp = jax.tree.map(lambda a: a[0], params["model"]["blocks"])

        def fn(lp, x, rng):
            return block(lp, x, rng=rng, deterministic=False)
    res = saved_residuals(jax.checkpoint(fn, policy=jremat_policy(policy)),
                          lp, x, jax.random.key(1))
    device = host = 0
    for aval, why in res:
        if why.startswith("from the argument") or why == "from a constant":
            continue
        nbytes = math.prod(aval.shape) * aval.dtype.itemsize
        if "<host>" in aval.str_short():
            host += nbytes
        else:
            device += nbytes
    return device, host


def _port_kept(family, policy):
    """(device bytes, host bytes) the port's block keeps under `policy`
    beyond its arguments and parameters, counted by
    `saved_tensors_hooks` (the host bytes by the offload counter)."""
    cls = LlamaLMHeadModel if family == "llama" else GPTLMHeadModel
    ccls = LlamaConfig if family == "llama" else GPTConfig
    model = cls(ccls.tiny(remat_policy=policy, attention_dropout=0.1,
                          hidden_dropout=0.1), device="cpu")
    for p in model.parameters():
        p.requires_grad_(True)
    c = model.config
    b, s = 2, 16
    x = torch.ones((b, s, c.hidden_size), dtype=c.compute_dtype,
                   requires_grad=True)
    args = (model.rope_at(b, s) or ()) + (None,)
    block = model.layers[0]
    kept = {}
    outside = [x, *(a for a in args if a is not None), *block.parameters()]

    def pack(t):
        if not tremat._shares_storage(t, outside):
            kept[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
        return t
    key = tact.DropoutKey((1, 0, 0))
    host0 = tremat.offloaded_bytes
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        if policy == "offload":
            with tremat.offloading(keep=outside):
                out = block.forward_remat(x, *args, key, policy="dots")
        else:
            out = block.forward_remat(x, *args, key, policy=policy)
    out.float().sum().backward()
    return sum(kept.values()), tremat.offloaded_bytes - host0


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("family", FAMILIES)
def test_kept_bytes_match_the_reference_residuals(family, policy):
    """The tensors a block keeps for its backward under each policy —
    the projections' outputs (qkv, o, gate-up / up), and the attention's
    output under "dots_attn" — have the bytes of the reference's
    residuals; under "offload" those bytes sit on the host and nothing
    beyond the arguments stays on the device.  (On the card the flash
    route also keeps its lse under "dots_attn", [b, hq, s] fp32: the CPU
    route is the dense attention, as the reference's is.)"""
    assert _port_kept(family, policy) == _reference_kept(family, policy)


# -------------------------------------------------------------- evaluate
@pytest.mark.parametrize("family", FAMILIES)
def test_evaluate_matches_the_reference(family):
    """Token-weighted cross-entropy over two batches with ignored
    labels (1e-5 relative), its perplexity and the token count."""
    jtr, tr = _trainers(family)
    batches = [_batch(256, 90 + i) for i in range(2)]
    jout, tout = jtr.evaluate(batches), tr.evaluate(batches)
    np.testing.assert_allclose(tout["loss"], jout["loss"], rtol=1e-5)
    np.testing.assert_allclose(tout["perplexity"], jout["perplexity"],
                               rtol=1e-4)
    assert tout["tokens"] == jout["tokens"] == 2 * (4 * 15 - 4)
