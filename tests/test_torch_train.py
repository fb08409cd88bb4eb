"""The PyTorch port's training slice against the JAX reference, on the
CPU.

What is held against what:

  * the ops the training forward adds (dense attention, the LM loss)
    and the optimizer pieces (schedule, clipping, AdamW) against their
    JAX counterparts at 1e-5 (fp32);
  * the model: loss and the gradient of every parameter of
    `LlamaLMHeadModel.forward(ids, labels=...)` against
    `jax.value_and_grad` of the JAX model, params carried across by
    `load_jax_params`, fp32, at 1e-4 (docs/kernels.md: a model's worth
    of reassociated sums), with per-block recompute on and off;
  * the slice as a whole: the port's `Trainer` and the JAX `Trainer`
    (single device, built once per file) for three steps from the same
    params and batches — loss, grad norm, lr, and the parameters and
    both AdamW moments after the last step.

On the CPU every kernel wrapper runs its plain version, so these tests
also pin the plain versions the card's kernels are checked against.
The kernels' own forward/backward parity with the Pallas kernels is in
tests/test_torch_kernels.py; the card runs tests/test_torch_cuda.py.
"""
from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from hetu_tpu import ops as jops
from hetu_tpu.engine import Trainer as JTrainer
from hetu_tpu.engine import TrainingConfig as JTrainingConfig
from hetu_tpu.models.llama import LlamaConfig as JLlamaConfig
from hetu_tpu.models.llama import LlamaLMHeadModel as JLlamaLMHeadModel
from hetu_tpu.optim import optimizer as joptim
from hetu_tpu_torch.engine import Trainer, TrainingConfig
from hetu_tpu_torch.models.llama import (LlamaConfig, LlamaLMHeadModel,
                                         load_jax_params)
from hetu_tpu_torch.ops import attention as tattention
from hetu_tpu_torch.ops import losses as tlosses
from hetu_tpu_torch.optim import optimizer as toptim
from test_torch_parity import HD128, MODEL_TOL, jax_llama_and_port

TOL = 1e-5


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port(jparams, **kw):
    """A CPU port model (fp32 compute, HD128 widths) holding jparams."""
    model = LlamaLMHeadModel(
        LlamaConfig.tiny(compute_dtype=torch.float32, **HD128, **kw),
        device="cpu")
    load_jax_params(model, _np(jparams))
    return model


def _by_name(tree, like: LlamaLMHeadModel):
    """A pytree shaped like the reference's params (grads, moments), as
    {port parameter name: tensor}, through the same mapping that loads
    the weights."""
    scratch = LlamaLMHeadModel(like.config, device="cpu")
    load_jax_params(scratch, _np(tree))
    return dict(scratch.named_parameters())


def _batch(vocab, seed, b=2, s=16):
    """ids [b, s] and labels = ids with a few positions at -100."""
    ids = np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)
    labels = ids.copy()
    labels[0, 3:7] = -100
    return ids, labels


# ------------------------------------------------------------------ ops
@pytest.mark.parametrize("sq,sk,hq,hk,segments", [
    (8, 8, 4, 2, False),       # GQA, square causal
    (5, 12, 4, 4, False),      # sq < sk: the mask aligns bottom-right
    (8, 8, 2, 1, True),        # segment ids (packed sequences)
])
def test_attention_matches_reference(sq, sk, hq, hk, segments):
    q, k, v = (_rand((2, sq, hq, 16), 1), _rand((2, sk, hk, 16), 2),
               _rand((2, sk, hk, 16), 3))
    seg = (np.repeat(np.array([[0, 0, 0, 1, 1, 1, 1, 2]], np.int32), 2, 0)
           if segments else None)
    ref = jops.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=True,
                         segment_ids=None if seg is None else jnp.asarray(seg))
    out = tattention.flash_attention(
        *map(torch.from_numpy, (q, k, v)), causal=True,
        segment_ids=None if seg is None else torch.from_numpy(seg),
        device="cpu")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL)


def test_flash_attention_on_the_card_refuses_until_ported():
    """Flash on a CUDA device raises (the second training slice brings
    its kernels); the check is the wrapper's device argument, so no card
    is needed to see it."""
    q = torch.zeros(1, 4, 2, 16)
    with pytest.raises(NotImplementedError, match="second training slice"):
        tattention.flash_attention(q, q, q, device="cuda")
    out = tattention.flash_attention(q, q, q, use_pallas=False,
                                     device="cpu")
    assert out.shape == q.shape


@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_cross_entropy_matches_reference(reduction):
    logits = _rand((2, 7, 50), 4) * 3
    labels = np.random.default_rng(5).integers(0, 50, (2, 7)).astype(
        np.int32)
    labels[1, 2:5] = -100
    ref = jops.softmax_cross_entropy_sparse(
        jnp.asarray(logits), jnp.asarray(labels), reduction=reduction)
    out = tlosses.softmax_cross_entropy_sparse(
        torch.from_numpy(logits), torch.from_numpy(labels),
        reduction=reduction)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL)


# ------------------------------------------------------------ optimizer
def test_cosine_schedule_matches_reference():
    """Warmup then cosine, in fp32 on the host as the reference computes
    it in its graph."""
    jlr = joptim.cosine_schedule(3e-4, 3, 10, 0.1)
    tlr = toptim.cosine_schedule(3e-4, 3, 10, 0.1)
    for step in range(14):
        np.testing.assert_allclose(tlr(step), float(jlr(step)), rtol=1e-6)
    assert toptim.constant_schedule(0.1)(5) == float(
        joptim.constant_schedule(0.1)(5))


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_reference(max_norm):
    grads = [_rand((8, 16), 6), _rand((5,), 7)]
    jclipped, jnorm = joptim.clip_by_global_norm(
        [jnp.asarray(g) for g in grads], max_norm)
    tclipped, tnorm = toptim.clip_by_global_norm(
        [torch.from_numpy(g.copy()) for g in grads], max_norm)
    np.testing.assert_allclose(float(tnorm), float(jnorm), rtol=TOL)
    for a, b in zip(tclipped, jclipped):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                   atol=1e-7)


@pytest.mark.parametrize("kind", ["AdamW", "Adam"])
def test_adamw_matches_reference_over_two_steps(kind):
    """Every leaf — a ragged one too — through the fused update (its
    plain version here), decay on every leaf, against the reference's
    AdamW with a cosine lr, two steps; `Adam` is AdamW without decay and
    with b2 = 0.999."""
    params = {"w": _rand((8, 128), 8), "g": _rand((5,), 9)}
    grads = {"w": _rand((8, 128), 10) * 0.1, "g": _rand((5,), 11) * 0.1}
    if kind == "AdamW":
        jopt = joptim.AdamW(lr=joptim.cosine_schedule(1e-2, 1, 10),
                            weight_decay=0.1)
        topt = toptim.AdamW(lr=toptim.cosine_schedule(1e-2, 1, 10),
                            weight_decay=0.1, device="cpu")
    else:
        jopt, topt = joptim.Adam(lr=1e-2), toptim.Adam(lr=1e-2, device="cpu")
    jp, js = params, jopt.init(params)
    names = sorted(params)
    tp = [torch.from_numpy(params[n].copy()) for n in names]
    ts = topt.init(tp)
    for _ in range(2):
        jp, js = jopt.update(grads, js, jp)
        topt.update([torch.from_numpy(grads[n]) for n in names], ts, tp)
    assert ts["step"] == int(js["step"]) == 2
    for i, n in enumerate(names):
        for a, b in ((tp[i], jp[n]), (ts["m"][i], js["m"][n]),
                     (ts["v"][i], js["v"][n])):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=3e-7,
                                       atol=1e-8)


# ---------------------------------------------------------------- model
@pytest.fixture(scope="module")
def pair():
    return jax_llama_and_port(seed=3, **HD128)


@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_every_gradient_match_the_reference(pair, remat):
    """The training forward's loss and the gradient of every parameter,
    with per-block recompute on and off; every parameter gets one."""
    jmodel, jparams, _ = pair
    tmodel = _port(jparams, remat=remat)
    ids, labels = _batch(tmodel.config.vocab_size, 20)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jmodel(p, jnp.asarray(ids), labels=jnp.asarray(labels)))(
        jparams)
    for p in tmodel.parameters():
        p.requires_grad_(True)
    tloss = tmodel(torch.from_numpy(ids), torch.from_numpy(labels))
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               atol=MODEL_TOL)
    ref = _by_name(jgrads, tmodel)
    for name, p in tmodel.named_parameters():
        assert p.grad is not None, name
        assert bool(p.grad.abs().sum() > 0), name
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(),
                                   atol=MODEL_TOL, err_msg=name)


def test_sum_reduction_returns_loss_sum_and_token_count(pair):
    """"sum" returns (loss sum, count of labels that are not -100) — the
    pair the trainer accumulates over micro-batches."""
    jmodel, jparams, tmodel = pair
    ids, labels = _batch(tmodel.config.vocab_size, 21)
    jsum, jcount = jmodel(jparams, jnp.asarray(ids),
                          labels=jnp.asarray(labels), loss_reduction="sum")
    with torch.no_grad():
        tsum, tcount = tmodel(torch.from_numpy(ids),
                              torch.from_numpy(labels), loss_reduction="sum")
        tmean = tmodel(torch.from_numpy(ids), torch.from_numpy(labels))
    assert float(tcount) == float(jcount) == (labels[:, 1:] != -100).sum()
    np.testing.assert_allclose(float(tsum), float(jsum), rtol=MODEL_TOL)
    np.testing.assert_allclose(float(tmean), float(tsum) / float(tcount),
                               rtol=TOL)


def test_ignored_labels_do_not_reach_the_loss(pair):
    """The loss is the mean next-token cross entropy over the positions
    whose label is not -100, from the reference's logits; the port's
    logits without labels match the reference's."""
    jmodel, jparams, tmodel = pair
    ids, labels = _batch(tmodel.config.vocab_size, 22)
    with torch.no_grad():
        loss = tmodel(torch.from_numpy(ids), torch.from_numpy(labels))
        logits = tmodel(torch.from_numpy(ids))
    jlogits = np.asarray(jmodel(jparams, jnp.asarray(ids)), np.float64)
    np.testing.assert_allclose(logits.numpy(), jlogits, atol=MODEL_TOL)
    lg, tgt = jlogits[:, :-1], labels[:, 1:]
    logz = np.log(np.exp(lg - lg.max(-1, keepdims=True)).sum(-1)) \
        + lg.max(-1)
    keep = tgt != -100
    ce = logz - np.take_along_axis(lg, np.where(keep, tgt, 0)[..., None],
                                   -1)[..., 0]
    np.testing.assert_allclose(float(loss), ce[keep].mean(), rtol=1e-5)


def test_loads_the_per_layer_layout():
    """A `use_scan=False` reference (per-layer `layer_<i>` subtrees, the
    layout bench.py trains) loads key for key and gives the same
    logits."""
    jcfg = JLlamaConfig.tiny(remat=False, compute_dtype=jnp.float32,
                             use_flash_attention=False, use_scan=False,
                             **HD128)
    jmodel = JLlamaLMHeadModel(jcfg)
    jparams = jmodel.init(jax.random.key(4))
    assert "layer_0" in jparams["model"]["layers"]
    tmodel = _port(jparams)
    np.testing.assert_array_equal(
        tmodel.model.layers[1].mlp.w_gate_up.numpy(),
        np.asarray(jparams["model"]["layers"]["layer_1"]["mlp"]["w_gate_up"]))
    ids, _ = _batch(jcfg.vocab_size, 23)
    with torch.no_grad():
        out = tmodel(torch.from_numpy(ids))
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(jmodel(jparams, jnp.asarray(ids))),
                               atol=MODEL_TOL)


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_load_jax_params_refuses_a_mismatched_per_layer_tree(fault):
    jcfg = JLlamaConfig.tiny(compute_dtype=jnp.float32, use_scan=False,
                             use_flash_attention=False, **HD128)
    tree = _np(JLlamaLMHeadModel(jcfg).init(jax.random.key(5)))
    layers = tree["model"]["layers"]
    if fault == "missing":
        del layers["layer_1"]
    elif fault == "extra":
        layers["layer_2"] = layers["layer_0"]
    else:
        layers["layer_0"]["post_norm"]["weight"] = np.ones(7, np.float32)
    tmodel = LlamaLMHeadModel(
        LlamaConfig.tiny(compute_dtype=torch.float32, **HD128), device="cpu")
    before = tmodel.model.final_norm.weight.clone()
    with pytest.raises(ValueError):
        load_jax_params(tmodel, tree)
    assert torch.equal(tmodel.model.final_norm.weight, before)


# -------------------------------------------------------------- trainer
_TRAIN = dict(global_batch_size=4, micro_batch_size=2, seq_len=16,
              warmup_steps=1, total_steps=10, log_every=100)


@pytest.fixture(scope="module")
def three_steps():
    """The JAX Trainer (single device, the reference's default remat and
    stacked layers) and the port's Trainer on the CPU, from the same
    params, over the same three seeded batches (two micro-batches each,
    with ignored labels)."""
    jcfg = JLlamaConfig.tiny(compute_dtype=jnp.float32,
                             use_flash_attention=False, **HD128)
    jtr = JTrainer(JLlamaLMHeadModel(jcfg), JTrainingConfig(**_TRAIN)).build()
    model = _port(jtr.params)
    tr = Trainer(model, TrainingConfig(**_TRAIN), device="cpu")
    steps = []
    for seed in range(3):
        ids, labels = _batch(jcfg.vocab_size, 30 + seed, b=4)
        batch = {"input_ids": ids, "labels": labels}
        jm = jtr.train_step(batch)
        tm = tr.train_step(batch)
        steps.append({k: (float(tm[k]), float(jm[k]))
                      for k in ("loss", "grad_norm", "lr")})
    return steps, jtr, tr


def test_trainer_steps_match_the_reference(three_steps):
    """Per step: loss (the token-weighted mean over both micro-batches)
    and grad norm to 1e-5 relative (fp32 sums in another order); lr to
    1e-6 (the host's fp32 cosine against XLA's)."""
    steps, _, tr = three_steps
    assert tr.global_step == 3 and tr.opt_state["step"] == 3
    for step in steps:
        for k, tol in (("loss", TOL), ("grad_norm", TOL), ("lr", 1e-6)):
            port, ref = step[k]
            np.testing.assert_allclose(port, ref, rtol=tol, err_msg=k)


def test_trainer_state_matches_the_reference(three_steps):
    """After three steps: both AdamW moments agree per leaf to 5e-5 of
    the leaf's largest entry (measured ~1e-5: the gradients' fp32
    rounding).  The parameters agree to 1e-4 absolute: AdamW divides
    each step by sqrt(v), so an element whose gradient is of the order
    of fp32 rounding moves by up to lr (3e-4) in either run — measured
    3.1e-5 at most (embedding rows), with all but a few in 10^4
    elements within 1e-6."""
    _, jtr, tr = three_steps
    model = tr.model
    names = [n for n, _ in model.named_parameters()]
    ref_p = _by_name(jtr.params, model)
    for name, p in zip(names, tr.params):
        d = (p.detach() - ref_p[name]).abs()
        assert float(d.max()) <= 1e-4, name
        assert float((d > 1e-6).float().mean()) <= 1e-3, name
    for key in ("m", "v"):
        ref = _by_name(jtr.opt_state[key], model)
        for name, mine in zip(names, tr.opt_state[key]):
            scale = float(ref[name].abs().max())
            assert float((mine - ref[name]).abs().max()) <= 5e-5 * scale, \
                (key, name)


# ------------------------------------------------------------- refusals
@pytest.mark.parametrize("field,value", [
    ("packing", True), ("ckpt_dir", "/nonexistent"),
    ("dropout_deterministic", False), ("loss_scale", "dynamic"),
    ("pp_schedule", "1f1b")])
def test_training_config_refuses_options_of_later_slices(field, value):
    with pytest.raises(NotImplementedError, match="arrives with"):
        TrainingConfig(**{field: value})


@pytest.mark.parametrize("field,value", [
    ("pp_schedule", "zigzag"), ("loss_scale", "sometimes"), ("seed", 1)])
def test_training_config_rejects_bad_values(field, value):
    with pytest.raises(ValueError):
        TrainingConfig(**{field: value})


@pytest.mark.parametrize("field,value,exc", [
    ("attention_dropout", 0.1, NotImplementedError),
    ("hidden_dropout", 0.1, NotImplementedError),
    ("remat_policy", "dots", NotImplementedError),
    ("remat_policy", "dots_attn", NotImplementedError),
    ("remat_policy", "offload", NotImplementedError),
    ("remat_policy", "everything", ValueError)])
def test_llama_config_refuses_options_of_later_slices(field, value, exc):
    with pytest.raises(exc):
        LlamaConfig.tiny(**{field: value})


@pytest.mark.parametrize("arg", ["strategy", "mesh", "run_log", "health",
                                 "numerics"])
def test_trainer_refuses_arguments_of_later_slices(arg):
    model = LlamaLMHeadModel(LlamaConfig.tiny(), device="cpu")
    with pytest.raises(NotImplementedError, match="arrives with"):
        Trainer(model, TrainingConfig(), device="cpu", **{arg: object()})
    with pytest.raises(TypeError):
        Trainer(model, TrainingConfig(), device="cpu", bogus=1)


def test_trainer_refuses_fp16_compute_without_the_grad_scaler():
    model = LlamaLMHeadModel(LlamaConfig.tiny(compute_dtype=torch.float16),
                             device="cpu")
    with pytest.raises(NotImplementedError, match="GradScaler"):
        Trainer(model, TrainingConfig(), device="cpu")


def test_trainer_refuses_parameters_stored_below_fp32():
    model = LlamaLMHeadModel(LlamaConfig.tiny(param_dtype=torch.bfloat16),
                             device="cpu")
    with pytest.raises(NotImplementedError, match="param_dtype"):
        Trainer(model, TrainingConfig(), device="cpu")


def test_default_device_trainer_raises_without_a_card(monkeypatch):
    model = LlamaLMHeadModel(LlamaConfig.tiny(), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(model, TrainingConfig())
    with pytest.raises(ValueError):
        Trainer(model, TrainingConfig(), device="meta")


def test_default_device_adamw_raises_without_a_card(monkeypatch):
    """AdamW runs where it was asked to: "cuda" by default, which
    raises here rather than quietly running the plain version."""
    p, g = torch.zeros(4), torch.ones(4)
    opt = toptim.AdamW(lr=1e-2)
    state = opt.init([p])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        opt.update([g], state, [p])
    assert torch.equal(p, torch.zeros(4)) and state["step"] == 0
    toptim.AdamW(lr=1e-2, device="cpu").update([g], state, [p])
    assert state["step"] == 1 and bool((p < 0).all())


def test_trainer_loop_counts_steps_and_tokens():
    """`train` runs the steps, syncs on log boundaries only, and writes
    the trainer.* series; the loss falls on a repeated batch."""
    model = LlamaLMHeadModel(LlamaConfig.tiny(compute_dtype=torch.float32),
                             device="cpu", seed=1)
    tr = Trainer(model, TrainingConfig(**dict(_TRAIN, lr=1e-2,
                                              log_every=2)), device="cpu")
    ids, labels = _batch(256, 40, b=4)
    batch = {"input_ids": ids, "labels": labels}
    first = float(tr.train_step(batch)["loss"])
    last = tr.train([batch] * 10, num_steps=4)
    assert tr.global_step == 5
    assert float(last["loss"]) < first
    reg = tr.registry
    assert reg.counter_value("trainer.steps") == 4
    assert reg.counter_value("trainer.tokens") == 4 * ids.size
    assert reg.histogram("trainer.step_time_s").count == 4
    with pytest.raises(ValueError):
        tr.train_step({"input_ids": ids[:3], "labels": labels[:3]})
