"""fp16 parameters in the PyTorch port against the JAX reference, on the
CPU: AdamW's fp16 arm, the `Trainer` and `SFTTrainer` over fp16 leaves,
their checkpoints, and LoRA merged into an fp16 base.

What is held against what, on inputs drawn from seeds with numpy:

  * the fp16 arm's plain version (the yardstick its CUDA kernel is held
    to on the card) against the Pallas `adam_update` in interpret mode,
    fp16 p with fp32 g, m and v, over two steps: p within one fp16 ulp
    (both round the same fp32 value once, to nearest even), m and v at
    the reference's 1-ulp fp32 bound; a p pushed past 65,504 is inf on
    both sides;
  * a 2-layer Llama with Llama-2's geometry (MHA, head dim 128) whose
    parameters and compute are fp16, against the reference `Trainer`
    (`param_dtype=jnp.float16`) from the same weights, `loss_scale=
    "auto"`, the numerics flag on at both sides, 4 steps, the first a
    batch of one token everywhere whose fp16 weight gradients overflow:
    the skips and the scale's course equal; losses within 1e-4 and grad
    norms within 1e-3 relative (phase 15's fp16-compute limits); every
    parameter within the AdamW-direction bound a step plus one fp16 ulp
    a step (each side's store rounds once); the moments within 2^-4 of
    each leaf's largest entry; the "params" and "grads" numerics scopes
    within 1e-3 relative (fp32 reductions of fp16 leaves);
  * a resume with fp16 leaves bit for bit; a bf16-parameter checkpoint
    resumed into an fp16 run casts the leaves as the reference's orbax
    restore does (compared bit for bit with it);
  * LoRA SFT on an fp16 base (fp32 adapters) against the reference
    `SFTTrainer`, 3 steps; the merge into an fp16 base against the
    reference's, each of its two fp16 roundings (the delta's, the sum's)
    within one ulp; the merged weights loaded into a fresh fp16
    model give the reference model's logits on its merged params within
    2^-7 of the largest logit (the fp16-compute model tolerance of
    tests/test_torch_fp16.py);
  * the fused norm's launch plan at Llama-2-13B's hidden 5120 in fp16.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hetu_tpu.engine import SFTTrainer as JSFTTrainer
from hetu_tpu.engine import Trainer as JTrainer
from hetu_tpu.engine import TrainingConfig as JTrainingConfig
from hetu_tpu.models.llama import LlamaConfig as JLlamaConfig
from hetu_tpu.models.llama import LlamaLMHeadModel as JLlamaLMHeadModel
from hetu_tpu.ops.pallas import adam as jadam
from hetu_tpu.peft import LoRAConfig as JLoRAConfig
from hetu_tpu.peft import LoRAWrappedModel as JLoRAWrappedModel
from hetu_tpu.peft import merge_lora_params as jmerge
from hetu_tpu.utils.checkpoint import CheckpointManager as JCheckpointManager
from hetu_tpu_torch.engine import SFTTrainer, Trainer, TrainingConfig
from hetu_tpu_torch.engine import mask_prompt_labels
from hetu_tpu_torch.models.from_jax import load_jax_lora
from hetu_tpu_torch.models.llama import (LlamaConfig, LlamaLMHeadModel,
                                         load_jax_params)
from hetu_tpu_torch.ops.cuda import adam as tadam
from hetu_tpu_torch.ops.cuda import fused_norm as tfused_norm
from hetu_tpu_torch.peft import LoRAConfig, merge_lora_params
from test_torch_fp16 import _f16_ulp
from test_torch_train3 import _np
from torch_adam import adam_direction

#: Llama-2's geometry at test widths: MHA, heads of 128
MHA128 = dict(hidden_size=256, num_attention_heads=2, num_key_value_heads=2)
_TRAIN = dict(global_batch_size=4, micro_batch_size=2, seq_len=16,
              warmup_steps=1, total_steps=10, log_every=100, lr=1e-3)
_F16 = dict(num_hidden_layers=2, **MHA128)


def _configs(**kw):
    """(JAX config, port config): fp16 parameters and compute, the dense
    attention."""
    return (JLlamaConfig.tiny(param_dtype=jnp.float16,
                              compute_dtype=jnp.float16,
                              use_flash_attention=False, **_F16, **kw),
            LlamaConfig.tiny(param_dtype=torch.float16,
                             compute_dtype=torch.float16, **_F16, **kw))


def _by_name(tree, like):
    """The reference's tree as {port parameter name: fp32 tensor},
    through the loader's mapping into an fp32 model (fp16 parameters and
    fp32 moments exactly)."""
    scratch = LlamaLMHeadModel(dataclasses.replace(
        like.config, param_dtype=torch.float32), device="cpu")
    load_jax_params(scratch, _np(tree))
    return {n: p.float() for n, p in scratch.named_parameters()}


def _batch(seed, vocab=256):
    ids = np.random.default_rng(seed).integers(1, vocab, (4, 16)).astype(
        np.int32)
    labels = ids.copy()
    labels[0, 3:7] = -100
    return {"input_ids": ids, "labels": labels}


def _one_token_batch(token=7):
    """One token everywhere: every position adds the same outer product
    to the head's row of that token, a coherent sum that passes fp16's
    65,504 in the fp16 weight gradient under the scale."""
    ids = np.full((4, 16), token, np.int32)
    return {"input_ids": ids, "labels": ids.copy()}


# ---------------------------------------------------------------- AdamW
def test_adam_fp16_arm_matches_pallas_over_two_steps():
    """fp16 p, fp32 g, m, v: two steps of the plain version against the
    Pallas kernel (interpret mode) at the reference's 1-ulp bound; then
    an update that carries p past 65,504 makes it inf on both sides."""
    b1, b2, eps, wd, lr = 0.9, 0.95, 1e-8, 0.01, 1e-2
    rng = np.random.default_rng(80)
    for shape in ((8, 128), (256,)):
        p0 = (0.5 * rng.standard_normal(shape)).astype(np.float16)
        g = (0.1 * rng.standard_normal(shape)).astype(np.float32)
        jp, jm, jv = (jnp.asarray(p0), jnp.zeros(shape), jnp.zeros(shape))
        tp = torch.from_numpy(p0.copy())
        tm, tv = torch.zeros(shape), torch.zeros(shape)
        for step in (1, 2):
            c1 = np.float32(1.0) - np.float32(b1) ** np.float32(step)
            c2 = np.float32(1.0) - np.float32(b2) ** np.float32(step)
            jp, jm, jv = jadam.adam_update(
                jp, jnp.asarray(g), jm, jv, lr, c1, c2, b1=b1, b2=b2,
                eps=eps, weight_decay=wd)
            tadam.adam_update(tp, torch.from_numpy(g), tm, tv, lr, c1, c2,
                              b1=b1, b2=b2, eps=eps, weight_decay=wd,
                              device="cpu")
        assert tp.dtype == torch.float16 and jp.dtype == jnp.float16
        ref = torch.from_numpy(np.asarray(jp, np.float32))
        err = (tp.float() - ref).abs()
        assert bool((err <= _f16_ulp(torch.maximum(
            tp.float().abs(), ref.abs()))).all()), float(err.max())
        for a, b in ((tm, jm), (tv, jv)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=3e-7,
                                       atol=1e-8)
    # past fp16's largest finite value: inf, as astype(float16)
    p0 = np.full((128,), 65504.0, np.float16)
    g = np.full((128,), -1.0, np.float32)
    jp, _, _ = jadam.adam_update(jnp.asarray(p0), jnp.asarray(g),
                                 jnp.zeros(128), jnp.zeros(128), 64.0,
                                 np.float32(0.1), np.float32(0.05), b1=b1,
                                 b2=b2, eps=eps, weight_decay=0.0)
    tp = torch.from_numpy(p0.copy())
    tadam.adam_update(tp, torch.from_numpy(g), torch.zeros(128),
                      torch.zeros(128), 64.0, 0.1, 0.05, b1=b1, b2=b2,
                      eps=eps, weight_decay=0.0, device="cpu")
    assert bool(torch.isinf(tp).all()) and bool(np.isinf(np.asarray(jp)).all())


def test_adam_refuses_an_fp16_gradient():
    """g, m and v stay fp32 under an fp16 p (the accumulators')."""
    p = torch.zeros(8, dtype=torch.float16)
    with pytest.raises(ValueError, match="fp32/bf16/fp16 p and fp32"):
        tadam.adam_update(p, torch.zeros(8, dtype=torch.float16),
                          torch.zeros(8), torch.zeros(8), 1e-3, 0.1, 0.05,
                          b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.0,
                          device="cpu")


# -------------------------------------------------------------- Trainer
def _trainers(monkeypatch, **train):
    """The reference Trainer and the port's, fp16 parameters and compute,
    the numerics flag on at both sides, from the reference's init."""
    monkeypatch.setenv("HETU_TPU_NUMERICS", "1")
    monkeypatch.setenv("HETU_TORCH_NUMERICS", "1")
    jcfg, tcfg = _configs()
    cfg = dict(_TRAIN, **train)
    jtr = JTrainer(JLlamaLMHeadModel(jcfg), JTrainingConfig(**cfg))
    tr = Trainer(LlamaLMHeadModel(tcfg, device="cpu"),
                 TrainingConfig(**cfg), device="cpu")
    jtr.build()
    load_jax_params(tr.model, _np(jtr.params))
    return jtr, tr.build()


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def test_fp16_parameter_steps_match_the_reference(monkeypatch):
    """Four steps with fp16 parameters and compute, the first one of
    `_one_token_batch` (its fp16 weight gradient overflows at the
    initial scale 2^16 on both sides): that step is skipped (p, m, v
    and AdamW's count kept), the scale halves; the skips and scales of
    every step equal the reference's.  The overflow comes first because
    that batch's loss is one position's loss repeated: after an update
    the ulp the two sides' fp16 parameters may round apart moves it
    coherently (2.9e-4 relative after two updates), where a seeded
    batch's positions average it out.  Losses within 1e-4, finite grad
    norms within 1e-3 relative; each parameter within sum over the
    applied steps of lr |u - u_ref| (+ 2^-21 |u| each, the directions'
    own recompute) + one fp16 ulp at the larger of the two values (each
    side rounds its fp32 update once); moments within 2^-4 of the leaf's
    largest entry (fp16 activations round every gradient term at
    2^-11); the "params" numerics scope within 1e-3 relative each step,
    "grads" on the finite steps (fp32 sums of squares over the same
    fp16 values, taken in other orders)."""
    jtr, tr = _trainers(monkeypatch)
    assert all(p.dtype == torch.float16 for p in tr.params)
    assert all(a.dtype == torch.float32 for a in tr._accum)
    assert tr._scaler is not None and jtr._scaler is not None
    opt = tr.optimizer
    bound = {n: torch.zeros(p.shape) for n, p in zip(tr.names, tr.params)}
    seq, ref_seq = [], []
    for step in range(1, 5):
        batch = _one_token_batch() if step == 1 else _batch(90 + step)
        before = [p.detach().clone() for p in tr.params]
        jm, tm = jtr.train_step(batch), tr.train_step(batch)
        tr.settle()
        seq.append((float(tm["amp_skipped"]), float(tm["loss_scale"])))
        ref_seq.append((float(jm["amp_skipped"]), float(jm["loss_scale"])))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-4, err_msg=f"step {step} loss")
        skipped = seq[-1][0] == 1.0
        if skipped:
            assert all(torch.equal(a, b.detach())
                       for a, b in zip(before, tr.params))
            assert np.isnan(float(tm["grad_norm"]))
        else:
            np.testing.assert_allclose(
                float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-3,
                err_msg=f"step {step} grad_norm")
        for scope in ("params",) + (() if skipped else ("grads",)):
            for k in ("absmax", "rms", "l2"):
                mine = float(tm["numerics"][scope][k])
                theirs = float(jm["numerics"][scope][k])
                assert _rel(mine, theirs) <= 1e-3, (step, scope, k)
            assert float(tm["numerics"][scope]["nonfinite"]) == float(
                jm["numerics"][scope]["nonfinite"]) == 0
        if skipped:
            continue
        n = tr.opt_state["step"]
        ref_p = _by_name(jtr.params, tr.model)
        ref_m = _by_name(jtr.opt_state["m"], tr.model)
        ref_v = _by_name(jtr.opt_state["v"], tr.model)
        for name, p, m, v in zip(tr.names, tr.params, tr.opt_state["m"],
                                 tr.opt_state["v"]):
            u = adam_direction(m, v, n, opt)
            u_ref = adam_direction(ref_m[name], ref_v[name], n, opt)
            bound[name] += opt._lr(n) * ((u - u_ref).abs() + 2.0 ** -21 * (
                u.abs() + u_ref.abs())) + _f16_ulp(torch.maximum(
                    p.detach().float().abs(), ref_p[name].abs()))
    assert seq == ref_seq
    assert seq[0] == (1.0, 2.0 ** 15), seq
    assert [s for s, _ in seq] == [1.0, 0.0, 0.0, 0.0]
    assert tr.opt_state["step"] == int(jtr.opt_state["step"]) == 3
    ref = _by_name(jtr.params, tr.model)
    for name, p in zip(tr.names, tr.params):
        assert p.dtype == torch.float16
        d = (p.detach().float() - ref[name]).abs()
        assert bool((d <= bound[name]).all()), \
            (name, float((d / bound[name]).max()))
    for key in ("m", "v"):
        theirs = _by_name(jtr.opt_state[key], tr.model)
        for name, m in zip(tr.names, tr.opt_state[key]):
            scale = float(theirs[name].abs().max())
            assert float((m - theirs[name]).abs().max()) <= \
                2 ** -4 * scale, (key, name)


def test_fp16_resume_is_bit_for_bit(tmp_path):
    """Four steps straight, against two steps, a save, and a new trainer
    restoring it and taking the last two: fp16 parameters, fp32 moments,
    the scaler and every metric equal bit for bit."""
    _, tcfg = _configs()
    cfg = TrainingConfig(**_TRAIN, ckpt_dir=str(tmp_path))
    batches = [_batch(120 + i) for i in range(4)]

    def trainer():
        return Trainer(LlamaLMHeadModel(tcfg, device="cpu", seed=4), cfg,
                       device="cpu").build()
    straight = trainer()
    ref = [{k: float(v) for k, v in straight.train_step(b).items()}
           for b in batches]
    first = trainer()
    for b in batches[:2]:
        first.train_step(b)
    first.save(wait=True)
    resumed = trainer()
    resumed.restore()
    assert resumed.global_step == 2 and resumed.opt_state["step"] == 2
    got = [{k: float(v) for k, v in resumed.train_step(b).items()}
           for b in batches[2:]]
    assert got == ref[2:]
    a, b = straight.state(), resumed.state()
    for name in straight.names:
        assert a["params"][name].dtype == torch.float16
        assert torch.equal(a["params"][name], b["params"][name]), name
        for k in ("m", "v"):
            assert torch.equal(a["opt_state"][k][name],
                               b["opt_state"][k][name]), (k, name)
    for k in ("scale", "growth_tracker"):
        assert torch.equal(a["scaler"][k], b["scaler"][k])


def test_bf16_parameter_checkpoint_resumes_into_fp16_run(tmp_path):
    """A bf16-parameter run (no scaler) checkpointed, resumed by an
    fp16-parameter run (scaler on): the restore retries with the scaler
    toggled, the leaves arrive cast to fp16 — the bits the reference's
    orbax restore gives for the same bf16 values into fp16 targets —,
    the moments as saved, the scaler fresh, and the next step is
    finite."""
    base = dict(num_hidden_layers=1, **MHA128)
    cfg = TrainingConfig(**_TRAIN, ckpt_dir=str(tmp_path / "port"))
    tr_b = Trainer(LlamaLMHeadModel(LlamaConfig.tiny(
        param_dtype=torch.bfloat16, **base), device="cpu", seed=5), cfg,
        device="cpu").build()
    assert tr_b._scaler is None
    tr_b.train_step(_batch(130))
    tr_b.save(wait=True)
    saved = {n: p.detach().clone() for n, p in zip(tr_b.names, tr_b.params)}
    tr_f = Trainer(LlamaLMHeadModel(LlamaConfig.tiny(
        param_dtype=torch.float16, compute_dtype=torch.float16, **base),
        device="cpu", seed=6), cfg, device="cpu").build()
    tr_f.restore()
    assert tr_f.global_step == 1 and tr_f.opt_state["step"] == 1
    assert float(tr_f.scaler_state["scale"]) == 2.0 ** 16
    # the reference's checkpoint manager on the same bf16 values
    jmgr = JCheckpointManager(str(tmp_path / "ref"))
    jmgr.save(1, {n: jnp.asarray(t.float().numpy(), jnp.bfloat16)
                  for n, t in saved.items()}, wait=True)
    jout = jmgr.restore(1, target={n: jnp.zeros(t.shape, jnp.float16)
                                   for n, t in saved.items()})
    for name, p in zip(tr_f.names, tr_f.params):
        assert p.dtype == torch.float16
        want = torch.from_numpy(np.array(jout[name]).view(np.int16))
        assert torch.equal(p.detach().view(torch.int16), want), name
    for i, name in enumerate(tr_b.names):
        assert torch.equal(tr_f.opt_state["m"][i], tr_b.opt_state["m"][i])
    assert np.isfinite(float(tr_f.train_step(_batch(131))["loss"]))


# ------------------------------------------------------------------ LoRA
def _sft_batches(n=3, seed=140):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(1, 256, (4, 16)).astype(np.int32)
        ids[1, 12:] = 0
        out.append({"input_ids": ids,
                    "labels": mask_prompt_labels(ids, rng.integers(3, 8, 4))})
    return out


def test_lora_sft_on_an_fp16_base_matches_the_reference():
    """LoRA SFT (rank 4, every reference target) on a frozen fp16 base
    with fp16 compute, from the reference's base and adapters, 3 steps,
    `loss_scale="dynamic"` at both sides (under "auto" the reference's
    SFTTrainer reads the compute dtype from its LoRA wrapper, which has
    no config, and leaves the scale off; the port's wrapper carries the
    base's config and turns it on, ROADMAP Queue C): its scale and
    skips equal; losses
    within 1e-4 and grad norms within 1e-3 relative; every fp32 adapter
    element within the AdamW-direction bound (+ 2^-21 of |p| a step, the
    fp32 store); moments within 2^-4 of the leaf's largest entry; the
    base bit for bit, without a gradient, fp16; AdamW on its fp32 arm."""
    jcfg, tcfg = _configs()
    jmodel = JLlamaLMHeadModel(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    model = LlamaLMHeadModel(tcfg, device="cpu")
    load_jax_params(model, _np(jparams))
    base = {n: p.detach().clone() for n, p in model.named_parameters()}
    train = dict(_TRAIN, loss_scale="dynamic")
    jtr = JSFTTrainer(jmodel, JTrainingConfig(**train),
                      lora=JLoRAConfig(rank=4), base_params=jparams)
    jtr.build()
    tr = SFTTrainer(model, TrainingConfig(**train), lora=LoRAConfig(rank=4),
                    device="cpu")
    assert SFTTrainer(model, TrainingConfig(**_TRAIN),
                      lora=LoRAConfig(rank=4), device="cpu")._scaler \
        is not None
    carried = load_jax_lora(model, _np(jtr.params))
    with torch.no_grad():
        for name, ab in tr.model.lora_params.items():
            for f in "AB":
                ab[f].copy_(carried[name][f])
    tr.build()
    assert tr._scaler is not None and jtr._scaler is not None
    assert all(p.dtype == torch.float32 for p in tr.params)
    opt = tr.optimizer
    bound = [torch.zeros(p.shape) for p in tr.params]
    for step, batch in enumerate(_sft_batches(), 1):
        jm, tm = jtr.train_step(batch), tr.train_step(batch)
        for k in ("loss_scale", "amp_skipped"):
            assert float(tm[k]) == float(jm[k]) , (step, k)
        assert float(tm["amp_skipped"]) == 0.0
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-3)
        ref = load_jax_lora(model, _np(jtr.params))
        ref_m = load_jax_lora(model, _np(jtr.opt_state["m"]))
        ref_v = load_jax_lora(model, _np(jtr.opt_state["v"]))
        for i, (name, p, m, v) in enumerate(zip(
                tr.names, tr.params, tr.opt_state["m"], tr.opt_state["v"])):
            w, f = name[len("lora."):].rsplit("/", 1)
            key = next(n for n in ref if n.replace(".", "/") == w)
            u = adam_direction(m, v, step, opt)
            u_ref = adam_direction(ref_m[key][f], ref_v[key][f], step, opt)
            bound[i] += opt._lr(step) * ((u - u_ref).abs() + 2.0 ** -21 * (
                u.abs() + u_ref.abs())) + 2.0 ** -21 * torch.maximum(
                    p.detach().abs(), ref[key][f].abs())
    ref = {k: load_jax_lora(model, _np(t)) for k, t in (
        ("p", jtr.params), ("m", jtr.opt_state["m"]),
        ("v", jtr.opt_state["v"]))}
    for i, name in enumerate(tr.names):
        w, f = name[len("lora."):].rsplit("/", 1)
        key = next(n for n in ref["p"] if n.replace(".", "/") == w)
        d = (tr.params[i].detach() - ref["p"][key][f]).abs()
        assert bool((d <= bound[i]).all()), name
        for k, mine in (("m", tr.opt_state["m"][i]),
                        ("v", tr.opt_state["v"][i])):
            scale = float(ref[k][key][f].abs().max())
            assert float((mine - ref[k][key][f]).abs().max()) <= \
                2.0 ** -4 * scale, (k, name)
    for name, p in model.named_parameters():
        assert p.dtype == torch.float16 and p.grad is None
        assert torch.equal(p.detach(), base[name]), name


@pytest.fixture(scope="module")
def merged_pair():
    """The reference's fp16 base and adapters (B drawn non-zero), merged
    on both sides: (port merge, reference merge, reference model, port
    model holding the base, the adapters)."""
    jcfg, tcfg = _configs()
    jmodel = JLlamaLMHeadModel(jcfg)
    jparams = jmodel.init(jax.random.key(1))
    jlora = JLoRAWrappedModel(jmodel, jparams, JLoRAConfig(rank=4)).init(
        jax.random.key(2))
    jlora = jax.tree_util.tree_map(
        lambda a: a + 0.05 * jax.random.normal(jax.random.key(3), a.shape),
        jlora)
    model = LlamaLMHeadModel(tcfg, device="cpu")
    load_jax_params(model, _np(jparams))
    lora = load_jax_lora(model, _np(jlora))
    port = merge_lora_params(model, lora, LoRAConfig(rank=4))
    ref = jax.jit(lambda p, a: jmerge(p, a, JLoRAConfig(rank=4)))(
        jparams, jlora)
    return port, ref, jmodel, model, lora


def test_merge_into_an_fp16_base_matches_the_reference(merged_pair):
    """The targets merged in fp16 as the reference merges them: the
    fp32 delta (A @ B) * scale rounded to fp16, then the fp16 add,
    rounded again.  The two sides' fp32 products may differ in their
    last bits and round to neighbouring fp16 deltas, and the sums of
    neighbouring deltas round on their own, so each element is held to
    one fp16 ulp at each rounding: |W_eff - W_eff_ref| <= ulp(delta) +
    ulp(W_eff) (measured: 2 of 90,112 elements of one matrix past one
    ulp of W_eff, one in a cancelling sum, 8 of its ulps and one of the
    delta's); every element of most matrices equal.  The rest bit for
    bit; the base model is left as it was."""
    port, ref, _, model, lora = merged_pair
    theirs = _by_name(ref, model)
    cfg = LoRAConfig(rank=4)
    for name, w in model.named_parameters():
        mine = port[name]
        assert mine.dtype == w.dtype == torch.float16
        if name in lora:
            delta = (lora[name]["A"] @ lora[name]["B"]).reshape(
                w.shape) * cfg.scale
            err = (mine.float() - theirs[name]).abs()
            ulps = _f16_ulp(delta.abs()) + _f16_ulp(torch.maximum(
                mine.float().abs(), theirs[name].abs()))
            assert bool((err <= ulps).all()), name
            assert not torch.equal(mine, w.detach()), name
        else:
            assert torch.equal(mine.float(), theirs[name]), name


def test_merged_fp16_model_logits_match_the_reference(merged_pair):
    """The merged weights loaded into a fresh fp16 model
    (`load_state_dict`) give the logits of the reference model on its
    merged params within 2^-7 of the largest logit."""
    port, ref, jmodel, model, _ = merged_pair
    fresh = LlamaLMHeadModel(model.config, device="cpu", seed=9)
    fresh.load_state_dict({n: w.detach() for n, w in port.items()})
    ids = np.random.default_rng(150).integers(1, 256, (2, 16)).astype(
        np.int32)
    want = np.asarray(jmodel(ref, jnp.asarray(ids)), np.float32)
    with torch.no_grad():
        got = fresh(torch.from_numpy(ids))
    assert got.dtype == torch.float16 and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2.0 ** -7 * np.abs(want).max())


# ---------------------------------------------------- Llama-2-13B widths
def test_norm_launch_plan_at_llama2_13b_hidden():
    """Hidden 5120 in fp16 (640 16-byte chunks a row): the widest
    instantiation, two chunks a thread, 320 threads a row; within the
    kernel's 512-thread blocks, forward and backward, the vector arm on
    aligned operands and the scalar arm a value off 16 bytes."""
    rows, sms = 2 * 2048, 132
    for backward in (False, True):
        plan = tfused_norm.launch_plan(5120, torch.float16, rows,
                                       [0, 256, 512], backward=backward,
                                       sms=sms)
        assert (plan.vpt, plan.threads) == (2, 320)
        assert plan.threads * plan.vpt * 8 >= 5120
        assert plan.threads * plan.block_rows <= tfused_norm.MAX_THREADS
        assert not plan.scalar and plan.grid >= 1
        assert tfused_norm.launch_plan(5120, torch.float16, rows, [2],
                                       backward=backward, sms=sms).scalar
