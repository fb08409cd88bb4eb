"""fp16 compute and packed batches in the PyTorch port against the JAX
reference, on the CPU.

What is held against what:

  * the dtype policy (`core/dtypes.py`): the default, the models'
    configs' policies and the cast against the reference's;
  * each fp16 arm's plain version (the yardstick its CUDA kernel is held
    to on the card) against the reference's Pallas kernel in fp16
    (interpret mode), on the same seeded values: SwiGLU, RoPE, the fused
    RMS and LayerNorm, forward and backward; every output the two round
    once to fp16 from fp32 values that differ only in fp32 summation
    order, so they agree within one fp16 ulp (the norms' outputs + 1e-6,
    where centred sums cancel; dw and db, fp32 row sums, 1e-5 of their
    largest entry); flash attention's o within one fp16 ulp, lse 1e-5,
    and its fp32 gradients (`_bwd`) 1e-4 of their largest entry, the
    fp16 gradients of the Function one fp16 ulp beyond that;
  * a 2-layer Llama and a 2-layer GPT computing in fp16 over fp32
    parameters: the logits of a packed batch, and three `Trainer` steps
    on packed batches (one micro-batch of padding alone, no tokens)
    with `loss_scale="auto"` on both sides: the scale and the skip flag
    equal each step, loss 1e-4 and grad norm 1e-3 relative (fp16
    activations, each rounding a product in its own order: measured
    2.2e-5 and 3.4e-4), parameters within what the AdamW directions of
    the two sides' moments differ by, and the moments to 2^-4 of each
    leaf's largest entry (measured 1.2%);
  * the reference's AMP cases (tests/test_amp.py): the scaler on under
    "auto" for fp16 only, an overflowing scale skipping the step and
    halving until an update lands — the sequence of skips and scales
    equal to the reference's —, growth on a finite streak, a bf16
    checkpoint resumed into an fp16 trainer;
  * packed against alone: each sequence's loss and token count inside a
    packed row equal the same sequence alone in a padded row, on both
    sides, and the two sides agree.
"""
from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from hetu_tpu.core import dtypes as jdtypes
from hetu_tpu.engine import Trainer as JTrainer
from hetu_tpu.engine import TrainingConfig as JTrainingConfig
from hetu_tpu.models.gpt import GPTConfig as JGPTConfig
from hetu_tpu.models.gpt import GPTLMHeadModel as JGPTLMHeadModel
from hetu_tpu.models.llama import LlamaConfig as JLlamaConfig
from hetu_tpu.models.llama import LlamaLMHeadModel as JLlamaLMHeadModel
from hetu_tpu.ops.pallas import flash_attention as jflash
from hetu_tpu.ops.pallas import fused_norm as jfused_norm
from hetu_tpu.ops.pallas import rotary as jrotary
from hetu_tpu.ops.pallas import swiglu as jswiglu
from hetu_tpu.optim.grad_scaler import GradScaler as JGradScaler
from hetu_tpu_torch.core import dtypes as tdtypes
from hetu_tpu_torch.data import pack_sequences, pad_batch
from hetu_tpu_torch.engine import Trainer, TrainingConfig
from hetu_tpu_torch.models.gpt import GPTConfig, GPTLMHeadModel
from hetu_tpu_torch.models.llama import (LlamaConfig, LlamaLMHeadModel,
                                         load_jax_params)
from hetu_tpu_torch.ops.cuda import flash_attention as tflash
from hetu_tpu_torch.ops.cuda import fused_norm as tfused_norm
from hetu_tpu_torch.ops.cuda import rotary as trotary
from hetu_tpu_torch.ops.cuda import swiglu as tswiglu
from hetu_tpu_torch.optim.grad_scaler import GradScaler
from test_torch_parity import HD128
from test_torch_train3 import HD64, _by_name, _np
from torch_adam import adam_direction

FAMILIES = ("llama", "gpt")
_TRAIN = dict(global_batch_size=4, micro_batch_size=2, seq_len=32,
              warmup_steps=1, total_steps=10, log_every=100, lr=1e-3)


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _f16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One fp16 ulp at each element of x (11 significant bits; 2^-24 in
    the subnormal range)."""
    _, exp = torch.frexp(x)
    return torch.maximum(torch.ldexp(torch.ones_like(x), exp - 11),
                         torch.full_like(x, 2.0 ** -24))


def _f16_close(a: torch.Tensor, b, atol: float = 0.0):
    """Within one fp16 ulp of the larger of the two, plus `atol`."""
    a = a.detach().float()
    b = torch.from_numpy(np.asarray(b, np.float32))
    ulp = _f16_ulp(torch.maximum(a.abs(), b.abs()))
    err = (a - b).abs()
    assert bool((err <= ulp + atol).all()), \
        f"max diff {err.max().item()}, worst excess " \
        f"{(err - ulp - atol).max().item()}"


def _t(a, dtype=torch.float16):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


# -------------------------------------------------------- dtype policy
def test_dtype_policy_matches_the_reference():
    """The default policy, the models' configs' policies and the cast
    to the compute dtype, against the reference's."""
    def name(d):
        return str(d).replace("torch.", "")
    for field in ("param_dtype", "compute_dtype", "reduce_dtype"):
        assert name(getattr(tdtypes.DEFAULT_POLICY, field)) == \
            np.dtype(getattr(jdtypes.DEFAULT_POLICY, field)).name
    for cfg in (LlamaConfig.tiny(), GPTConfig(),
                LlamaConfig.tiny(param_dtype=torch.bfloat16,
                                 compute_dtype=torch.float16)):
        assert cfg.policy == tdtypes.DTypePolicy(cfg.param_dtype,
                                                 cfg.compute_dtype)
    assert LlamaConfig.tiny().policy == tdtypes.DEFAULT_POLICY
    policy = tdtypes.DTypePolicy(compute_dtype=torch.float16)
    jpolicy = jdtypes.DTypePolicy(compute_dtype=jnp.float16)
    x = _rand((3, 5), 0)
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        got = policy.cast_to_compute(torch.from_numpy(x).to(dtype))
        want = jpolicy.cast_to_compute(jnp.asarray(x, jdtype))
        assert got.dtype == torch.float16
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))
    ids = torch.arange(4)
    assert policy.cast_to_compute(ids) is ids


# ----------------------------------------------------- the fp16 arms
def test_swiglu_fp16_matches_the_pallas_kernel():
    """Forward and the custom VJP's backward of the Pallas kernel in
    fp16, against the plain versions (silu(g) u and the explicit
    gradient in fp32, each output rounded once)."""
    g, u, dy = (_rand((16, 384), s) for s in (1, 2, 3))
    f = lambda a: jnp.asarray(a, jnp.float16)
    ref, vjp = jax.vjp(jswiglu.fused_swiglu, f(g), f(u))
    jdg, jdu = vjp(f(dy))
    gu = torch.stack([_t(g), _t(u)], dim=-2).requires_grad_(True)
    out = tswiglu.fused_swiglu(gu, device="cpu")
    out.backward(_t(dy))
    assert out.dtype == gu.grad.dtype == torch.float16
    _f16_close(out, ref)
    _f16_close(gu.grad[:, 0], jdg)
    _f16_close(gu.grad[:, 1], jdu)


def test_rotary_fp16_matches_the_pallas_kernel():
    """q and k rotated at per-token positions that restart (a packed
    row), and their cotangents by the VJP, in fp16."""
    b, s, hq, hk, hd = 2, 24, 4, 2, 128
    pos = np.concatenate([np.arange(10), np.arange(14)])[None].repeat(b, 0)
    from hetu_tpu import ops as jops
    cos, sin = jops.build_rope_cache(64, hd, 500000.0)
    cos_t, sin_t = np.asarray(cos)[pos], np.asarray(sin)[pos]
    q, k = _rand((b, s, hq, hd), 4), _rand((b, s, hk, hd), 5)
    dq, dk = _rand(q.shape, 6), _rand(k.shape, 7)
    f = lambda a: jnp.asarray(a, jnp.float16)
    cs = jnp.asarray(cos_t), jnp.asarray(sin_t)
    (jq, jk), vjp = jax.vjp(lambda a, c: jrotary.fused_rotary_qk(a, c, *cs),
                            f(q), f(k))
    jdq, jdk = vjp((f(dq), f(dk)))
    tq, tk = _t(q).requires_grad_(True), _t(k).requires_grad_(True)
    oq, ok = trotary.fused_rotary_qk(tq, tk, torch.from_numpy(cos_t),
                                     torch.from_numpy(sin_t), device="cpu")
    torch.autograd.backward((oq, ok), (_t(dq), _t(dk)))
    for mine, ref in ((oq, jq), (ok, jk), (tq.grad, jdq), (tk.grad, jdk)):
        assert mine.dtype == torch.float16
        _f16_close(mine, ref)


@pytest.mark.parametrize("kind,bias", [("rms", False), ("ln", True),
                                       ("ln", False)])
def test_fused_norm_fp16_matches_the_pallas_kernel(kind, bias):
    """y, s forward and dx, dh, dw (db) from the Pallas kernel's custom
    VJP on the same cotangents, in fp16."""
    hidden = 256
    x, h = _rand((2, 8, hidden), 10), _rand((2, 8, hidden), 11)
    w = 1.0 + _rand((hidden,), 12, 0.1)
    bb = _rand((hidden,), 13, 0.1)
    dy, dr = _rand((2, 8, hidden), 14), _rand((2, 8, hidden), 15)
    f = lambda a: jnp.asarray(a, jnp.float16)
    if kind == "rms":
        jfn = lambda a, c, ww: jfused_norm.fused_residual_rmsnorm(
            a, c, ww, 1e-5)
        jargs = (f(x), f(h), jnp.asarray(w))
    else:
        jfn = lambda a, c, ww, *b_: jfused_norm.fused_residual_layernorm(
            a, c, ww, b_[0] if b_ else None, 1e-5)
        jargs = (f(x), f(h), jnp.asarray(w)) + ((jnp.asarray(bb),) if bias
                                                else ())
    (jy, js), vjp = jax.vjp(jfn, *jargs)
    jgrads = vjp((f(dy), f(dr)))
    tx, th = _t(x).requires_grad_(True), _t(h).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    tb = torch.from_numpy(bb).requires_grad_(True) if bias else None
    if kind == "rms":
        ty, ts = tfused_norm.fused_residual_rmsnorm(tx, th, tw, 1e-5,
                                                    device="cpu")
    else:
        ty, ts = tfused_norm.fused_residual_layernorm(tx, th, tw, tb, 1e-5,
                                                      device="cpu")
    torch.autograd.backward((ty, ts), (_t(dy), _t(dr)))
    for mine, ref in ((ty, jy), (ts, js), (tx.grad, jgrads[0]),
                      (th.grad, jgrads[1])):
        assert mine.dtype == torch.float16
        _f16_close(mine, ref, atol=1e-6)
    params = [tw] + ([tb] if bias else [])
    for mine, ref in zip(params, jgrads[2:]):
        ref = np.asarray(ref)
        np.testing.assert_allclose(mine.grad.numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("d,hq,hkv", [(64, 4, 4), (128, 4, 2)])
def test_flash_fp16_matches_the_pallas_kernel(d, hq, hkv):
    """o and lse of the forward, and dq, dk, dv, against the Pallas
    kernels in fp16: causal attention (MHA, and GQA) over packed rows
    (segments cut inside and on 64-row tiles, a padding tail of segment
    0), blocks of 64."""
    b, s = 2, 192
    q, k, v = (_rand((b, s, h, d), 20 + i) for i, h in enumerate(
        (hq, hkv, hkv)))
    w = _rand((b, s, hq, d), 23)
    kw = dict(block_q=64, block_k=64)
    seg = np.zeros((b, s), np.int32)
    for r, cuts in enumerate(((0, 50, 64, 130, 170), (0, 1, 100, 128))):
        for j, (lo, hi) in enumerate(zip(cuts, cuts[1:] + (s - 9,))):
            seg[r, lo:hi] = j + 1
    f = lambda a: jnp.asarray(a, jnp.float16)
    jseg = {"segment_ids": jnp.asarray(seg)}
    tseg = {"segment_ids": torch.from_numpy(seg)}
    jo, jlse = jflash.flash_attention_with_lse(f(q), f(k), f(v), **kw,
                                               **jseg)
    to, tlse = tflash.flash_attention_with_lse(_t(q), _t(k), _t(v), **kw,
                                               **tseg, device="cpu")
    assert to.dtype == torch.float16 and tlse.dtype == torch.float32
    _f16_close(to, jo)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), rtol=1e-5,
                               atol=1e-5)
    jgrads = jax.grad(
        lambda a, c, e: (jflash.flash_attention(a, c, e, **kw, **jseg)
                         .astype(jnp.float32) * w).sum(),
        argnums=(0, 1, 2))(f(q), f(k), f(v))
    leaves = [_t(a).requires_grad_(True) for a in (q, k, v)]
    (tflash.flash_attention(*leaves, **kw, **tseg, device="cpu").float()
     * torch.from_numpy(w)).sum().backward()
    for leaf, ref in zip(leaves, jgrads):
        assert leaf.grad.dtype == torch.float16
        scale = float(np.abs(np.asarray(ref, np.float32)).max())
        _f16_close(leaf.grad, ref, atol=1e-4 * scale)


# ----------------------------------------------------------- models
def _configs(family, compute=torch.float16, **kw):
    jcompute = {torch.float16: jnp.float16,
                torch.float32: jnp.float32}[compute]
    if family == "llama":
        return (JLlamaConfig.tiny(compute_dtype=jcompute, num_hidden_layers=2,
                                  use_flash_attention=False, **HD128, **kw),
                LlamaConfig.tiny(compute_dtype=compute, num_hidden_layers=2,
                                 **HD128, **kw))
    return (JGPTConfig.tiny(compute_dtype=jcompute, num_hidden_layers=2,
                            use_flash_attention=False, **HD64, **kw),
            GPTConfig.tiny(compute_dtype=compute, num_hidden_layers=2,
                           **HD64, **kw))


def _trainers(family, *, compute=torch.float16, train=None, setup=None):
    """The reference Trainer and the port's on the CPU from the same
    params (the reference's init); `setup(jtr, tr)` before either
    builds."""
    jcfg, tcfg = _configs(family, compute)
    jcls, tcls = ((JLlamaLMHeadModel, LlamaLMHeadModel) if family == "llama"
                  else (JGPTLMHeadModel, GPTLMHeadModel))
    train = dict(_TRAIN, **(train or {}))
    jtr = JTrainer(jcls(jcfg), JTrainingConfig(**train))
    tr = Trainer(tcls(tcfg, device="cpu"), TrainingConfig(**train),
                 device="cpu")
    if setup is not None:
        setup(jtr, tr)
    jtr.build()
    load_jax_params(tr.model, _np(jtr.params))
    return jtr, tr.build()


def _packed(vocab, seed, rows=4, s=32, n=8, empty_rows=0):
    """Packed rows of `n` seeded sequences (lengths 3-29), `empty_rows`
    more of padding alone."""
    rng = np.random.default_rng(seed)
    seqs = [rng.integers(1, vocab, int(m)) for m in rng.integers(3, 30, n)]
    batch = pack_sequences(seqs, s)
    return pack_sequences(seqs, s, num_packed=batch["input_ids"].shape[0]
                          + empty_rows) if empty_rows else batch


@pytest.mark.parametrize("family", FAMILIES)
def test_fp16_steps_match_the_reference(family):
    """fp16 compute over the same fp32 parameters.  The logits of a
    packed batch within 2^-7 of the largest logit (every fp16 rounding
    of the two forwards lies at 2^-11 of its value, and a 2-layer
    forward adds a few tens of them).  Then three Trainer steps on
    packed batches (the last with a micro-batch of padding alone: no
    tokens), `loss_scale="auto"`: the scaler on at both sides, the
    scale and skip flag equal each step; loss to 1e-4 and grad norm to
    1e-3 relative; every parameter within what the two sides' AdamW
    directions differ by, sum_t lr_t |u_t - u_ref,t| (u = m^ / (sqrt(v^)
    + eps) from each side's moments after step t, recomputed here in
    fp32 in another order than the kernels': 2^-21 |u| each), plus 2^-21
    |p| a step (each side's update rounds p - lr (u + wd p) in fp32 a
    few times, at most half an ulp, 2^-24 |p| to 2^-23 |p|, each); the
    moments to 2^-4 of each leaf's largest entry (fp16 activations round
    every gradient term at 2^-11, and a leaf's terms cancel in the sum:
    measured 0.74-1.2%)."""
    jtr, tr = _trainers(family)
    assert tr._scaler is not None and jtr._scaler is not None
    batch = _packed(256, 1)
    kw = {k: batch[k] for k in ("position_ids", "segment_ids")}
    ref = np.asarray(jtr.model(jtr.params, jnp.asarray(batch["input_ids"]),
                               **{k: jnp.asarray(v) for k, v in kw.items()}),
                     np.float32)
    with torch.no_grad():
        got = tr.model(torch.from_numpy(batch["input_ids"]),
                       **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert got.dtype == torch.float16 and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0,
                               atol=2.0 ** -7 * np.abs(ref).max())
    opt = tr.optimizer
    bound = {n: torch.zeros(p.shape) for n, p in zip(tr.names, tr.params)}
    for step in range(1, 4):
        batch = _packed(256, 10 + step, empty_rows=2 if step == 3 else 0)
        if step == 3:
            batch = {k: v[-4:] for k, v in batch.items()}
            assert (batch["segment_ids"][2:] == 0).all()
        else:
            batch = {k: v[:4] for k, v in batch.items()}
        jm, tm = jtr.train_step(batch), tr.train_step(batch)
        for k in ("loss_scale", "amp_skipped"):
            assert float(tm[k]) == float(jm[k]), (step, k)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-4, err_msg=f"step {step} loss")
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-3,
                                   err_msg=f"step {step} grad_norm")
        ref_m = _by_name(jtr.opt_state["m"], tr.model)
        ref_v = _by_name(jtr.opt_state["v"], tr.model)
        ref_p = _by_name(jtr.params, tr.model)
        for name, p, m, v in zip(tr.names, tr.params, tr.opt_state["m"],
                                 tr.opt_state["v"]):
            u = adam_direction(m, v, step, opt)
            u_ref = adam_direction(ref_m[name], ref_v[name], step, opt)
            slack = 2.0 ** -21 * (u.abs() + u_ref.abs())
            bound[name] += opt._lr(step) * ((u - u_ref).abs() + slack) \
                + 2.0 ** -21 * torch.maximum(p.detach().abs(),
                                             ref_p[name].abs())
    ref = _by_name(jtr.params, tr.model)
    for name, p in zip(tr.names, tr.params):
        d = (p.detach() - ref[name]).abs()
        assert bool((d <= bound[name]).all()), \
            (name, float((d / bound[name]).max()))
    for key in ("m", "v"):
        theirs = _by_name(jtr.opt_state[key], tr.model)
        for name, m in zip(tr.names, tr.opt_state[key]):
            scale = float(theirs[name].abs().max())
            assert float((m - theirs[name]).abs().max()) <= 2 ** -4 * scale, \
                (key, name)


# ---------------------------------------------- tests/test_amp.py cases
def test_fp16_trainer_enables_scaler_and_trains():
    """fp16 compute under "auto": the scaler is on, six steps are finite,
    carry loss_scale, skip nothing, and the loss falls; bf16 compute has
    no scaler."""
    model = LlamaLMHeadModel(LlamaConfig.tiny(remat=False,
                                              compute_dtype=torch.float16),
                             device="cpu")
    tr = Trainer(model, TrainingConfig(global_batch_size=4,
                                       micro_batch_size=2, seq_len=32,
                                       lr=1e-3, warmup_steps=2,
                                       total_steps=20, log_every=100),
                 device="cpu").build()
    assert tr._scaler is not None and tr.scaler_state is not None
    rng = np.random.default_rng(0)
    batch = pad_batch([rng.integers(1, 250, size=28) for _ in range(4)], 32)
    m = [tr.train_step(batch) for _ in range(6)]
    losses = [float(x["loss"]) for x in m]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    assert all("loss_scale" in x for x in m)
    assert sum(float(x["amp_skipped"]) for x in m) == 0.0
    bf16 = LlamaLMHeadModel(LlamaConfig.tiny(remat=False), device="cpu")
    assert Trainer(bf16, TrainingConfig(global_batch_size=4,
                                        micro_batch_size=2, seq_len=32),
                   device="cpu")._scaler is None


def test_overflow_skips_and_halves_as_the_reference():
    """A scale far past fp16's range (2^27) overflows the fp16
    cotangents: the step is skipped (p, m, v and the step count kept)
    and the scale halves, again each step until an update lands; the
    port's sequence of skips and scales is the reference's."""
    def setup(jtr, tr):
        jtr._scaler = JGradScaler(init_scale=2.0 ** 27)
        tr._scaler = GradScaler(init_scale=2.0 ** 27)
    jtr, tr = _trainers("llama", setup=setup)
    batch = _packed(256, 3)
    batch = {k: v[:4] for k, v in batch.items()}
    before = [p.detach().clone() for p in tr.params]
    seq, ref_seq = [], []
    for _ in range(30):
        tm, jm = tr.train_step(batch), jtr.train_step(batch)
        seq.append((float(tm["amp_skipped"]), float(tm["loss_scale"])))
        ref_seq.append((float(jm["amp_skipped"]), float(jm["loss_scale"])))
        if seq[-1][0] == 0.0:
            break
        tr.settle()
        assert tr.opt_state["step"] == 0
        assert all(torch.equal(a, b) for a, b in zip(before, tr.params))
    assert seq == ref_seq
    assert seq[0] == (1.0, 2.0 ** 26) and seq[-1][0] == 0.0
    tr.settle()
    assert tr.opt_state["step"] == 1


def test_scale_grows_on_finite_streak():
    s = GradScaler(init_scale=2.0 ** 10, growth_interval=3)
    st = s.init(device="cpu")
    for _ in range(3):
        st = s.update(st, torch.tensor(True))
    assert float(st["scale"]) == 2.0 ** 11
    assert int(st["growth_tracker"]) == 0


def test_bf16_checkpoint_resumes_into_fp16_trainer(tmp_path):
    """The scaler's presence differs between the saved bf16 trainer and
    the resuming fp16 one: restore toggles it, and the resumed trainer
    keeps its fresh scaler state and takes a finite step."""
    tc = TrainingConfig(global_batch_size=4, micro_batch_size=2, seq_len=32,
                        total_steps=10, ckpt_dir=str(tmp_path))
    rng = np.random.default_rng(1)
    batch = pad_batch([rng.integers(1, 250, size=28) for _ in range(4)], 32)
    tr_b = Trainer(LlamaLMHeadModel(LlamaConfig.tiny(remat=False),
                                    device="cpu"), tc, device="cpu").build()
    tr_b.train_step(batch)
    tr_b.save(wait=True)
    tr_f = Trainer(LlamaLMHeadModel(LlamaConfig.tiny(
        remat=False, compute_dtype=torch.float16), device="cpu"), tc,
        device="cpu").build()
    tr_f.restore()
    assert tr_f.global_step == 1
    assert tr_f.scaler_state is not None
    assert float(tr_f.scaler_state["scale"]) == 2.0 ** 16
    assert np.isfinite(float(tr_f.train_step(batch)["loss"]))


# --------------------------------------------- packed against alone
@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("compute", [torch.float32, torch.float16])
def test_packed_sequences_score_as_alone(family, compute):
    """Each sequence of a packed row, scored alone (labels of the others
    masked), gives the loss sum and token count it gives alone in a
    padded row: attention stays inside its segment and positions
    restart.  On both sides, and the two sides agree: fp32 compute to
    1e-5, fp16 to 2e-3 relative (the packed and the alone forwards round
    each product in their own order: a row of fp16 roundings)."""
    jcfg, tcfg = _configs(family, compute)
    jcls, tcls = ((JLlamaLMHeadModel, LlamaLMHeadModel) if family == "llama"
                  else (JGPTLMHeadModel, GPTLMHeadModel))
    jmodel = jcls(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    tmodel = tcls(tcfg, device="cpu")
    load_jax_params(tmodel, _np(jparams))
    rng = np.random.default_rng(5)
    seqs = [rng.integers(1, 256, n) for n in (13, 5, 9, 1, 4)]
    packed = pack_sequences(seqs, 32, num_packed=1)
    assert packed["segment_ids"][0].max() == 5
    tol = 1e-5 if compute == torch.float32 else 2e-3
    alone = pad_batch(seqs, 32)

    def logits(batch):
        """(port, reference) fp32 logits of `batch`."""
        args = {k: batch[k] for k in ("input_ids", "position_ids",
                                      "segment_ids")}
        ref = jmodel(jparams, jnp.asarray(args.pop("input_ids")),
                     **{k: jnp.asarray(v) for k, v in args.items()})
        with torch.no_grad():
            mine = tmodel(torch.from_numpy(batch["input_ids"]),
                          **{k: torch.from_numpy(v) for k, v in args.items()})
        return mine.float().numpy(), np.asarray(ref, np.float32)

    def score(lg, labels, keep):
        """(loss sum, count) of the next-token targets labels[1:] where
        `keep` (the sequence's tokens), in fp64 from fp32 logits."""
        lg, tgt = lg[:-1].astype(np.float64), labels[1:]
        on = keep[1:] & (tgt != -100)
        z = lg - lg.max(-1, keepdims=True)
        nll = np.log(np.exp(z).sum(-1)) - np.take_along_axis(
            z, np.where(on, tgt, 0)[:, None], -1)[:, 0]
        return float(nll[on].sum()), int(on.sum())

    packed_lg, alone_lg = logits(packed), logits(alone)
    order = sorted(range(len(seqs)), key=lambda j: -len(seqs[j]))
    for j, s in enumerate(seqs):
        seg = 1 + order.index(j)       # packed longest first, 1-indexed
        out = []
        for side in (0, 1):            # port, reference
            in_row = packed["segment_ids"][0] == seg
            out.append((score(packed_lg[side][0], packed["labels"][0],
                              in_row),
                        score(alone_lg[side][j], alone["labels"][j],
                              alone["segment_ids"][j] == 1)))
        (mine_p, mine_a), (ref_p, ref_a) = out
        assert mine_p[1] == mine_a[1] == ref_p[1] == ref_a[1] == len(s) - 1
        for a, b in ((mine_p[0], mine_a[0]), (ref_p[0], ref_a[0]),
                     (mine_p[0], ref_p[0])):
            assert abs(a - b) <= tol * max(abs(b), 1.0), (j, a, b)


# ------------------------------------------------------------ refusals
@pytest.mark.parametrize("what", ["trainer_params", "engine_model",
                                  "engine_draft"])
def test_fp16_parameters_and_fp16_serving_are_refused_by_name(what):
    """Neither is refused any more (the name is kept): the Trainer takes
    fp16 parameters (AdamW's fp16 arm), with fp32 accumulators and the
    scale on, and steps them in place in fp16; the engine takes a model
    and a draft that compute in fp16 and builds fp16 pools and scratch
    (the serving kernels' fp16 arms).  tests/test_torch_fp16_params.py
    holds the fp16-parameter Trainer against the reference."""
    from hetu_tpu_torch.serving import Request, ServeConfig, ServingEngine
    f16 = LlamaLMHeadModel(LlamaConfig.tiny(compute_dtype=torch.float16),
                           device="cpu")
    if what == "trainer_params":
        model = LlamaLMHeadModel(LlamaConfig.tiny(
            compute_dtype=torch.float16, param_dtype=torch.float16),
            device="cpu")
        tr = Trainer(model, TrainingConfig(global_batch_size=4,
                                           micro_batch_size=2, seq_len=32),
                     device="cpu").build()
        assert tr._scaler is not None
        assert all(p.dtype == torch.float16 for p in tr.params)
        assert all(a.dtype == torch.float32 for a in tr._accum)
        before = [p.detach().clone() for p in tr.params]
        rng = np.random.default_rng(2)
        m = tr.train_step(pad_batch([rng.integers(1, 250, size=28)
                                     for _ in range(4)], 32))
        assert float(m["amp_skipped"]) == 0.0
        assert all(p.dtype == torch.float16 for p in tr.params)
        assert not all(torch.equal(a, b.detach())
                       for a, b in zip(before, tr.params))
        return
    config = ServeConfig(num_slots=2, max_len=32, prefill_chunk=8)
    kw = {}
    if what == "engine_draft":
        config = ServeConfig(num_slots=2, max_len=32, prefill_chunk=8,
                             spec_decode="model")
        kw["draft_model"], f16 = f16, LlamaLMHeadModel(LlamaConfig.tiny(
            compute_dtype=torch.float16), device="cpu")
    eng = ServingEngine(f16, config, device="cpu", **kw)
    assert eng.pool.k.dtype == eng.pool.v.dtype == torch.float16
    assert all(t.dtype == torch.float16 for t in eng._new_scratch())
    res = eng.run([Request(rid=0, prompt=np.arange(5, dtype=np.int32),
                           max_new_tokens=3)])
    assert len(res[0].tokens) == 3
