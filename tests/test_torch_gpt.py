"""The port's GPT family (hetu_tpu_torch/models/gpt) against the JAX
reference, on the CPU: the training forward and its gradients, the
`Trainer`, and the serving forwards and engine.

Every comparison is in fp32 from the same weights, drawn by the
reference's own init and carried across by `load_jax_params` (stacked
and per-layer trees).  Tolerances are the reference's: 1e-4 across a
model forward (logits, the "sum" loss; gradients at 1e-4 of each
leaf's largest entry), the `Trainer`'s at those of
tests/test_torch_train.py, identical greedy tokens.

The training model has head dim 64 (hidden 256, 4 heads), the shape the
port's flash kernels take on the card; on the CPU the port runs flash's
plain version where a test forces it, and the reference its XLA
attention (its Pallas flash gate needs head dim % 128).  The serving
forwards run at head dim 128 (hidden 256, 2 heads): the reference's
paged kernels, in interpret mode, take only that.
"""
from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from hetu_tpu import serving as jserving
from hetu_tpu.engine import Trainer as JTrainer
from hetu_tpu.engine import TrainingConfig as JTrainingConfig
from hetu_tpu.models import generation as jgen
from hetu_tpu.models.gpt import GPTConfig as JGPTConfig
from hetu_tpu.models.gpt import GPTLMHeadModel as JGPTLMHeadModel
from hetu_tpu.obs.metrics import MetricsRegistry as JMetricsRegistry
from hetu_tpu_torch import serving as tserving
from hetu_tpu_torch.engine import Trainer, TrainingConfig
from hetu_tpu_torch.models import generation as tgen
from hetu_tpu_torch.models.gpt import (GPTConfig, GPTLMHeadModel,
                                       load_jax_params)
from hetu_tpu_torch.ops.cuda import fused_norm
from hetu_tpu_torch.serving import spec_decode as tspec
from test_torch_parity import HD128, MODEL_TOL, jax_llama_and_port

TOL = 1e-5
#: the training widths: head dim 64, as GPT-2's
HD64 = dict(hidden_size=256, num_attention_heads=4)
#: the serving widths: head dim 128, which the reference's paged kernels
#: take
GPT_HD128 = dict(hidden_size=256, num_attention_heads=2)
ENGINE = dict(num_slots=3, page_size=8, max_len=64, prefill_chunk=8)
_PALLAS = "paged_attn,paged_verify,sample,quant"


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def jax_gpt_and_port(seed=0, *, use_scan=True, remat_policy="nothing",
                     **kw):
    """(JAX model, params, port model on the CPU) sharing one set of
    weights, fp32 on both sides."""
    jcfg = JGPTConfig.tiny(compute_dtype=jnp.float32, use_scan=use_scan,
                           remat_policy=remat_policy, **kw)
    jmodel = JGPTLMHeadModel(jcfg)
    jparams = jmodel.init(jax.random.key(seed))
    tmodel = GPTLMHeadModel(
        GPTConfig.tiny(compute_dtype=torch.float32, use_scan=use_scan,
                       remat_policy=remat_policy, **kw), device="cpu")
    load_jax_params(tmodel, _np(jparams))
    return jmodel, jparams, tmodel


def _by_name(tree, like: GPTLMHeadModel):
    """A pytree shaped like the reference's params (grads, moments), as
    {port parameter name: tensor}, through the loader's own mapping."""
    scratch = GPTLMHeadModel(like.config, device="cpu")
    load_jax_params(scratch, _np(tree))
    return dict(scratch.named_parameters())


def _batch(vocab, seed, b=2, s=32):
    ids = np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)
    labels = ids.copy()
    labels[0, 3:7] = -100
    return ids, labels


def _force_flash(model: GPTLMHeadModel):
    """Route a CPU port model through flash's plain version."""
    for block in model.model.blocks:
        block.attn.use_pallas = True
    return model


# ---------------------------------------------------------------- model
def test_config_matches_the_reference():
    for name in ("tiny", "gpt2_large"):
        j, t = getattr(JGPTConfig, name)(), getattr(GPTConfig, name)()
        assert (t.head_dim, t.intermediate_size, t.num_params(),
                t.flops_per_token(1024)) == \
            (j.head_dim, j.intermediate_size, j.num_params(),
             j.flops_per_token(1024))
    large = GPTConfig.gpt2_large()
    assert (large.hidden_size, large.num_hidden_layers,
            large.num_attention_heads, large.head_dim, large.vocab_size,
            large.max_position_embeddings) == (1280, 36, 20, 64, 50257, 1024)
    assert large.num_params() == 774_030_080
    model = GPTLMHeadModel(GPTConfig.tiny(), device="cpu")
    assert sum(p.numel() for p in model.parameters()) == \
        GPTConfig.tiny().num_params()


@pytest.mark.parametrize("use_scan", [True, False])
def test_logits_and_sum_loss_match_the_reference(use_scan):
    """Both of the reference's layer layouts load; logits and the "sum"
    loss with its token count match."""
    jmodel, jparams, tmodel = jax_gpt_and_port(1, use_scan=use_scan,
                                               remat=False, **HD64)
    if not use_scan:
        assert "block_1" in jparams["model"]
    ids, labels = _batch(256, 2)
    jl = jmodel(jparams, jnp.asarray(ids))
    tl = tmodel(torch.from_numpy(ids))
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                               atol=MODEL_TOL)
    (jloss, jcount) = jmodel(jparams, jnp.asarray(ids),
                             labels=jnp.asarray(labels),
                             loss_reduction="sum")
    tloss, tcount = tmodel(torch.from_numpy(ids), torch.from_numpy(labels),
                           loss_reduction="sum")
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=TOL)
    assert float(tcount) == float(jcount) == 2 * 31 - 4


def test_load_refuses_the_other_layout_and_a_bad_tree():
    _, jparams, tmodel = jax_gpt_and_port(1, **HD64)
    scan_off = GPTLMHeadModel(GPTConfig.tiny(use_scan=False, **HD64),
                              device="cpu")
    with pytest.raises(ValueError, match="use_scan"):
        load_jax_params(scan_off, _np(jparams))
    tree = _np(jparams)
    del tree["model"]["wpe"]
    with pytest.raises(ValueError, match="model.wpe"):
        load_jax_params(tmodel, tree)


@pytest.fixture(scope="module")
def gpt_grads():
    """{policy: {name: grad}} of the port, filled by the policy test's
    cases and compared across them."""
    return {}


@pytest.mark.parametrize("policy", ["nothing", "dots", "dots_attn"])
def test_loss_and_every_gradient_match_under_each_policy(gpt_grads, policy):
    """The training forward with flash attention (its plain version,
    head dim 64) under each recompute policy: loss at 1e-4 and every
    parameter's gradient at 1e-4 of its largest entry against the
    reference (same policy); the tied `wte` takes the embedding's and
    the head's gradients, summed; the port's gradients are the same
    under all three policies."""
    jmodel, jparams, tmodel = jax_gpt_and_port(
        4, remat=True, remat_policy=policy, **HD64)
    _force_flash(tmodel)
    ids, labels = _batch(256, 5, s=64)
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
    mine = {name: p.grad.clone() for name, p in tmodel.named_parameters()}
    assert set(mine) == set(ref)
    for name, g in mine.items():
        scale = float(ref[name].abs().max())
        assert scale > 0, name
        np.testing.assert_allclose(g.numpy(), ref[name].numpy(),
                                   atol=MODEL_TOL * scale, err_msg=name)
    gpt_grads[policy] = mine
    first = next(iter(gpt_grads.values()))
    for name, g in mine.items():
        torch.testing.assert_close(
            g, first[name], rtol=0, atol=1e-6 * float(g.abs().max()),
            msg=f"{policy}: {name}")


def test_dense_path_gradients_match_without_recompute():
    """use_flash_attention=False, remat off: the dense attention on both
    sides, every gradient at 1e-4 of its leaf's largest entry."""
    jmodel, jparams, tmodel = jax_gpt_and_port(
        6, remat=False, use_flash_attention=False, **HD64)
    ids, labels = _batch(256, 7)
    jgrads = jax.grad(
        lambda p: jmodel(p, jnp.asarray(ids), labels=jnp.asarray(labels)))(
        jparams)
    for p in tmodel.parameters():
        p.requires_grad_(True)
    tmodel(torch.from_numpy(ids), torch.from_numpy(labels)).backward()
    ref = _by_name(jgrads, tmodel)
    for name, p in tmodel.named_parameters():
        np.testing.assert_allclose(
            p.grad.numpy(), ref[name].numpy(),
            atol=MODEL_TOL * float(ref[name].abs().max()), err_msg=name)


@pytest.mark.parametrize("policy", ["nothing", "dots", "dots_attn",
                                    "offload"])
def test_every_block_runs_the_layernorm_kernel(monkeypatch, policy):
    """ln2's residual pair goes through the fused LayerNorm arm: its
    forward twice a block (forward and recompute) under every policy,
    its backward once; the serving forwards never take it."""
    calls = {}
    for name in ("residual_layernorm_fwd", "residual_layernorm_bwd"):
        def counted(*a, _name=name, _fn=getattr(fused_norm, name), **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(fused_norm, name, counted)
    model = GPTLMHeadModel(GPTConfig.tiny(
        compute_dtype=torch.float32, remat_policy=policy, **HD64),
        device="cpu")
    for p in model.parameters():
        p.requires_grad_(True)
    ids, labels = _batch(256, 8)
    model(torch.from_numpy(ids), torch.from_numpy(labels)).backward()
    L = model.config.num_hidden_layers
    assert calls == {"residual_layernorm_fwd": 2 * L,
                     "residual_layernorm_bwd": L}
    calls.clear()
    tgen.last_logits(model, torch.from_numpy(ids))
    assert calls == {"residual_layernorm_fwd": L}       # no recompute
    calls.clear()
    k = torch.zeros(L, 1, 32, 4, 64)
    tgen.extend_cache(model, torch.from_numpy(ids[:1]), (k, k.clone()), 0)
    assert calls == {}


def test_positions_past_the_table_raise():
    model = GPTLMHeadModel(GPTConfig.tiny(compute_dtype=torch.float32),
                           device="cpu")
    P = model.config.max_position_embeddings
    with pytest.raises(ValueError, match="max_position_embeddings"):
        model(torch.zeros(1, P + 1, dtype=torch.long))
    with pytest.raises(ValueError, match="max_position_embeddings"):
        model(torch.zeros(1, 4, dtype=torch.long),
              position_ids=torch.tensor([[0, 1, 2, P]]))
    k = torch.zeros(2, 1, P + 8, 4, 16)
    with pytest.raises(ValueError, match="max_position_embeddings"):
        tgen.extend_cache(model, torch.zeros(1, 8, dtype=torch.long),
                          (k, k.clone()), P)
    pool = torch.zeros(2, 4, 8, 4, 16)
    with pytest.raises(ValueError, match="max_position_embeddings"):
        tgen.decode_step_paged(model, torch.zeros(1, dtype=torch.long),
                               pool, pool.clone(),
                               torch.ones(1, 2, dtype=torch.int32),
                               np.array([P], np.int32))


@pytest.mark.parametrize("param_dtype,compute_dtype", [
    (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16)])
def test_embeddings_round_once_into_the_compute_dtype(param_dtype,
                                                      compute_dtype):
    """wte[ids] + wpe[pos] is added in the wider dtype and rounded once,
    bit for bit: fp32 tables with bf16 compute as the reference's
    `(wte + wpe).astype(bf16)`; bf16 tables with fp32 compute summed in
    fp32, as the reference's compiled step keeps them."""
    model = GPTLMHeadModel(GPTConfig.tiny(param_dtype=param_dtype,
                                          compute_dtype=compute_dtype),
                           device="cpu", seed=3)
    with torch.no_grad():
        model.model.wpe.normal_(0.0, 0.02)
    ids = torch.from_numpy(np.random.default_rng(4).integers(0, 256, (2, 16)))
    wte = model.model.wte.weight.detach()[ids]
    wpe = model.model.wpe.detach()[:16]
    got = model.embed_at(ids)
    assert got.dtype == compute_dtype
    acc = torch.float32 if torch.float32 in (param_dtype, compute_dtype) \
        else torch.bfloat16
    want = (wte.to(acc) + wpe.to(acc)).to(compute_dtype)
    assert torch.equal(got, want)
    if param_dtype == torch.float32:
        ref = (jnp.asarray(wte.numpy()) + jnp.asarray(wpe.numpy())).astype(
            jnp.bfloat16)
        assert torch.equal(got.float(),
                           torch.from_numpy(np.asarray(ref, np.float32)))


@pytest.mark.parametrize("field,value,exc", [
    ("pipeline_stage_layers", (1, 1), NotImplementedError),
    ("attention_dropout", 1.0, ValueError),
    ("remat_policy", "everything", ValueError)])
def test_config_refuses_options_of_later_slices(field, value, exc):
    with pytest.raises(exc):
        GPTConfig.tiny(**{field: value})


@pytest.mark.parametrize("field,value", [
    ("attention_dropout", 0.1), ("hidden_dropout", 0.1),
    ("remat_policy", "offload")])
def test_config_accepts_options_of_this_slice(field, value):
    """Dropout and the "offload" policy build and train (dropout on):
    one Trainer step with finite metrics."""
    model = GPTLMHeadModel(GPTConfig.tiny(**{field: value}), device="cpu")
    tr = Trainer(model, TrainingConfig(**dict(_TRAIN,
                                              dropout_deterministic=False)),
                 device="cpu")
    ids, labels = _batch(256, 9, b=4)
    metrics = tr.train_step({"input_ids": ids, "labels": labels})
    assert all(np.isfinite(float(v)) for v in metrics.values())


def test_model_refuses_a_strategy():
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        GPTLMHeadModel(GPTConfig.tiny(), object(), device="cpu")


# -------------------------------------------------------------- trainer
_TRAIN = dict(global_batch_size=4, micro_batch_size=2, seq_len=32,
              warmup_steps=1, total_steps=10, log_every=100)


def test_trainer_steps_match_the_reference():
    """Three steps of two micro-batches from the same params: loss and
    grad norm to 1e-5 relative, lr to 1e-6; then the parameters (1e-4
    absolute, all but 0.1% within 1e-6) and both AdamW moments (5e-5 of
    each leaf's largest entry), as tests/test_torch_train.py holds the
    LLaMA trainer."""
    jcfg = JGPTConfig.tiny(compute_dtype=jnp.float32, **HD64)
    jtr = JTrainer(JGPTLMHeadModel(jcfg), JTrainingConfig(**_TRAIN)).build()
    model = GPTLMHeadModel(GPTConfig.tiny(compute_dtype=torch.float32,
                                          **HD64), device="cpu")
    load_jax_params(model, _np(jtr.params))
    tr = Trainer(model, TrainingConfig(**_TRAIN), device="cpu")
    for seed in range(3):
        ids, labels = _batch(256, 30 + seed, b=4)
        batch = {"input_ids": ids, "labels": labels}
        jm, tm = jtr.train_step(batch), tr.train_step(batch)
        for k, tol in (("loss", TOL), ("grad_norm", TOL), ("lr", 1e-6)):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=tol,
                                       err_msg=f"step {seed + 1} {k}")
    assert tr.global_step == 3
    names = [n for n, _ in model.named_parameters()]
    ref_p = _by_name(jtr.params, model)
    for name, p in zip(names, tr.params):
        d = (p.detach() - ref_p[name]).abs()
        assert float(d.max()) <= 1e-4, name
        if name.endswith("bqkv"):
            # the key bias adds the same q.b to every score of a row,
            # which the softmax ignores: its gradient is rounding alone,
            # and AdamW's m / sqrt(v) moves each element by up to lr in
            # either run, so it is held to the 1e-4 above only
            d = d[:, [0, 2]]
        assert float((d > 1e-6).float().mean()) <= 1e-3, name
    for key in ("m", "v"):
        ref = _by_name(jtr.opt_state[key], model)
        for name, mine in zip(names, tr.opt_state[key]):
            scale = float(ref[name].abs().max())
            assert float((mine - ref[name]).abs().max()) <= 5e-5 * scale, \
                (key, name)


# ------------------------------------------------------ serving forwards
@pytest.fixture
def pallas(monkeypatch):
    monkeypatch.setenv("HETU_TPU_PALLAS", "1")
    monkeypatch.setenv("HETU_TPU_PALLAS_KERNELS", _PALLAS)


@pytest.fixture(scope="module")
def serve_pair():
    return jax_gpt_and_port(3, remat=False, **GPT_HD128)


def test_extend_cache_matches_reference(serve_pair):
    """Two consecutive prefill chunks: logits and the written cache
    match the reference's `extend_cache` (`_extend_cache_gpt`)."""
    jmodel, jparams, tmodel = serve_pair
    c = tmodel.config
    rng = np.random.default_rng(7)
    shape = (c.num_hidden_layers, 1, 32, c.num_attention_heads, c.head_dim)
    jcache = (jnp.zeros(shape), jnp.zeros(shape))
    tcache = (torch.zeros(shape), torch.zeros(shape))
    for start in (0, 8):
        ids = rng.integers(0, c.vocab_size, (1, 8)).astype(np.int32)
        jl, jcache = jgen.extend_cache(jmodel, jparams, jnp.asarray(ids),
                                       jcache, start)
        tl, tcache = tgen.extend_cache(tmodel, _t(ids), tcache, start)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=MODEL_TOL)
    for t, j in zip(tcache, jcache):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=MODEL_TOL)


@pytest.mark.parametrize("family", ["llama", "gpt"])
def test_extend_cache_takes_a_start_per_row(serve_pair, family):
    """start as [b], one position per row, as the reference takes it:
    logits and cache match the reference's; a start of another shape
    or off the cache raises ValueError by name."""
    if family == "gpt":
        jmodel, jparams, tmodel = serve_pair
    else:
        jmodel, jparams, tmodel = jax_llama_and_port(seed=3, **HD128)
    c = tmodel.config
    n_kv = getattr(c, "num_key_value_heads", c.num_attention_heads)
    rng = np.random.default_rng(9)
    shape = (c.num_hidden_layers, 2, 32, n_kv, c.head_dim)
    cache = rng.standard_normal((2,) + shape).astype(np.float32)
    ids = rng.integers(0, c.vocab_size, (2, 6)).astype(np.int32)
    start = np.array([3, 11], np.int32)
    jl, jcache = jgen.extend_cache(jmodel, jparams, jnp.asarray(ids),
                                   (jnp.asarray(cache[0]),
                                    jnp.asarray(cache[1])),
                                   jnp.asarray(start))
    tcache = (_t(cache[0]), _t(cache[1]))
    tl, _ = tgen.extend_cache(tmodel, _t(ids), tcache, _t(start))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=MODEL_TOL)
    for t, j in zip(tcache, jcache):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=MODEL_TOL)
    for bad in (np.array([1, 2, 3]), np.array([[1, 2]]), np.array([-1, 0]),
                np.array([0, 27])):
        with pytest.raises(ValueError, match="start|chunk"):
            tgen.extend_cache(tmodel, _t(ids), tcache, _t(bad))


@pytest.mark.parametrize("family", ["llama", "gpt"])
def test_extend_cache_int_start_equals_a_uniform_row_start(serve_pair,
                                                           family):
    """The int start (one slice write, a [C, M] mask) and a [b] start of
    equal entries (the per-row scatter, a [b, C, M] mask) write the same
    cache and give the same logits."""
    tmodel = (serve_pair[2] if family == "gpt"
              else jax_llama_and_port(seed=3, **HD128)[2])
    c = tmodel.config
    n_kv = getattr(c, "num_key_value_heads", c.num_attention_heads)
    rng = np.random.default_rng(11)
    shape = (c.num_hidden_layers, 2, 32, n_kv, c.head_dim)
    cache = rng.standard_normal((2,) + shape).astype(np.float32)
    ids = _t(rng.integers(0, c.vocab_size, (2, 6)).astype(np.int32))
    a = (_t(cache[0]), _t(cache[1]))
    b = (_t(cache[0]), _t(cache[1]))
    la, _ = tgen.extend_cache(tmodel, ids, a, 5)
    lb, _ = tgen.extend_cache(tmodel, ids, b, torch.tensor([5, 5]))
    torch.testing.assert_close(la, lb, rtol=0, atol=0)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def _forward_case(c, quant, seed):
    """Pools (k, v, k_scale, v_scale), table and positions for four slots
    (one inactive) at mixed depths, quantized by the reference's pool
    path."""
    from hetu_tpu.serving import kv_pool as jkv_pool
    rng = np.random.default_rng(seed)
    shape = (c.num_hidden_layers, 10, 8, c.num_attention_heads, c.head_dim)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    ks = vs = None
    if quant != "none":
        bits = 4 if quant == "int4" else 8
        k, ks = map(np.asarray, jkv_pool.quantize_heads(jnp.asarray(k), bits))
        v, vs = map(np.asarray, jkv_pool.quantize_heads(jnp.asarray(v), bits))
    table = np.array([[1, 2, 3, 0], [4, 5, 0, 0], [6, 7, 8, 9],
                      [0, 0, 0, 0]], np.int32)
    positions = np.array([20, 9, 27, 0], np.int32)
    return k, v, ks, vs, table, positions


def _check_pools(mine, ref):
    for m, r in zip(mine, ref):
        if m.dtype in (torch.int8, torch.uint8):
            np.testing.assert_array_equal(m.numpy(), np.asarray(r))
        else:
            np.testing.assert_allclose(m.numpy(), np.asarray(r),
                                       atol=MODEL_TOL)


@pytest.mark.parametrize("quant", ["none", "int8", "int4"])
def test_decode_step_paged_matches_reference(pallas, serve_pair, quant):
    """The port's paged decode (plain paged attention on the CPU) against
    the reference's `_decode_step_paged_gpt` (its Pallas kernel in
    interpret mode): logits and the written pools, on exact, int8 and
    int4 pages."""
    jmodel, jparams, tmodel = serve_pair
    c = tmodel.config
    k, v, ks, vs, table, positions = _forward_case(c, quant, 11)
    tokens = np.random.default_rng(12).integers(0, c.vocab_size, 4).astype(
        np.int32)
    jkw = {} if quant == "none" else dict(
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs), kv_quant=quant)
    jl, *jpools = jgen.decode_step_paged(
        jmodel, jparams, jnp.asarray(tokens), jnp.asarray(k),
        jnp.asarray(v), jnp.asarray(table), jnp.asarray(positions), **jkw)
    pools = [_t(a) for a in (k, v, ks, vs) if a is not None]
    tkw = {} if quant == "none" else dict(k_scale=pools[2],
                                          v_scale=pools[3], kv_quant=quant)
    tl, *out = tgen.decode_step_paged(tmodel, _t(tokens), pools[0],
                                      pools[1], _t(table), positions, **tkw)
    assert all(a is b for a, b in zip(out, pools))        # in place
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=MODEL_TOL)
    _check_pools(pools, jpools)


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_verify_step_paged_matches_reference(pallas, serve_pair, quant):
    jmodel, jparams, tmodel = serve_pair
    c = tmodel.config
    k, v, ks, vs, table, positions = _forward_case(c, quant, 13)
    tokens = np.random.default_rng(14).integers(
        0, c.vocab_size, (4, 3)).astype(np.int32)
    jkw = {} if quant == "none" else dict(
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs), kv_quant=quant)
    jout, *jpools = jgen.verify_step_paged(
        jmodel, jparams, jnp.asarray(tokens), jnp.asarray(k),
        jnp.asarray(v), jnp.asarray(table), jnp.asarray(positions), **jkw)
    pools = [_t(a) for a in (k, v, ks, vs) if a is not None]
    tkw = {} if quant == "none" else dict(k_scale=pools[2],
                                          v_scale=pools[3], kv_quant=quant)
    tout, *_ = tgen.verify_step_paged(tmodel, _t(tokens), pools[0],
                                      pools[1], _t(table), _t(positions),
                                      **tkw)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout),
                               atol=MODEL_TOL)
    _check_pools(pools, jpools)


def test_last_logits_match_reference_prefill(serve_pair):
    jmodel, jparams, tmodel = serve_pair
    ids = np.random.default_rng(15).integers(0, 256, (2, 13)).astype(
        np.int32)
    jl, _ = jgen.prefill(jmodel, jparams, jnp.asarray(ids), 32)
    np.testing.assert_allclose(tgen.last_logits(tmodel, _t(ids)).numpy(),
                               np.asarray(jl), atol=MODEL_TOL)
    assert torch.equal(tmodel.lm_head_weight(),
                       tmodel.model.wte.weight.t())
    np.testing.assert_array_equal(
        tmodel.lm_head_weight().numpy(),
        np.asarray(jgen.lm_head_weight(jmodel, jparams)))


# ---------------------------------------------------------------- engine
def _trace(pkg, n=5, seed=1, vocab=256):
    """Multi-chunk prompts, arrivals 100 s apart: each request finds the
    engine idle whatever the host's load."""
    return pkg.synthetic_requests(
        n, vocab_size=vocab, prompt_lens=(3, 20), max_new=(2, 8),
        arrivals=100.0 * np.arange(n), seed=seed)


def _engines_run(jmodel, jparams, tmodel, **cfg):
    jeng = jserving.ServingEngine(jmodel, jparams,
                                  jserving.ServeConfig(**ENGINE, **cfg),
                                  registry=JMetricsRegistry())
    teng = tserving.ServingEngine(tmodel,
                                  tserving.ServeConfig(**ENGINE, **cfg),
                                  device="cpu").warmup()
    jres, tres = jeng.run(_trace(jserving)), teng.run(_trace(tserving))
    teng.scheduler.check_invariants()
    assert teng.pool.free_count == teng.pool.num_pages
    for t, j in zip(tres, jres):
        assert t.tokens == j.tokens, f"request {t.rid} diverged"
        assert t.finished_reason == j.finished_reason == "length"
    return teng, tres


def test_engine_emits_the_reference_engines_tokens():
    """The reference's GPT engine test (tests/test_serving.py
    `test_gpt_family_through_engine`: GPTConfig.tiny, fp32) on a trace
    of multi-chunk prompts: identical greedy tokens, and generate()'s."""
    jmodel, jparams, tmodel = jax_gpt_and_port(1, remat=False)
    teng, tres = _engines_run(jmodel, jparams, tmodel)
    assert teng.pool.k.shape[3] == tmodel.config.num_attention_heads
    assert any(r.prompt_len > ENGINE["prefill_chunk"]
               for r in _trace(tserving))
    for r in _trace(jserving):
        out = jgen.generate(jmodel, jparams, jnp.asarray(r.prompt)[None],
                            max_new_tokens=r.max_new_tokens)
        assert tres[r.rid].tokens == \
            [int(t) for t in np.asarray(out)[0][r.prompt_len:]]


def test_engine_on_int8_pages_matches_the_reference(pallas, serve_pair):
    """int8 pages: the reference's engine through its paged kernel and
    quantize in interpret mode; identical greedy tokens."""
    teng, _ = _engines_run(*serve_pair, kv_quant="int8")
    assert teng.pool.k.dtype == torch.int8


def test_model_drafter_takes_a_gpt_draft(serve_pair):
    """spec_decode="model" with a GPT draft for a GPT target: the
    drafter's forward is `last_logits`, which the GPT model serves;
    greedy requests give the tokens of the engine without speculation,
    and drafts are proposed."""
    _, _, tmodel = serve_pair
    _, _, draft = jax_gpt_and_port(7, remat=False, hidden_size=64,
                                   num_attention_heads=2,
                                   num_hidden_layers=1)
    spec = tserving.ServingEngine(
        tmodel, tserving.ServeConfig(**ENGINE, sampling=True,
                                     spec_decode="model", spec_k=2),
        draft_model=draft, device="cpu").warmup()
    assert isinstance(spec.drafter, tspec.ModelDrafter)
    plain = tserving.ServingEngine(tmodel, tserving.ServeConfig(**ENGINE),
                                   device="cpu")
    got, want = spec.run(_trace(tserving)), plain.run(_trace(tserving))
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert sum(r.stats.spec_proposed for r in got) > 0
