"""The port's Mixture-of-Experts (hetu_tpu_torch/nn/moe.py and the
model, serving and training paths through it) against the JAX
reference, on the CPU.

Inputs are numpy arrays drawn from a seed and handed to both packages;
weights are the reference's init, loaded into the port with
`load_jax_params`.  Everything computes in fp32.  Routing is discrete,
so plans are compared exactly (expert indices, destinations, keeps,
loads and drops); values at 1e-6 (the gates and aux losses), 1e-5 (a
layer's output and gradients) and 1e-4 (a model's loss), and greedy
tokens exactly.  "Capacity pressure" is a capacity factor of 0.5, so
pairs drop.
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
from hetu_tpu import serving as jserving
from hetu_tpu.engine import Trainer as JTrainer
from hetu_tpu.engine import TrainingConfig as JTrainingConfig
from hetu_tpu.models.llama import LlamaConfig as JLlamaConfig
from hetu_tpu.models.llama import LlamaLMHeadModel as JLlamaLMHeadModel
from hetu_tpu.nn import moe as jmoe
from hetu_tpu.nn.moe_rebalance import CapacityRebalancer as JRebalancer
from hetu_tpu.nn.remat import remat_policy as jremat_policy
from hetu_tpu.obs.metrics import MetricsRegistry as JMetricsRegistry
from hetu_tpu.parallel import ParallelStrategy
from hetu_tpu.serving import experts as jexperts
from hetu_tpu.utils import flags as jflags
from hetu_tpu_torch import serving as tserving
from hetu_tpu_torch.engine import Trainer, TrainingConfig
from hetu_tpu_torch.models.llama import (LlamaConfig, LlamaLMHeadModel,
                                         load_jax_params)
from hetu_tpu_torch.nn import moe as tmoe
from hetu_tpu_torch.nn import moe_dispatch as tdispatch
from hetu_tpu_torch.nn import remat as tremat
from hetu_tpu_torch.nn.moe_rebalance import CapacityRebalancer, apply
from hetu_tpu_torch.obs import numerics as tnumerics
from hetu_tpu_torch.obs.metrics import MetricsRegistry
from hetu_tpu_torch.serving import experts as texperts
from hetu_tpu_torch.utils import flags

H, INTER, E = 32, 48, 8
#: the tiny MoE Llama both packages build (fp32 compute, dense attention)
MOE = dict(num_experts=4, moe_top_k=2)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _logits(T=64, seed=0, scale=1.5):
    return np.random.default_rng(seed).normal(
        scale=scale, size=(T, E)).astype(np.float32)


def _ids(T=64, seed=1):
    return np.random.default_rng(seed).integers(0, 1000, T).astype(np.int32)


def _cfg(gate, **kw):
    """The same MoEConfig on both sides (SAM in groups of 4)."""
    d = dict(num_experts=E, top_k=2, gate=gate,
             sam_group_size=4 if gate == "sam" else 0)
    d.update(kw)
    return jmoe.MoEConfig(**d), tmoe.MoEConfig(**d)


# ---------------------------------------------------------------- gates
@pytest.mark.parametrize("gate", tmoe.GATES)
def test_select_experts_matches_the_reference(gate):
    """Every gate picks the reference's experts, in the reference's
    slot order, with its gate values (1e-6)."""
    jcfg, tcfg = _cfg(gate)
    lg, ids = _logits(), _ids()
    je, jg = jmoe.select_experts(jnp.asarray(lg), jnp.asarray(ids), jcfg)
    te, tg = tmoe.select_experts(_t(lg), _t(ids), tcfg)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("gate", ["topk", "sam"])
def test_aux_losses_match_the_reference(gate):
    """The load-balance + z-loss aux (and SAM's alignment hinge, with
    its own coefficient) at 1e-6."""
    jcfg, tcfg = _cfg(gate, sam_alignment_coef=0.05)
    lg, ids = _logits(seed=3), _ids(seed=4)
    je, _ = jmoe.select_experts(jnp.asarray(lg), jnp.asarray(ids), jcfg)
    ref = float(jmoe.aux_losses(jnp.asarray(lg), je, jcfg))
    out = float(tmoe.aux_losses(_t(lg), _t(je).long(), tcfg))
    np.testing.assert_allclose(out, ref, rtol=1e-6)


def test_sort_routing_plan_is_the_references():
    """Under capacity pressure: destinations, source tokens, gates,
    keeps, per-expert loads and the drop count, exactly."""
    jcfg, tcfg = _cfg("topk")
    lg, ids = _logits(seed=5, scale=3.0), _ids()
    je, jg = jmoe.select_experts(jnp.asarray(lg), jnp.asarray(ids), jcfg)
    C = 8                                     # 128 pairs over 8 x 8 slots
    jp = jmoe.sort_routing(je, jg, E, C)
    tp = tmoe.sort_routing(_t(je).long(), _t(jg), E, C)
    assert int(jp["dropped"]) == int(tp["dropped"]) > 0
    for k in ("dest", "tok", "keep", "load"):
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]),
                                      err_msg=k)
    np.testing.assert_array_equal(tp["gate"].numpy(), np.asarray(jp["gate"]))


def test_router_stats_match_the_reference():
    """The numerics "moe" stats of one plan: load, load_max, entropy,
    dropped, drop_frac (1e-6)."""
    lg = _logits(seed=6)
    counts = np.bincount(np.arange(128) % E, minlength=E).astype(np.int32)
    ref = jmoe._router_stats(jnp.asarray(lg), jnp.asarray(counts),
                             jnp.asarray(5, jnp.int32))
    out = tmoe._router_stats(_t(lg), _t(counts).long(), torch.tensor(5))
    for k, v in ref.items():
        np.testing.assert_allclose(out[k].numpy(), np.asarray(v), rtol=1e-6,
                                   err_msg=k)


# ---------------------------------------------------------------- layer
def _layer_pair(dispatch="sort", gate="topk", cf=0.5, seed=0):
    jcfg, tcfg = _cfg(gate, capacity_factor=cf, dispatch=dispatch)
    jlayer = jmoe.MoELayer(H, INTER, jcfg, ParallelStrategy())
    params = jlayer.init(jax.random.key(seed))
    tlayer = tmoe.MoELayer(H, INTER, tcfg)
    with torch.no_grad():
        for name, p in tlayer.named_parameters():
            p.copy_(_t(params[name]))
    return jlayer, params, tlayer


def _x(b=2, s=16, seed=7):
    return np.random.default_rng(seed).normal(size=(b, s, H)).astype(
        np.float32)


@pytest.mark.parametrize("dispatch", tmoe.DISPATCHES)
def test_layer_forward_and_gradients_match_the_reference(dispatch):
    """MoELayer under capacity pressure: the output and aux (1e-5), and
    the gradients of sum(y * w) + aux by the input, the router and both
    expert leaves (`jax.grad`, 1e-5)."""
    jlayer, params, tlayer = _layer_pair(dispatch)
    x = _x()
    w = np.random.default_rng(8).normal(size=x.shape).astype(np.float32)

    def jloss(p, xx):
        y, aux = jlayer(p, xx)
        return jnp.sum(y * w) + aux, (y, aux)
    (jl, (jy, jaux)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    for p in tlayer.parameters():
        p.requires_grad_(True)
    tx = _t(x).requires_grad_(True)
    ty, taux = tlayer(tx)
    (torch.sum(ty * _t(w)) + taux).backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               atol=1e-5)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), atol=1e-5)
    for name, p in tlayer.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgp[name]),
                                   atol=1e-5, err_msg=name)


def test_dense_dispatch_matches_sort():
    """The two dispatchers route alike under capacity pressure: the same
    output (1e-5) and aux, for every gate."""
    x = _t(_x(seed=9))
    for gate in tmoe.GATES:
        sort = _layer_pair("sort", gate)[2]
        dense = _layer_pair("dense", gate)[2]
        ys, auxs = sort(x)
        yd, auxd = dense(x)
        np.testing.assert_allclose(yd.numpy(), ys.numpy(), atol=1e-5,
                                   err_msg=gate)
        assert float(auxd) == float(auxs), gate


def test_router_stats_reach_the_moe_scope_and_gauges():
    """Under a numerics collector each layer's router stats fold into
    the "moe" scope; the record sets the moe.* gauges and counts the
    capacity drops."""
    _, _, tlayer = _layer_pair()
    with tnumerics.collecting() as col:
        tlayer(_t(_x()))
        stats = col.finalize()
    assert set(stats["moe"]) == {"load", "load_max", "entropy", "dropped",
                                 "drop_frac"}
    reg = MetricsRegistry()
    tnumerics.record(stats, step=1, registry=reg)
    loads = [reg.gauge_value("moe.expert_load", expert=str(i))
             for i in range(E)]
    np.testing.assert_allclose(sum(loads), 2.0, rtol=1e-6)   # ~ top_k
    assert reg.counter_value("moe.capacity_dropped") == \
        float(stats["moe"]["dropped"]) > 0


# ---------------------------------------------------------------- model
def _reference_params(jmodel, seed):
    """A params tree of the reference model's structure, drawn in numpy
    from `seed` by its init's law (weights normal(0, 0.02), norm gains
    1) without compiling its init."""
    rng = np.random.default_rng(seed)

    def leaf(path, sd):
        if "norm" in jax.tree_util.keystr(path):
            return jnp.ones(sd.shape, sd.dtype)
        return jnp.asarray(rng.normal(0.0, 0.02, sd.shape), sd.dtype)
    return jax.tree_util.tree_map_with_path(
        leaf, jax.eval_shape(jmodel.init, jax.random.key(0)))


def _moe_pair(seed=0, **kw):
    cfg = dict(MOE, moe_capacity_factor=0.5, **kw)
    jcfg = JLlamaConfig.tiny(remat=False, compute_dtype=jnp.float32,
                             use_flash_attention=False, **cfg)
    jmodel = JLlamaLMHeadModel(jcfg)
    jparams = _reference_params(jmodel, seed)
    tmodel = LlamaLMHeadModel(
        LlamaConfig.tiny(compute_dtype=torch.float32, **cfg), device="cpu")
    load_jax_params(tmodel, _np(jparams))
    return jmodel, jparams, tmodel


@pytest.fixture(scope="module")
def moe_pair():
    return _moe_pair()


def _ids_labels(vocab, seed=11, b=2, s=16):
    ids = np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)
    labels = ids.copy()
    labels[0, 2:5] = -100
    return ids, labels


@pytest.fixture(scope="module")
def reference_losses(moe_pair):
    """The reference's loss of one batch under each (reduction,
    include_aux), from one compiled program."""
    jmodel, jparams, _ = moe_pair
    ids, labels = _ids_labels(256)
    keys = [(r, a) for r in ("mean", "sum") for a in (True, False)]
    outs = jax.jit(lambda p, i, lb: [jmodel(
        p, i, lb, loss_reduction=r, include_aux_loss=a) for r, a in keys])(
        jparams, jnp.asarray(ids), jnp.asarray(labels))
    return dict(zip(keys, outs))


@pytest.mark.parametrize("reduction", ["mean", "sum"])
@pytest.mark.parametrize("include_aux", [True, False])
def test_model_loss_matches_the_reference(moe_pair, reference_losses,
                                          reduction, include_aux):
    """A 2-layer MoE Llama's loss with and without the router aux
    (1e-4): "sum" adds aux times the token count."""
    tmodel = moe_pair[2]
    ids, labels = _ids_labels(256)
    ref = reference_losses[reduction, include_aux]
    with torch.no_grad():
        out = tmodel(_t(ids), _t(labels), loss_reduction=reduction,
                     include_aux_loss=include_aux)
    if reduction == "sum":
        np.testing.assert_allclose(float(out[1]), float(ref[1]))
        out, ref = out[0], ref[0]
    np.testing.assert_allclose(float(out), float(ref), rtol=1e-4)


def test_model_config_takes_experts():
    """num_experts > 0 builds MoE blocks (no refusal), with the
    reference's parameter count; an unknown gate raises."""
    c = LlamaConfig.tiny(num_experts=8)
    jc = JLlamaConfig.tiny(num_experts=8)
    assert c.num_params() == jc.num_params()
    assert c.flops_per_token(128) == jc.flops_per_token(128)
    with pytest.raises(ValueError, match="gate='random'"):
        LlamaConfig.tiny(num_experts=8, moe_gate="random")


_TRAIN = dict(global_batch_size=4, micro_batch_size=2, seq_len=16,
              warmup_steps=1, total_steps=10, log_every=100, lr=1e-3)


def test_trainer_step_and_evaluate_match_the_reference():
    """One `Trainer` step of the MoE Llama (the aux in the summed loss)
    from the reference's params: loss and grad norm (1e-5), every
    parameter after AdamW (1e-5 absolute); `evaluate` leaves the aux
    out, as the reference's (1e-5)."""
    jcfg = JLlamaConfig.tiny(compute_dtype=jnp.float32,
                             use_flash_attention=False,
                             moe_capacity_factor=0.5, **MOE)
    jmodel = JLlamaLMHeadModel(jcfg)
    # the weights drawn in numpy, as the other tests' (no compiled init)
    params = _reference_params(jmodel, 1)
    jmodel.init = lambda rng, mesh=None: params
    jtr = JTrainer(jmodel, JTrainingConfig(**_TRAIN)).build()
    model = LlamaLMHeadModel(
        LlamaConfig.tiny(compute_dtype=torch.float32,
                         moe_capacity_factor=0.5, **MOE), device="cpu")
    load_jax_params(model, _np(jtr.params))
    tr = Trainer(model, TrainingConfig(**_TRAIN), device="cpu")
    ids, labels = _ids_labels(256, seed=12, b=4)
    batch = {"input_ids": ids, "labels": labels}
    jm, tm = jtr.train_step(batch), tr.train_step(batch)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    ref = LlamaLMHeadModel(model.config, device="cpu")
    load_jax_params(ref, _np(jtr.params))
    for (name, p), q in zip(model.named_parameters(), ref.parameters()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(),
                                   atol=1e-5, err_msg=name)
    ev = [{"input_ids": ids, "labels": labels}]
    np.testing.assert_allclose(tr.evaluate(ev)["loss"],
                               jtr.evaluate(ev)["loss"], rtol=1e-5)


# ------------------------------------------------------------ kept set
@pytest.fixture(scope="module")
def reference_params():
    """The reference MoE Llama's params (bf16 compute: the kept-set
    tests' dtypes); the remat policy does not change them."""
    return _reference_params(JLlamaLMHeadModel(JLlamaConfig.tiny(**MOE)), 0)


def _reference_kept(policy, params):
    jcfg = JLlamaConfig.tiny(remat_policy=policy, **MOE)
    jmodel = JLlamaLMHeadModel(jcfg)
    block = jmodel.model.layers.block
    lp = jax.tree.map(lambda a: a[0], params["model"]["layers"]["layers"])
    cos, sin = jops.build_rope_cache(jcfg.max_position_embeddings,
                                     jcfg.head_dim, jcfg.rope_theta,
                                     dtype=jnp.float32)
    x = jnp.ones((2, 16, jcfg.hidden_size), jcfg.compute_dtype)
    res = saved_residuals(
        jax.checkpoint(lambda lp, x: block(lp, x, cos=cos, sin=sin),
                       policy=jremat_policy(policy)), lp, x)
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


def _port_kept(policy):
    model = LlamaLMHeadModel(LlamaConfig.tiny(remat_policy=policy, **MOE),
                             device="cpu")
    for p in model.parameters():
        p.requires_grad_(True)
    b, s = 2, 16
    x = torch.ones((b, s, model.config.hidden_size),
                   dtype=model.config.compute_dtype, requires_grad=True)
    args = model.rope_at(b, s) + (None,)
    block = model.layers[0]
    outside = [x, *args[:2], *block.parameters()]
    kept = {}

    def pack(t):
        if not tremat._shares_storage(t, outside):
            kept[t.untyped_storage().data_ptr()] = \
                t.untyped_storage().nbytes()
        return t
    host0 = tremat.offloaded_bytes
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        if policy == "offload":
            with tremat.offloading(keep=outside):
                out, aux = block.forward_remat(x, *args, policy="dots")
        else:
            out, aux = block.forward_remat(x, *args, policy=policy)
    (out.float().sum() + aux).backward()
    return sum(kept.values()), tremat.offloaded_bytes - host0


@pytest.mark.parametrize("policy", tremat.REMAT_POLICIES)
def test_moe_block_keeps_the_reference_residuals(reference_params, policy):
    """The bytes an MoE block keeps for its backward under each policy
    equal `saved_residuals` of the reference's block: qkv, o (and the
    attention's output under "dots_attn") and the router logits — the
    experts' products carry the expert dim, which the policy does not
    save; under "offload" they sit on the host."""
    assert _port_kept(policy) == _reference_kept(policy, reference_params)


# -------------------------------------------------------------- serving
ENGINE = dict(num_slots=3, page_size=8, max_len=64, prefill_chunk=32)


def _trace(pkg, n=4, seed=2):
    """Four requests, all queued at time 0 for three slots.  The engines
    advance their clocks by the host's wall time, so staggered arrivals
    would batch differently on two engines of different speed; a dense
    model's rows do not see each other, but an MoE step's rows share
    capacity, so its tokens depend on which requests share the step."""
    return pkg.synthetic_requests(n, vocab_size=256, prompt_lens=(5, 40),
                                  max_new=(3, 6), arrivals=[0.0] * n,
                                  seed=seed)


@pytest.mark.parametrize("mode", ["gspmd", "int8", "int4", "ngram"])
def test_engine_emits_the_reference_engines_tokens(moe_pair, mode):
    """The serving engine on the MoE Llama (chunks of 32 under capacity
    pressure: pairs drop) emits the reference engine's greedy tokens with
    the experts as they are, resident in int8 and in int4, and with
    n-gram speculation (the verify step); the resident-bytes gauges are
    the reference's."""
    jmodel, jparams, tmodel = moe_pair
    kw = dict(ENGINE)
    if mode == "ngram":
        kw["spec_decode"] = "ngram"
    else:
        kw["moe_dispatch"] = mode
    jreg, treg = JMetricsRegistry(), MetricsRegistry()
    jeng = jserving.ServingEngine(jmodel, jparams,
                                  jserving.ServeConfig(**kw), registry=jreg)
    teng = tserving.ServingEngine(tmodel, tserving.ServeConfig(**kw),
                                  registry=treg, device="cpu")
    jres, tres = jeng.run(_trace(jserving)), teng.run(_trace(tserving))
    for t, j in zip(tres, jres):
        assert t.tokens == j.tokens, f"request {t.rid} diverged"
    for g in ("serve.moe_expert_bytes", "serve.moe_expert_bytes_fp"):
        assert treg.gauge_value(g) == jreg.gauge_value(g), g
    assert (teng.moe_store is None) == (mode in ("gspmd", "ngram"))


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_expert_tree_matches_the_reference(moe_pair, bits):
    """The resident store: payloads bit-equal to the reference's stacked
    leaves (the port's per-layer payloads in layer order; int4 in the
    reference's nibble layout), scales within 1 ulp, and the dequantized
    leaves and `expert_bytes` equal."""
    _, jparams, tmodel = moe_pair
    jq, jspec = jexperts.quantize_expert_tree(jparams, 4, bits=bits)
    store, spec = texperts.quantize_expert_tree(tmodel, bits=bits)
    jlayers = jq["model"]["layers"]["layers"]["mlp"]
    jdq = jexperts.dequantize_expert_tree(jq, jspec)["model"]["layers"][
        "layers"]["mlp"]
    tdq = texperts.dequantize_expert_tree(store, spec)
    L = tmodel.config.num_hidden_layers
    for k in texperts.EXPERT_KEYS:
        names = [f"model.layers.{i}.mlp.{k}" for i in range(L)]
        q = torch.cat([store[n]["q"] for n in names])
        s = torch.cat([store[n]["s"] for n in names])
        np.testing.assert_array_equal(q.numpy(), np.asarray(jlayers[k]["q"]))
        np.testing.assert_allclose(s.numpy(), np.asarray(jlayers[k]["s"]),
                                   rtol=1.2e-7, atol=0)
        np.testing.assert_array_equal(
            torch.stack([tdq[n] for n in names]).numpy(), np.asarray(jdq[k]))
    assert texperts.expert_bytes(spec) == pytest.approx(
        jexperts.expert_bytes(jspec))


def test_serve_config_takes_moe_dispatch(moe_pair):
    """moe_dispatch gspmd/fp32/int8/int4 are accepted (an invalid one
    raises ValueError); HETU_TORCH_MOE_DISPATCH feeds from_flags; the
    reshard hook is refused beside resident-quantized experts, as the
    reference's."""
    for mode in tserving.engine.MOE_DISPATCH:
        assert tserving.ServeConfig(moe_dispatch=mode).moe_dispatch == mode
    with pytest.raises(ValueError, match="moe_dispatch"):
        tserving.ServeConfig(moe_dispatch="int2")
    _, _, tmodel = moe_pair
    with pytest.raises(ValueError, match="reshard"):
        tserving.ServingEngine(
            tmodel, tserving.ServeConfig(moe_dispatch="int8", **ENGINE),
            device="cpu", reshard=object())


def test_moe_dispatch_flag_is_the_references(monkeypatch):
    """HETU_TORCH_MOE_DISPATCH has the reference flag's type, default and
    choices; every mode resolves to "gspmd" at one device, as the
    reference's does at ep=1; the explicit transport names its slice."""
    port = flags.REGISTRY["HETU_TORCH_MOE_DISPATCH"]
    ref = jflags.REGISTRY["HETU_TPU_MOE_DISPATCH"]
    assert (port.kind, port.default, port.choices) == (
        ref.kind, ref.default, ref.choices)
    assert tdispatch.MODES == port.choices
    for mode in tdispatch.MODES:
        monkeypatch.setenv("HETU_TORCH_MOE_DISPATCH", mode)
        assert tdispatch.dispatch_mode() == mode
        assert tdispatch.resolved_mode() == "gspmd"
        assert tserving.ServeConfig.from_flags().moe_dispatch == mode
    with pytest.raises(NotImplementedError, match="Queue A item 5"):
        tdispatch.explicit_forward()


def test_capacity_rebalancer_decisions_match_the_reference():
    """The same gauge sequence gives the same decisions (grow, shrink,
    none), factors and gauges on both sides; `apply` sets the factor of
    a MoEConfig."""
    sides = []
    for cls, reg in ((JRebalancer, JMetricsRegistry()),
                     (CapacityRebalancer, MetricsRegistry())):
        rb = cls(num_experts=4, top_k=2, capacity_factor=1.25,
                 registry=reg, strikes=2, headroom=1.1)
        out = [rb.observe()]
        for loads in ([1.6, 0.2, 0.1, 0.1],) * 2 + \
                ([0.5, 0.5, 0.5, 0.5],) * 2 + ([1.6, 0.2, 0.1, 0.1],
                                               [0.55, 0.5, 0.5, 0.45]):
            for i, v in enumerate(loads):
                reg.set_gauge("moe.expert_load", v, expert=str(i))
            out.append(rb.observe())
        sides.append(([None if d is None else dataclasses.astuple(d)
                       for d in out],
                      reg.gauge_value("moe.capacity_factor")))
    assert sides[0] == sides[1]
    assert any(d is not None for d in sides[1][0])
    assert apply(tmoe.MoEConfig(), 2.5).capacity_factor == 2.5
