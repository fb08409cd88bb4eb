"""LoRA fine-tuning of the port (`peft/`, `engine/sft_trainer.py`,
`utils/yaml_config.py`, `nn/initializers.py`, `models/from_jax.py`'s
LoRA carry-over) against the JAX reference, on the CPU.

What is held against what, on the same seeded inputs:

  * a tiny Llama and a tiny GPT: 3 `SFTTrainer` steps of LoRA SFT (rank
    4, every reference target) from the reference's own base weights
    and adapters, with the run log, health and numerics flags on at
    both sides: losses and grad norms within 1e-5 relative; every
    adapter element within the AdamW-direction bound the training tests
    use; the moments within 2^-6 of each leaf's largest entry; each
    step's numerics record scope for scope and stat for stat (model
    tolerance, 1e-4 relative, counts equal); the port's run log read by
    the reference's readers; the base's parameters bit for bit and with
    no gradient (one reference run per family, module-scoped);
  * the merge within 1e-6; a LoRA model from carried-over factors with
    B = 0 gives the base's output exactly, and with B != 0 the
    reference's wrapped model's within the model tolerance;
  * `mask_prompt_labels` bit for bit; `schedule_micro_batches` and
    `TaskQuotaPlanner` equal; `load_experiment`'s refusals and a dp = 1
    dict;
  * port only: the recompute policies give the adapters the same
    gradients bit for bit, a segment keeps W, A and B and never the
    merged weight, and the multi-task engine moves only the adapters of
    the task whose rows it ran.
"""
from __future__ import annotations

import functools
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hetu_tpu.engine import SFTTrainer as JSFTTrainer
from hetu_tpu.engine import TrainingConfig as JTrainingConfig
from hetu_tpu.engine import mask_prompt_labels as jmask_prompt_labels
from hetu_tpu.models.gpt import GPTConfig as JGPTConfig
from hetu_tpu.models.gpt import GPTLMHeadModel as JGPTLMHeadModel
from hetu_tpu.models.llama import LlamaConfig as JLlamaConfig
from hetu_tpu.models.llama import LlamaLMHeadModel as JLlamaLMHeadModel
from hetu_tpu.nn import initializers as jinit
from hetu_tpu.obs.numerics import summarize_numerics as jsummarize
from hetu_tpu.obs.runlog import RunLog as JRunLog
from hetu_tpu.peft import LoRAConfig as JLoRAConfig
from hetu_tpu.peft import LoRAWrappedModel as JLoRAWrappedModel
from hetu_tpu.peft import merge_lora_params as jmerge
from hetu_tpu.peft.multi_task import TaskQuotaPlanner as JTaskQuotaPlanner
from hetu_tpu.peft.multi_task import \
    schedule_micro_batches as jschedule_micro_batches
from hetu_tpu_torch.engine import SFTTrainer, TrainingConfig
from hetu_tpu_torch.engine import mask_prompt_labels
from hetu_tpu_torch.models.from_jax import load_jax_lora
from hetu_tpu_torch.models.gpt import GPTConfig, GPTLMHeadModel
from hetu_tpu_torch.models.llama import (LlamaConfig, LlamaLMHeadModel,
                                         load_jax_params)
from hetu_tpu_torch.nn import initializers as init
from hetu_tpu_torch.optim.optimizer import AdamW
from hetu_tpu_torch.peft import (LoRAConfig, LoRAWrappedModel,
                                 MultiLoRAManager, merge_lora_params)
from hetu_tpu_torch.peft.multi_task import (MultiTaskSFTEngine,
                                            TaskQuotaPlanner,
                                            schedule_micro_batches)
from hetu_tpu_torch.utils.yaml_config import load_experiment
from test_torch_parity import HD128, MODEL_TOL

FAMILIES = ("llama", "gpt")
HD64 = dict(hidden_size=256, num_attention_heads=4)
_TRAIN = dict(global_batch_size=4, micro_batch_size=2, seq_len=16,
              warmup_steps=1, total_steps=10, log_every=1, lr=1e-3)
_FLAGS = ("RUNLOG", "HEALTH", "NUMERICS")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_config(family, **kw):
    """The port's config at the tests' widths, fp32 compute unless `kw`
    says otherwise."""
    kw = dict(dict(compute_dtype=torch.float32), **kw)
    if family == "llama":
        return LlamaConfig.tiny(**HD128, **kw)
    return GPTConfig.tiny(**HD64, **kw)


def _configs(family, **kw):
    """(JAX config, port config) at the tests' widths, fp32 compute, the
    dense attention."""
    jcls, wide = ((JLlamaConfig, HD128) if family == "llama"
                  else (JGPTConfig, HD64))
    return (jcls.tiny(compute_dtype=jnp.float32, use_flash_attention=False,
                      **wide, **kw),
            _port_config(family, **kw))


@functools.lru_cache(maxsize=None)
def _jax_model(family):
    """The reference model of `family` and its params (drawn once a
    module: every test reads them, none writes)."""
    jcfg, _ = _configs(family)
    jcls = JLlamaLMHeadModel if family == "llama" else JGPTLMHeadModel
    jmodel = jcls(jcfg)
    return jmodel, jmodel.init(jax.random.key(0))


def _pair(family):
    """(JAX model, its params, a new port model on the CPU holding
    them)."""
    jmodel, jparams = _jax_model(family)
    _, tcfg = _configs(family)
    model = (LlamaLMHeadModel if family == "llama" else GPTLMHeadModel)(
        tcfg, device="cpu")
    load_jax_params(model, _np(jparams))
    return jmodel, jparams, model


def _sft_batches(vocab, n=3, seed=5):
    """Prompt-masked batches: prompts of 3-7 tokens, a padded tail."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(1, vocab, (4, 16)).astype(np.int32)
        ids[1, 12:] = 0
        ids[3, 10:] = 0
        prompts = rng.integers(3, 8, 4)
        out.append({"input_ids": ids,
                    "labels": mask_prompt_labels(ids, prompts)})
    return out


def _direction(m, v, step, opt):
    c1, c2 = 1.0 - opt.b1 ** step, 1.0 - opt.b2 ** step
    return (m / c1) / (torch.sqrt(v / c2) + opt.eps)


def _digest(model):
    h = hashlib.sha256()
    for _, p in sorted(model.named_parameters()):
        h.update(p.detach().numpy().tobytes())
    return h.hexdigest()


@pytest.fixture(scope="module", params=FAMILIES)
def sft_runs(request, tmp_path_factory):
    """One family's LoRA SFT, 3 steps, on the reference and on the port
    from the same base weights and adapters, every hook flag on at both
    sides (set here and restored: a module-scoped fixture cannot use
    monkeypatch)."""
    import os
    family = request.param
    d = tmp_path_factory.mktemp(f"sft_{family}")
    env = {f"HETU_TPU_{f}": "1" for f in _FLAGS[1:]}
    env.update({f"HETU_TORCH_{f}": "1" for f in _FLAGS[1:]})
    env.update(HETU_TPU_RUNLOG=str(d / "ref.jsonl"),
               HETU_TORCH_RUNLOG=str(d / "port.jsonl"))
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        jmodel, jparams, model = _pair(family)
        digest = _digest(model)
        jtr = JSFTTrainer(jmodel, JTrainingConfig(**_TRAIN),
                          lora=JLoRAConfig(rank=4), base_params=jparams)
        jtr.build()
        tr = SFTTrainer(model, TrainingConfig(**_TRAIN),
                        lora=LoRAConfig(rank=4), device="cpu")
        carried = load_jax_lora(model, _np(jtr.params))
        with torch.no_grad():
            for name, ab in tr.model.lora_params.items():
                for f in "AB":
                    ab[f].copy_(carried[name][f])
        tr.build()
        opt = tr.optimizer
        bound = [torch.zeros(p.shape) for p in tr.params]
        metrics = []
        for step, batch in enumerate(_sft_batches(model.config.vocab_size),
                                     1):
            jm, tm = jtr.train([batch]), tr.train([batch])
            metrics.append(({k: float(v) for k, v in tm.items()},
                            {k: float(v) for k, v in jm.items()
                             if k != "numerics"}))
            ref = load_jax_lora(model, _np(jtr.params))
            ref_m = load_jax_lora(model, _np(jtr.opt_state["m"]))
            ref_v = load_jax_lora(model, _np(jtr.opt_state["v"]))
            for i, (name, p, m, v) in enumerate(zip(
                    tr.names, tr.params, tr.opt_state["m"],
                    tr.opt_state["v"])):
                w, f = name[len("lora."):].rsplit("/", 1)
                key = next(n for n in ref if n.replace(".", "/") == w)
                u = _direction(m, v, step, opt)
                u_ref = _direction(ref_m[key][f], ref_v[key][f], step, opt)
                bound[i] += opt._lr(step) * ((u - u_ref).abs() + 2.0 ** -21 * (
                    u.abs() + u_ref.abs())) + 2.0 ** -21 * torch.maximum(
                        p.detach().abs(), ref[key][f].abs())
        jtr.close()
        tr.close()
        yield dict(family=family, jtr=jtr, tr=tr, model=model,
                   digest=digest, bound=bound, metrics=metrics,
                   ref_log=JRunLog.read(str(d / "ref.jsonl")),
                   port_log=JRunLog.read(str(d / "port.jsonl")))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def test_sft_losses_match_the_reference(sft_runs):
    for port, ref in sft_runs["metrics"]:
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(port[k], ref[k], rtol=1e-5, err_msg=k)
    losses = [p["loss"] for p, _ in sft_runs["metrics"]]
    assert all(np.isfinite(losses))


def test_sft_adapters_match_the_reference(sft_runs):
    """Every adapter element within the AdamW-direction bound (lr x
    what the two sides' directions m^ / (sqrt(v^) + eps) differ by, each
    with its fp32 rounding, summed over the steps), the moments within
    2^-6 of each leaf's largest entry; only adapters train."""
    tr, model, jtr = sft_runs["tr"], sft_runs["model"], sft_runs["jtr"]
    ref = {k: load_jax_lora(model, _np(t)) for k, t in (
        ("p", jtr.params), ("m", jtr.opt_state["m"]),
        ("v", jtr.opt_state["v"]))}
    assert all(n.startswith("lora.") for n in tr.names)
    assert len(tr.names) == 2 * len(ref["p"])
    for i, name in enumerate(tr.names):
        w, f = name[len("lora."):].rsplit("/", 1)
        key = next(n for n in ref["p"] if n.replace(".", "/") == w)
        d = (tr.params[i].detach() - ref["p"][key][f]).abs()
        assert bool((d <= sft_runs["bound"][i]).all()), name
        for k, mine in (("m", tr.opt_state["m"][i]),
                        ("v", tr.opt_state["v"][i])):
            scale = float(ref[k][key][f].abs().max())
            assert float((mine - ref[k][key][f]).abs().max()) <= \
                2.0 ** -6 * scale, (k, name)
    # the base: unchanged bit for bit, never a gradient
    assert _digest(model) == sft_runs["digest"]
    assert all(p.grad is None and not p.requires_grad
               for p in model.parameters())
    state = tr.state()
    assert set(state["params"]) == set(tr.names)
    assert tr.registry.counter_value("sft.loss_tokens") > 0
    assert tr.registry.counter_value("sft.masked_tokens") > 0


def test_sft_numerics_records_match_the_reference(sft_runs):
    """Each step's numerics record: the reference's scopes and stat
    names in its order (Llama's model taps embed / hidden / logits; GPT
    has none, as in the reference), every stat within the model
    tolerance, counts equal."""
    ref = [r for r in sft_runs["ref_log"] if r["kind"] == "numerics"]
    port = [r for r in sft_runs["port_log"] if r["kind"] == "numerics"]
    assert [r["step"] for r in port] == [r["step"] for r in ref] == [1, 2, 3]
    for p, r in zip(port, ref):
        assert p["numerics_schema"] == r["numerics_schema"]
        assert list(p["scopes"]) == list(r["scopes"])
        model_taps = {"embed", "hidden", "logits"} & set(r["scopes"])
        assert model_taps == ({"embed", "hidden", "logits"}
                              if sft_runs["family"] == "llama" else set())
        for scope, stats in r["scopes"].items():
            assert list(p["scopes"][scope]) == list(stats), scope
            for k, v in stats.items():
                mine = p["scopes"][scope][k]
                if k == "nonfinite":
                    assert mine == v
                else:
                    assert abs(mine - v) <= MODEL_TOL * abs(v) + 1e-12, \
                        (scope, k, mine, v)


def test_sft_run_log_reads_with_the_reference(sft_runs):
    """The port's records parse with the reference's reader: the same
    kinds in the same order (the reference adds its compile records),
    the same step fields and losses (read every step under health), and
    the reference's `summarize_numerics` gives the same scopes and
    ranking over both."""
    ref = [r for r in sft_runs["ref_log"] if r["kind"] != "compile"]
    port = sft_runs["port_log"]
    assert [r["kind"] for r in port] == [r["kind"] for r in ref]
    for p, r in zip(port, ref):
        if r["kind"] == "step":
            assert sorted(p) == sorted(r)
            np.testing.assert_allclose(p["loss"], r["loss"], rtol=1e-5)
    ps, rs = jsummarize(port), jsummarize(ref)
    assert (ps["records"], ps["steps"], ps["worst"]) == (
        rs["records"], rs["steps"], rs["worst"])


# ------------------------------------------------------------------ merge
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_merge_matches_the_reference(dtype):
    """merge_lora_params on the same W, A, B (the reference's adapters,
    B drawn non-zero, carried over): the targets merged in the base's
    dtype within 1e-6 (bf16: one bf16 ulp, where the two sides' fp32
    products round apart), the rest passed through bit for bit."""
    jmodel, jparams, model = _pair("llama")
    if dtype == "bfloat16":
        model = model.to(torch.bfloat16)
        jparams = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16),
                                         jparams)
    jlora = JLoRAWrappedModel(jmodel, jparams, JLoRAConfig(rank=4)).init(
        jax.random.key(1))
    jlora = jax.tree_util.tree_map(
        lambda a: a + 0.05 * jax.random.normal(jax.random.key(2), a.shape),
        jlora)
    lora = load_jax_lora(model, _np(jlora))
    port = merge_lora_params(model, lora, LoRAConfig(rank=4))
    ref = jax.jit(lambda p, a: jmerge(p, a, JLoRAConfig(rank=4)))(
        jparams, jlora)
    scratch = LlamaLMHeadModel(model.config, device="cpu")
    load_jax_params(scratch, _np(jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32), ref)))
    tol = 1e-6 if dtype == "float32" else 2.0 ** -8
    for name, w in scratch.named_parameters():
        mine, theirs = port[name].detach().float(), w.detach().float()
        assert port[name].dtype == model.get_parameter(name).dtype
        if name in lora:
            d = (mine - theirs).abs() / theirs.abs().clamp_min(1e-30)
            assert float(d.max()) <= tol, name
        else:
            assert torch.equal(mine, theirs), name


@pytest.mark.parametrize("family", FAMILIES)
def test_lora_from_carried_factors_starts_at_the_base(family):
    """The reference's adapters (B = 0) carried over: the wrapped port
    model's logits equal the base's bit for bit; with B drawn non-zero
    they are the reference's wrapped model's within the model
    tolerance."""
    jmodel, jparams, model = _pair(family)
    jw = JLoRAWrappedModel(jmodel, jparams, JLoRAConfig(rank=4))
    jlora = jw.init(jax.random.key(3))
    ids = np.random.default_rng(4).integers(0, model.config.vocab_size,
                                            (2, 16)).astype(np.int32)
    wrapped = LoRAWrappedModel(model, LoRAConfig(rank=4),
                               load_jax_lora(model, _np(jlora)))
    t_ids = torch.from_numpy(ids)
    with torch.no_grad():
        assert torch.equal(wrapped(t_ids), model(t_ids))
    jlora = jax.tree_util.tree_map(
        lambda a: a + 0.05 * jax.random.normal(jax.random.key(5), a.shape),
        jlora)
    wrapped = LoRAWrappedModel(model, LoRAConfig(rank=4),
                               load_jax_lora(model, _np(jlora)))
    with torch.no_grad():
        out = wrapped(t_ids).numpy()
    np.testing.assert_allclose(
        out, np.asarray(jax.jit(jw)(jlora, jnp.asarray(ids))),
        atol=MODEL_TOL)
    assert wrapped.num_trainable_params() == jw.num_trainable_params(jlora)


def test_load_jax_lora_refuses_what_does_not_fit():
    _, _, model = _pair("llama")
    w = model.model.layers[0].attn.o_proj.weight
    good = {"A": np.zeros((w.shape[0], 4), np.float32),
            "B": np.zeros((4, w.shape[1]), np.float32)}
    tree = {"model": {"layers": {"layer_0": {"attn": {"o_proj": {
        "weight": good}}}}}}
    assert list(load_jax_lora(model, tree)) == [
        "model.layers.0.attn.o_proj.weight"]
    for bad in ({"A": good["A"]}, {"A": good["A"], "B": good["B"].T},
                {"A": good["A"], "B": good["B"], "C": good["A"]}):
        tree["model"]["layers"]["layer_0"]["attn"]["o_proj"]["weight"] = bad
        with pytest.raises(ValueError):
            load_jax_lora(model, tree)
    with pytest.raises(ValueError, match="no weight"):
        load_jax_lora(model, {"lm_head2": good})


# -------------------------------------------------- recompute and memory
@pytest.mark.parametrize("policy", ["nothing", "dots", "dots_attn",
                                    "offload"])
@pytest.mark.parametrize("family", FAMILIES)
def test_policies_give_the_adapters_the_same_gradients(family, policy):
    """bf16 compute over a bf16 base: the adapters' gradients under each
    recompute policy equal those without recompute bit for bit (the
    in-segment merge is the merge before the forward), and the base
    gets none."""
    grads = {}
    for remat, pol in ((False, "dots"), (True, policy)):
        tcfg = _port_config(family, remat=remat, remat_policy=pol,
                            param_dtype=torch.bfloat16,
                            compute_dtype=torch.bfloat16)
        tcls = LlamaLMHeadModel if family == "llama" else GPTLMHeadModel
        model = tcls(tcfg, device="cpu", seed=2)
        wrapped = LoRAWrappedModel(model, LoRAConfig(rank=4), seed=3)
        gen = torch.Generator().manual_seed(4)
        with torch.no_grad():
            for p in wrapped.lora.values():
                p.normal_(0.0, 0.05, generator=gen)
        ids = torch.from_numpy(np.random.default_rng(6).integers(
            0, tcfg.vocab_size, (2, 16)).astype(np.int32))
        loss, _ = wrapped(ids, ids, loss_reduction="sum")
        loss.backward()
        grads[remat] = [p.grad.clone() for p in wrapped.lora.values()]
        assert all(p.grad is None for p in model.parameters())
    for a, b in zip(grads[False], grads[True]):
        assert torch.equal(a, b)


def test_segments_keep_the_factors_not_the_merged_weights():
    """Under "dots_attn" every tensor a Llama step keeps for its
    backward that has a block's target weight's shape is that (frozen)
    weight itself: no segment keeps a merged copy.  (The LM head's
    product, outside the blocks, keeps its merged head: one [hidden,
    vocab] matrix in the base's dtype.)"""
    tcfg = _port_config("llama", remat=True, remat_policy="dots_attn",
                        vocab_size=320)
    model = LlamaLMHeadModel(tcfg, device="cpu")
    wrapped = LoRAWrappedModel(model, LoRAConfig(rank=4))
    shapes = {tuple(p.shape): p for n, p in model.named_parameters()
              if n in wrapped.lora_params and n != "lm_head"}
    kept = []

    def pack(t):
        kept.append(t)
        return t

    ids = torch.zeros((2, 16), dtype=torch.int64)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        wrapped(ids, ids, loss_reduction="sum")
    heavy = [t for t in kept if tuple(t.shape) in shapes]
    assert heavy, "no weight-shaped tensor was kept"
    params = {p.untyped_storage().data_ptr() for p in model.parameters()}
    assert all(t.untyped_storage().data_ptr() in params for t in heavy)


# ------------------------------------------------------------ SFT pieces
@pytest.mark.parametrize("case", range(4))
def test_mask_prompt_labels_matches_the_reference(case):
    rng = np.random.default_rng(20 + case)
    ids = rng.integers(1, 50, (5, 24)).astype(np.int32)
    ids[1, 18:] = 0
    ids[2, 5:] = 0                   # the pad run starts inside the prompt
    ids[3, -1] = 0
    prompts = rng.integers(0, 12, 5)
    kw = [dict(), dict(seq_lens=rng.integers(8, 24, 5)), dict(pad_id=None),
          dict(pad_id=7)][case]
    np.testing.assert_array_equal(mask_prompt_labels(ids, prompts, **kw),
                                  jmask_prompt_labels(ids, prompts, **kw))


def test_sft_trainer_refuses_base_params():
    _, _, model = _pair("llama")
    with pytest.raises(TypeError, match="no counterpart"):
        SFTTrainer(model, TrainingConfig(), lora=LoRAConfig(),
                   base_params={}, device="cpu")
    with pytest.raises(NotImplementedError, match="item 5"):
        SFTTrainer(model, TrainingConfig(), object(), device="cpu")
    with pytest.raises(ValueError, match="no parameters matched"):
        SFTTrainer(model, TrainingConfig(), lora=LoRAConfig(targets=("x",)),
                   device="cpu")


def _samples(rng, n, lo, hi, vocab=200):
    return [rng.integers(1, vocab, int(rng.integers(lo, hi + 1))).astype(
        np.int32) for _ in range(n)]


@pytest.mark.parametrize("fuse", [True, False])
def test_schedule_micro_batches_matches_the_reference(fuse):
    rng = np.random.default_rng(31)
    tasks = {0: _samples(rng, 9, 5, 60), 1: _samples(rng, 5, 10, 30),
             2: _samples(rng, 3, 40, 64)}
    kw = dict(max_tokens=128, train_task_num=3, bucket_sizes=(16, 32, 64),
              pad_id=0, fuse_leftovers=fuse)
    mine, ref = schedule_micro_batches(tasks, **kw), \
        jschedule_micro_batches(tasks, **kw)
    assert len(mine) == len(ref)
    for a, b in zip(mine, ref):
        np.testing.assert_array_equal(a.data, b.data)
        np.testing.assert_array_equal(a.valid_lens, b.valid_lens)
        assert (a.batch_size, a.seq_length, a.batch_offset_list,
                a.batch_size_list) == (b.batch_size, b.seq_length,
                                       b.batch_offset_list, b.batch_size_list)
        for t in a.task_ids():
            np.testing.assert_array_equal(a.task_labels(t), b.task_labels(t))
    with pytest.raises(ValueError, match="exceeds the largest bucket"):
        schedule_micro_batches({0: _samples(rng, 1, 90, 90)}, **kw)


def test_task_quota_planner_matches_the_reference():
    for weights, backlog in (({0: 3.0, 1: 1.0}, {0: 1000, 1: 1000}),
                             ({0: 3.0, 1: 1.0}, {0: 50, 1: 1000}),
                             ({0: 1.0, 1: 1.0, 2: 5.0}, {0: 7, 1: 0, 2: 3}),
                             ({}, {0: 1, 1: 1, 2: 1})):
        mine = TaskQuotaPlanner(weights, 400).plan(backlog)
        assert mine == JTaskQuotaPlanner(weights, 400).plan(backlog)


def test_multi_task_engine_moves_only_the_task_it_ran():
    """Two tasks over one base: a micro with only task 0's rows changes
    task 0's adapters and leaves task 1's bit for bit; a fused micro
    trains both; the losses fall."""
    tcfg = _port_config("llama", remat=False)
    model = LlamaLMHeadModel(tcfg, device="cpu")
    mgr = MultiLoRAManager(model, LoRAConfig(rank=4), ["a", "b"], seed=1)
    assert not torch.equal(mgr.parameters("a")[0], mgr.parameters("b")[0])
    eng = MultiTaskSFTEngine(mgr, AdamW(lr=1e-2, device="cpu"))
    rng = np.random.default_rng(2)
    micros = schedule_micro_batches(
        {0: _samples(rng, 6, 20, 30), 1: _samples(rng, 2, 20, 30)},
        max_tokens=32 * 4, train_task_num=2, bucket_sizes=(32,))
    only_a = next(m for m in micros if m.task_ids() == [0])
    fused = next(m for m in micros if m.task_ids() == [0, 1])
    before = {t: [p.clone() for p in mgr.parameters(t)] for t in "ab"}
    eng.train_micro(only_a)
    assert all(torch.equal(x, y) for x, y in zip(before["b"],
                                                 mgr.parameters("b")))
    assert not all(torch.equal(x, y) for x, y in zip(before["a"],
                                                     mgr.parameters("a")))
    hist = eng.train([fused] * 6)
    assert hist[0][-1] < hist[0][0] and hist[1][-1] < hist[1][0]
    assert all(p.grad is None for p in model.parameters())
    grouped = MultiLoRAManager.schedule([("a", 1), ("b", 2), ("a", 3)])
    assert grouped == {"a": [1, 3], "b": [2]}
    ids = torch.from_numpy(only_a.task_inputs(0))
    loss, grads = mgr.loss_and_grads(
        "b", lambda ad: mgr.forward("b", ids, ids, loss_reduction="sum")[0])
    assert set(grads) == set(mgr.adapters["b"]) and float(loss.detach()) > 0
    assert any(float(g["B"].abs().sum()) > 0 for g in grads.values())
    assert all(p.grad is None for p in mgr.parameters("a"))


# ------------------------------------------------------ YAML, initializers
def test_load_experiment_refuses_multi_gpu_and_builds_dp1():
    """The reference's example (dp 2, tp 2, ZeRO) names the multi-GPU
    slice; an rpc section the control-plane slice; unknown keys raise
    ValueError; a dp = 1 dict builds the port model on the device asked
    for."""
    with pytest.raises(NotImplementedError, match="Queue A item 5"):
        load_experiment("examples/config/pretrain_tiny_dp2tp2.yaml",
                        device="cpu")
    with pytest.raises(NotImplementedError, match="Queue A item 5"):
        load_experiment({"parallel": {"dp": 1, "zero_stage": 1}},
                        device="cpu")
    with pytest.raises(NotImplementedError, match="Queue A item 6"):
        load_experiment({"rpc": {"server": "localhost:1"}}, device="cpu")
    for bad in ({"parallel": {"bogus": 1}},
                {"trainer": {"learning_rate": 1e-3}}):
        with pytest.raises(ValueError):
            load_experiment(bad, device="cpu")
    model, tc, strategy, raw = load_experiment({
        "parallel": {"dp": 1, "tp": 1, "sequence_parallel": False},
        "model": {"family": "llama", "preset": "tiny",
                  "overrides": {"vocab_size": 512}},
        "trainer": {"global_batch_size": 16, "seq_len": 128, "lr": 1e-3}},
        device="cpu")
    assert isinstance(model, LlamaLMHeadModel) and strategy is None
    assert model.config.vocab_size == 512 and model.device.type == "cpu"
    assert tc.global_batch_size == 16 and tc.lr == 1e-3
    gpt, *_ = load_experiment({"model": {"family": "gpt",
                                         "preset": "tiny"}}, device="cpu")
    assert isinstance(gpt, GPTLMHeadModel)


_INITS = [("zeros", None), ("ones", None), ("constant", (0.5,)),
          ("normal", (0.02,)), ("truncated_normal", (0.02,)),
          ("uniform", (0.05,)), ("xavier_uniform", (1.0,)),
          ("xavier_normal", (1.0,)), ("he_uniform", ()), ("he_normal", ())]


@pytest.mark.parametrize("name,args", _INITS)
def test_initializers_match_the_reference(name, args):
    """Each initializer's shape, dtype and law: constants equal; random
    draws within the reference's support and with its spread (6 sigma of
    the sample's own error) over a [3, 3, 64, 96] kernel (fans with a
    receptive field)."""
    shape = (3, 3, 64, 96)
    fn, jfn = getattr(init, name), getattr(jinit, name)
    if args is not None:
        fn, jfn = fn(*args), jfn(*args)
    gen = torch.Generator().manual_seed(0)
    mine = fn(shape, torch.bfloat16, gen, "cpu")
    ref = np.asarray(jfn(jax.random.key(0), shape, jnp.float32))
    assert mine.shape == shape and mine.dtype == torch.bfloat16
    mine = mine.float().numpy()
    if args is None or name == "constant":
        np.testing.assert_array_equal(mine, ref)
        return
    assert np.abs(mine).max() <= np.abs(ref).max() * 1.05 + 1e-6 or \
        name in ("normal", "xavier_normal", "he_normal")
    n = mine.size
    assert abs(mine.mean() - ref.mean()) <= 6 * ref.std() / np.sqrt(n) * 2
    assert abs(mine.std() / ref.std() - 1.0) <= 6 / np.sqrt(n) + 2 ** -8
