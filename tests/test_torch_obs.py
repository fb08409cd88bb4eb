"""The port's observability hooks against the JAX reference, on the CPU:
the flags (`utils/flags.py`), the numerics observatory
(`obs/numerics.py`), the health monitors (`obs/health.py`), the run log
(`obs/runlog.py`) and the `Trainer`'s use of them.

What is held against what, on the same seeded numpy inputs:

  * `tree_stats` on the same trees: each stat within 1e-6 relative of
    the reference's, counts equal; `reduce_stacked`, the quantization
    SNR taps, `record` and `summarize_numerics` likewise;
  * the three health monitors fed one synthetic series each: the same
    anomalies at the same steps, the same counters;
  * a port run log (rotated into segments) read back by the reference's
    `RunLog` readers and summarised by its `summarize_numerics`;
  * the flags' defaults and parse errors, the reference's;
  * the trainer port-only: a tap inside a recompute segment is
    recorded once and counted as skipped, the flags unset leave a step's
    results bit for bit, the emergency save and the checkpoint faults.

The LoRA SFT runs with every hook on, against the reference's, are in
tests/test_torch_lora.py.
"""
from __future__ import annotations

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hetu_tpu.obs import health as jhealth
from hetu_tpu.obs import numerics as jnumerics
from hetu_tpu.obs.metrics import MetricsRegistry as JRegistry
from hetu_tpu.obs.runlog import RunLog as JRunLog
from hetu_tpu.utils import flags as jflags
from hetu_tpu_torch.engine import Trainer, TrainingConfig
from hetu_tpu_torch.models.llama import LlamaConfig, LlamaLMHeadModel
from hetu_tpu_torch.nn.remat import recompute
from hetu_tpu_torch.obs import health, numerics
from hetu_tpu_torch.obs.metrics import MetricsRegistry
from hetu_tpu_torch.obs.runlog import (REQUIRED_FIELDS, SCHEMA_VERSION,
                                       RunLog, default_runlog_path)
from hetu_tpu_torch.utils import flags

STAT_RTOL = 1e-6
COUNTS = ("nonfinite",)


def _special(seed, n=4096, dtype=np.float32):
    """Normal values with the tails the stats count: zeros, values in the
    16-bit underflow band, overflows of bf16/fp16, inf and nan."""
    x = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    x[:40] = 0.0
    x[40:80] = 1e-37            # below bf16's tiny x 256
    x[80:90] = 5e-6             # below fp16's tiny x 4, above bf16's band
    x[90:95] = 1e5              # past fp16's max
    x[95] = np.inf
    x[96] = -np.inf
    x[97] = np.nan
    return x.astype(dtype)


#: trees of numpy leaves: (name, tree, leaf dtype)
TREES = {
    "fp32": lambda: {"a": _special(1), "b": [_special(2, 300)]},
    "bf16": lambda: {"a": _special(3)},
    "fp16": lambda: {"a": _special(4, dtype=np.float16)},
    "mixed": lambda: {"w": _special(5), "h": _special(6, 512),
                      "g": np.random.default_rng(7).standard_normal(
                          (8, 16)).astype(np.float32)},
    "finite": lambda: {"p": np.random.default_rng(8).standard_normal(
        (64, 32)).astype(np.float32) * 1e-3},
}


def _to_torch(tree, bf16=False):
    if isinstance(tree, dict):
        return {k: _to_torch(v, bf16) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v, bf16) for v in tree]
    t = torch.from_numpy(np.array(tree))
    return t.to(torch.bfloat16) if bf16 else t


def _to_jax(tree, bf16=False):
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.bfloat16 if bf16 else a.dtype), tree)


def _close(port, ref, rtol=STAT_RTOL, where=""):
    """Stat dicts equal key for key: counts exactly, floats within rtol
    (nan and inf as they are)."""
    assert sorted(port) == sorted(ref), where
    for k, r in ref.items():
        p, r = float(port[k]), float(np.asarray(r))
        if k in COUNTS or not math.isfinite(r):
            assert p == r or (math.isnan(p) and math.isnan(r)), (where, k)
        else:
            assert abs(p - r) <= rtol * abs(r) + 1e-30, (where, k, p, r)


# ------------------------------------------------------------------ flags
@pytest.mark.parametrize("name,kind,default", [
    ("RUNLOG", "str", ""), ("RUNLOG_MAX_MB", "int", 0),
    ("HEALTH", "bool", False), ("NUMERICS", "bool", False),
    ("NUMERICS_EVERY", "int", 1)])
def test_flags_are_the_references_under_the_port_prefix(monkeypatch, name,
                                                        kind, default):
    """Each flag has the reference's type and default; the same raw
    value parses alike or raises alike (an unknown name: KeyError)."""
    port, ref = flags.REGISTRY[f"HETU_TORCH_{name}"], \
        jflags.REGISTRY[f"HETU_TPU_{name}"]
    assert (port.kind, port.default) == (ref.kind, ref.default) == (
        kind, default)
    read = {"bool": "bool_flag", "str": "str_flag", "int": "int_flag"}[kind]
    for raw in ("1", "yes", "off", "", "7", "x", None):
        for prefix, mod in (("HETU_TORCH_", flags), ("HETU_TPU_", jflags)):
            if raw is None:
                monkeypatch.delenv(prefix + name, raising=False)
            else:
                monkeypatch.setenv(prefix + name, raw)
        outs = []
        for prefix, mod in (("HETU_TORCH_", flags), ("HETU_TPU_", jflags)):
            try:
                outs.append(getattr(mod, read)(prefix + name))
            except ValueError as e:
                outs.append(type(e))
        assert outs[0] == outs[1], (raw, outs)
    with pytest.raises(KeyError):
        flags.bool_flag("HETU_TORCH_NOT_A_FLAG")


# ------------------------------------------------------------- the stats
@pytest.mark.parametrize("tree", sorted(TREES))
def test_tree_stats_match_the_reference(tree):
    host = TREES[tree]()
    bf16 = tree == "bf16"
    port = numerics.tree_stats(_to_torch(host, bf16))
    ref = jax.device_get(jax.jit(jnumerics.tree_stats)(_to_jax(host, bf16)))
    _close(port, ref, where=tree)
    assert numerics.tree_stats({"ids": torch.arange(3)}) == {} == \
        jnumerics.tree_stats({"ids": jnp.arange(3)})


def test_reductions_and_snr_match_the_reference():
    """`reduce_stacked` by each stat's rule over stacked per-micro
    stats, `rule_for`, and the SNR the quantization taps accumulate (the
    same signal and residual) as the collector finalizes it."""
    rng = np.random.default_rng(11)
    stacked = {"embed": {k: rng.standard_normal(4).astype(np.float32)
                         for k in ("absmax", "rms", "l2", "underflow_frac")},
               "moe": {"nonfinite": rng.integers(0, 5, 4).astype(np.int32),
                       "load": rng.random((4, 3)).astype(np.float32)}}
    port = numerics.reduce_stacked(_to_torch(stacked))
    ref = jax.device_get(jnumerics.reduce_stacked(_to_jax(stacked)))
    for scope in ref:
        for k, r in ref[scope].items():
            np.testing.assert_allclose(port[scope][k].numpy(), r, rtol=1e-6)
    for name in ("absmax", "load_max", "nonfinite", "err_pow", "rms", "x"):
        assert numerics.rule_for(name) == jnumerics.rule_for(name)
    sig = rng.standard_normal(1024).astype(np.float32)
    err = (rng.standard_normal(1024) * 1e-2).astype(np.float32)
    with numerics.collecting() as col:
        numerics.tap_quant_error("grad_sync/a2a", torch.from_numpy(sig),
                                 torch.from_numpy(err))
        port = col.finalize()
    with jnumerics.collecting() as jcol:
        jnumerics.tap_quant_error("grad_sync/a2a", jnp.asarray(sig),
                                  jnp.asarray(err))
        ref = jax.device_get(jcol.finalize())
    _close(port["grad_sync/a2a"], ref["grad_sync/a2a"], rtol=1e-5)


def test_quant_roundtrip_tap_matches_the_reference():
    """`tap_quant_roundtrip` re-runs the blockwise quantize (the port's
    kernel's plain version; the reference's compress path) on a buffer
    off the block: the same powers and SNR, int8 and int4."""
    x = np.random.default_rng(12).standard_normal(1000).astype(np.float32)
    for mode in ("int8", "int4"):
        with numerics.collecting() as col:
            numerics.tap_quant_roundtrip("sp/ag", torch.from_numpy(x), mode)
            port = col.finalize()
        with jnumerics.collecting() as jcol:
            jnumerics.tap_quant_roundtrip("sp/ag", jnp.asarray(x), mode)
            ref = jax.device_get(jcol.finalize())
        _close(port["sp/ag"], ref["sp/ag"], rtol=1e-5, where=mode)


def _scopes(seed):
    """A step's stats tree: tensor scopes from `tree_stats`, a scaler
    scope, a MoE scope with vectors."""
    host = {"params": TREES["finite"](), "grads": TREES["mixed"]()}
    out = {k: {n: np.asarray(v) for n, v in jax.device_get(
        jax.jit(jnumerics.tree_stats)(_to_jax(t))).items()}
        for k, t in host.items()}
    rng = np.random.default_rng(seed)
    out["scaler"] = {"scale": np.float32(65536.0)}
    out["moe"] = {"load": rng.random(4).astype(np.float32),
                  "load_max": np.float32(0.4), "entropy": np.float32(1.2),
                  "dropped": np.int32(3)}
    return out


def test_record_and_summary_match_the_reference(tmp_path):
    """`record` writes the same record and gauges as the reference's for
    the same stats (tensors on the port's side), and the reference's
    `summarize_numerics` over the port's records equals the port's and
    its own over its records."""
    port_log, ref_log = (RunLog(str(tmp_path / "port.jsonl")),
                         JRunLog(str(tmp_path / "ref.jsonl")))
    reg, jreg = MetricsRegistry(), JRegistry()
    for step in (1, 2, 3):
        host = _scopes(step)
        rec = numerics.record(_to_torch(host), step=step, registry=reg,
                              runlog=port_log)
        jrec = jnumerics.record(host, step=step, registry=jreg,
                                runlog=ref_log)
        assert list(rec["scopes"]) == list(jrec["scopes"])
        for scope in jrec["scopes"]:
            assert list(rec["scopes"][scope]) == list(jrec["scopes"][scope])
            for k, v in jrec["scopes"][scope].items():
                np.testing.assert_allclose(rec["scopes"][scope][k], v,
                                           rtol=1e-6, err_msg=k)
    port_log.close()
    ref_log.close()
    assert reg.snapshot() == jreg.snapshot()
    port_recs = JRunLog.read(str(tmp_path / "port.jsonl"))
    ref_recs = JRunLog.read(str(tmp_path / "ref.jsonl"))
    assert (jnumerics.summarize_numerics(port_recs)
            == numerics.summarize_numerics(port_recs)
            == jnumerics.summarize_numerics(ref_recs))
    assert numerics.record({}, step=1, registry=reg) is None


# ---------------------------------------------------------------- health
def _series(n=60, seed=0):
    rng = np.random.default_rng(seed)
    loss = 3.0 + 0.05 * rng.standard_normal(n)
    grad = 1.0 + 0.1 * rng.standard_normal(n)
    step_t = 0.5 + 0.01 * rng.standard_normal(n)
    loss[20], grad[25], step_t[30] = 9.0, 40.0, 2.5
    loss[40], grad[45] = np.nan, np.inf
    gaps = np.full(n, 0.55)
    gaps[50] = 8.0                             # the data pipeline stalls
    return loss, grad, step_t, np.cumsum(gaps)


def _fired(monitor_cls, feed, **kw):
    reg = (MetricsRegistry() if monitor_cls.__module__.startswith(
        "hetu_tpu_torch") else JRegistry())
    saves = []
    mon = monitor_cls(registry=reg, **kw)
    if hasattr(mon, "emergency_hook") and "emergency_kinds" in kw:
        mon.emergency_hook = lambda: saves.append(1)
    fired = [(f["anomaly"], f["step"]) for f in feed(mon)]
    counters = {c["name"]: c["value"] for c in reg.snapshot()["counters"]}
    return fired, counters, len(saves)


def _feed_training(mon):
    loss, grad, step_t, t = _series()
    return [f for i in range(len(loss)) for f in mon.observe_step(
        i, float(step_t[i]), loss=float(loss[i]),
        grad_norm=float(grad[i]), t=float(t[i]))]


def _feed_numerics(mon):
    out = []
    for i in range(30):
        uf = 0.6 if i == 20 else 0.01
        snr = 3.0 if i == 22 else 40.0 + (i % 3)
        out += mon.observe(i, {
            "grads": {"underflow_frac": uf},
            "grad_sync/a2a": {"snr_db": snr},
            "ef": {"rms": 5.0 if i == 24 else 0.01 * (1 + i % 2)},
            "moe": {"load_max": 0.95 if i in (26, 27) else 0.25,
                    "load": [0.25] * 4, "entropy": 1.3}}, t=float(i))
    return out


def _feed_serving(mon):
    out = []
    for i in range(40):
        out += mon.observe_ttft(5.0 if i == 15 else 0.2 + 0.01 * (i % 3),
                                step=i, t=float(i))
        out += mon.observe_step(i, queue_depth=60 if i == 25 else 3,
                                page_util=0.99 if 30 <= i < 36 else 0.5,
                                t=float(i))
    out += mon.note_brownout(39, shed=4, page_util=0.97, t=40.0)
    return out


@pytest.mark.parametrize("monitor,feed,kw", [
    ("HealthMonitor", _feed_training,
     dict(emergency_kinds=("nan_loss", "nan_grad"), cooldown_steps=2)),
    ("NumericsHealthMonitor", _feed_numerics, dict(warmup=4,
                                                   cooldown_steps=1)),
    ("ServingHealthMonitor", _feed_serving, dict(cooldown_steps=1))])
def test_health_monitors_fire_as_the_reference(monitor, feed, kw):
    """One synthetic series through the port's monitor and the
    reference's: the same anomalies at the same steps, the same health.*
    counters and emergency saves — and each series fires."""
    port = _fired(getattr(health, monitor), feed, **kw)
    ref = _fired(getattr(jhealth, monitor), feed, **kw)
    assert port == ref
    assert port[0], "the series fired nothing"


def test_health_gate_is_the_flag(monkeypatch):
    monkeypatch.delenv("HETU_TORCH_HEALTH", raising=False)
    assert health.maybe_health_monitor() is None
    assert health.maybe_numerics_health_monitor() is None
    assert health.maybe_serving_health_monitor() is None
    monkeypatch.setenv("HETU_TORCH_HEALTH", "1")
    assert isinstance(health.maybe_health_monitor(), health.HealthMonitor)
    assert isinstance(health.maybe_serving_health_monitor(),
                      health.ServingHealthMonitor)


# --------------------------------------------------------------- run log
def test_port_runlog_reads_with_the_reference(tmp_path):
    """A port log rotated into segments (a 1 KiB cap): the reference's
    `RunLog.segments`, `read` and `iter_records` follow the chain in
    order, every record carries the schema fields, a torn tail is
    skipped, and the reference's `summarize_numerics` reads the port's
    numerics records."""
    path = str(tmp_path / "run" / "runlog.jsonl")
    log = RunLog(path, max_bytes=1024)
    reg = MetricsRegistry()
    for step in range(1, 13):
        log.step(step, 0.25, loss=np.float32(2.5), tokens_per_s=1e4,
                 device_mem_bytes=np.int64(123), plan="single|ids:8x128")
        numerics.record(_to_torch(_scopes(step)), step=step, registry=reg,
                        runlog=log)
    log.log("scaler", event="backoff", scale=32768.0, prev=65536.0, step=4)
    log.close()
    with open(path, "a") as f:
        f.write('{"schema": 1, "kind": "st')
    assert log.rotations >= 2
    assert JRunLog.segments(path) == RunLog.segments(path)
    recs = JRunLog.read(path)
    assert recs == list(RunLog.iter_records(path))
    kinds = [r["kind"] for r in recs]
    assert kinds.count("step") == kinds.count("numerics") == 12
    assert kinds.count("rotated") == log.rotations
    assert all(r["schema"] == SCHEMA_VERSION and all(
        f in r for f in REQUIRED_FIELDS) for r in recs)
    steps = [r["step"] for r in recs if r["kind"] == "step"]
    assert steps == list(range(1, 13))
    summary = jnumerics.summarize_numerics(recs)
    assert summary["records"] == 12 and summary["steps"] == [1, 12]
    assert summary["worst"][0] == "grads"       # its nonfinite values


def test_default_runlog_path(monkeypatch, tmp_path):
    monkeypatch.delenv("HETU_TORCH_RUNLOG", raising=False)
    assert default_runlog_path(None) is None
    assert default_runlog_path("gs://bucket/ck") is None
    assert default_runlog_path(str(tmp_path)) == str(tmp_path /
                                                     "runlog.jsonl")
    monkeypatch.setenv("HETU_TORCH_RUNLOG", str(tmp_path / "x.jsonl"))
    assert default_runlog_path(str(tmp_path)) == str(tmp_path / "x.jsonl")


def test_runlog_write_failure_disables_not_raises(tmp_path):
    path = str(tmp_path / "runlog.jsonl")
    log = RunLog(path)
    log.step(1, 0.1)

    class FullDisk:
        closed = False

        def write(self, _):
            raise OSError(28, "No space left on device")

        def close(self):
            self.closed = True

    log._f.close()
    log._f = FullDisk()
    log.step(2, 0.1)
    log.step(3, 0.1)
    log.close()
    assert [r["step"] for r in JRunLog.read(path)] == [1]


# ------------------------------------------------------- trainer, port only
def test_a_tap_inside_a_recompute_is_skipped_not_recorded_twice():
    """A tap in a segment's forward is taken once; the segment runs the
    same forward again in the backward, where the tap is skipped and
    counted."""
    x = torch.randn(4, 8, requires_grad=True)
    w = torch.randn(8, 3, requires_grad=True)

    def pre(t):
        numerics.tap_tree("inner", t)
        return t * 2.0

    with numerics.collecting() as col:
        recompute(pre, x, weight=w).sum().backward()
        stats = col.finalize()
    assert col.skipped == len(stats["inner"]) == 6
    _close(stats["inner"], numerics.tree_stats(x))


_TINY = dict(hidden_size=64, num_attention_heads=2, num_key_value_heads=1,
             intermediate_size=128, vocab_size=128, num_hidden_layers=2,
             compute_dtype=torch.float32)
_TRAIN = dict(global_batch_size=4, micro_batch_size=2, seq_len=16,
              warmup_steps=1, total_steps=10, log_every=2, lr=1e-3)


def _batches(n=3, seed=0, vocab=128):
    rng = np.random.default_rng(seed)
    return [{"input_ids": ids, "labels": ids.copy()} for ids in
            (rng.integers(0, vocab, (4, 16)).astype(np.int32)
             for _ in range(n))]


def _run(monkeypatch, tmp_path, on: bool, **train):
    for name in ("HEALTH", "NUMERICS"):
        if on:
            monkeypatch.setenv(f"HETU_TORCH_{name}", "1")
        else:
            monkeypatch.delenv(f"HETU_TORCH_{name}", raising=False)
    if on:
        monkeypatch.setenv("HETU_TORCH_RUNLOG", str(tmp_path / "r.jsonl"))
    else:
        monkeypatch.delenv("HETU_TORCH_RUNLOG", raising=False)
    model = LlamaLMHeadModel(LlamaConfig.tiny(**_TINY), device="cpu")
    tr = Trainer(model, TrainingConfig(**dict(_TRAIN, **train)),
                 device="cpu")
    losses = [float(tr.train([b])["loss"]) for b in _batches()]
    tr.close()
    return tr, losses


@pytest.mark.parametrize("loss_scale", ["none", "dynamic"])
def test_hooks_observe_and_leave_the_step_as_it_was(monkeypatch, tmp_path,
                                                    loss_scale):
    """The same three steps with every flag unset and with the run log,
    health and numerics on: losses and parameters bit for bit (the
    hooks only read); with them on, a step record a step (loss read
    every step under health), a numerics record a step with the
    reference's scopes for a Llama step, a summary at the end; unset,
    no collector, no log."""
    off, off_losses = _run(monkeypatch, tmp_path, False,
                           loss_scale=loss_scale)
    on, on_losses = _run(monkeypatch, tmp_path, True, loss_scale=loss_scale)
    assert off_losses == on_losses
    for a, b in zip(off.params, on.params):
        assert torch.equal(a, b)
    assert off.run_log is None and not off._numerics and off._health is None
    recs = JRunLog.read(str(tmp_path / "r.jsonl"))
    kinds = [r["kind"] for r in recs]
    assert kinds.count("step") == kinds.count("numerics") == 3
    assert kinds[-1] == "summary"
    assert [r["loss"] for r in recs if r["kind"] == "step"] == on_losses
    scopes = {"embed", "hidden", "logits", "params", "grads", "update",
              "adam_m"} | ({"scaler"} if loss_scale == "dynamic" else set())
    for r in recs:
        if r["kind"] == "numerics":
            assert set(r["scopes"]) == scopes
            assert list(r["scopes"]["params"]) == sorted(
                ["absmax", "rms", "l2", "nonfinite", "underflow_frac",
                 "overflow_frac"])
    assert on.registry.counter_value("numerics.records") == 3


def test_update_stats_taken_in_groups_equal_a_whole_snapshot(monkeypatch):
    """AdamW's "update" stats, taken a group of leaves at a time (the
    kernel updates in place), equal the stats of new - old over a full
    copy; the groups cut at the byte budget, a larger leaf alone, one
    AdamW call a group."""
    from hetu_tpu_torch.optim import optimizer as toptim
    launched = []
    update = toptim.adam_update_multi
    monkeypatch.setattr(toptim, "adam_update_multi", lambda p, *a, **k: (
        launched.append(len(p)), update(p, *a, **k)))
    assert toptim.snapshot_groups(
        [torch.empty(n) for n in (10, 10, 30, 5, 5)], budget=80) == [
            [0, 1], [2], [3, 4]]
    g = torch.Generator().manual_seed(3)
    params = [torch.randn(n, generator=g) for n in (300, 1000, 70)]
    grads = [torch.randn(p.shape, generator=g) for p in params]
    opt = toptim.AdamW(lr=1e-2, weight_decay=0.1, device="cpu")
    state = opt.init(params)
    old = [p.clone() for p in params]
    budget, toptim.SNAPSHOT_BYTES = toptim.SNAPSHOT_BYTES, 4 * 1100
    try:
        with numerics.collecting() as col:
            opt.update(grads, state, params)
            stats = col.finalize()
    finally:
        toptim.SNAPSHOT_BYTES = budget
    assert launched == [1, 2]           # 1,200 bytes, then 4,000 + 280
    _close(stats["update"], numerics.tree_stats(
        [p - o for p, o in zip(params, old)]))
    _close(stats["adam_m"], numerics.tree_stats(state["m"]))


def test_emergency_save_and_checkpoint_faults(monkeypatch, tmp_path):
    """Under HETU_TORCH_HEALTH a non-finite grad norm fires nan_grad and
    saves a checkpoint at once; a corrupt checkpoint walked past by
    `restore_latest_valid` leaves a `fault` record."""
    monkeypatch.setenv("HETU_TORCH_HEALTH", "1")
    monkeypatch.delenv("HETU_TORCH_RUNLOG", raising=False)
    ckpt = str(tmp_path / "ck")
    model = LlamaLMHeadModel(LlamaConfig.tiny(**_TINY), device="cpu")
    tr = Trainer(model, TrainingConfig(**dict(_TRAIN, ckpt_dir=ckpt,
                                              ckpt_every=1000)),
                 device="cpu")
    tr.train(_batches(1))
    tr._health.observe_step(2, 0.1, loss=1.0, grad_norm=float("nan"))
    assert tr.registry.counter_value("health.emergency_saves") == 1
    assert tr._ckpt.all_steps() == [1]
    tr.train(_batches(1, seed=1))
    tr.save(wait=True)
    bad = tr._ckpt._step_dir(2)
    victim = sorted(p for p in __import__("pathlib").Path(bad).iterdir())[0]
    victim.write_bytes(b"corrupt")
    tr.restore_latest_valid()
    tr.close()
    recs = JRunLog.read(str(tmp_path / "ck" / "runlog.jsonl"))
    faults = [r for r in recs if r["kind"] == "fault"]
    assert [(r["fault"], r["step"]) for r in faults] == [("ckpt_corrupt", 2)]
    assert tr.global_step == 1
    assert json.loads(json.dumps(recs[-1]))["kind"] == "summary"


def test_scaler_transitions_are_logged(monkeypatch, tmp_path):
    """A forced overflow under the dynamic scale: the step is skipped,
    the scale backs off, and the run log gets one `scaler` record
    (event, scale, prev, step) when `settle` reads it, as the
    reference's `_flush_scaler` writes it; the registry counts it."""
    monkeypatch.setenv("HETU_TORCH_RUNLOG", str(tmp_path / "r.jsonl"))
    model = LlamaLMHeadModel(LlamaConfig.tiny(**_TINY), device="cpu")
    tr = Trainer(model, TrainingConfig(**dict(_TRAIN,
                                              loss_scale="dynamic")),
                 device="cpu")
    tr.train(_batches(1))
    top = float(torch.finfo(torch.float32).max)
    tr.scaler_state["scale"].fill_(top)
    tr._last_loss_scale = top          # as if the last step had read it
    ids = np.full((4, 16), 7, np.int32)
    tr.train([{"input_ids": ids, "labels": ids}])
    tr.close()
    recs = [r for r in JRunLog.read(str(tmp_path / "r.jsonl"))
            if r["kind"] == "scaler"]
    assert [(r["event"], r["step"]) for r in recs] == [("backoff", 2)]
    assert recs[0]["scale"] == recs[0]["prev"] / 2
    assert tr.registry.counter_value("scaler.backoff") == 1
