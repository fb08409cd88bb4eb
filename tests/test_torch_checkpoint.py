"""The port's checkpoints (`hetu_tpu_torch.utils.checkpoint`) and the
Trainer's resume, on the CPU.

The manager's cases mirror tests/test_checkpoint.py, the reference's:
a manifest written after the (background) commit and verified; a
corrupt newest step (a flipped byte, a truncated or a deleted file)
falls back to the one before, counted and quarantined, and its number
can be saved again; all steps corrupt raises `CheckpointCorruptError`,
an empty directory FileNotFoundError; a step without a manifest, or
with a torn one, restores; retention prunes the manifests too.

The Trainer's: a run saved at step 2, restored into a fresh model and
trainer and continued equals the uninterrupted run bit for bit (bf16
parameters, the dynamic loss scale and dropout on); its continuation
matches the reference Trainer's own save, restore and continuation to
the tolerances of tests/test_torch_train.py; a checkpoint with or
without the scaler restores into a trainer without or with one (the
reference's retry); `train` saves every `ckpt_every` steps and keeps
`ckpt_keep`.
"""
from __future__ import annotations

import os
import shutil

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from hetu_tpu import chaos
from hetu_tpu.engine import Trainer as JTrainer
from hetu_tpu.engine import TrainingConfig as JTrainingConfig
from hetu_tpu.models.llama import LlamaConfig as JLlamaConfig
from hetu_tpu.models.llama import LlamaLMHeadModel as JLlamaLMHeadModel
from hetu_tpu_torch.engine import Trainer, TrainingConfig
from hetu_tpu_torch.models.gpt import GPTConfig, GPTLMHeadModel
from hetu_tpu_torch.models.llama import (LlamaConfig, LlamaLMHeadModel,
                                         load_jax_params)
from hetu_tpu_torch.utils.checkpoint import (CheckpointCorruptError,
                                             CheckpointManager,
                                             manifest_path)
from test_torch_parity import HD128

TOL = 1e-5


def _mgr(path, **kw):
    kw.setdefault("max_to_keep", 8)
    return CheckpointManager(str(path), **kw)


def _state(step):
    return {"v": torch.arange(6.0) + step, "step": step,
            "opt": {"m": torch.full((2, 3), float(step)), "count": step}}


def _target():
    return {"v": torch.zeros(6), "step": 0,
            "opt": {"m": torch.zeros(2, 3), "count": 0}}


# --------------------------------------------------------------- manager
def test_manifest_written_and_verifies(tmp_path):
    mgr = _mgr(tmp_path)
    mgr.save(3, _state(3), wait=True)
    assert os.path.exists(manifest_path(str(tmp_path), 3))
    ok, why = mgr.verify_step(3)
    assert ok and why == "verified"
    target = _target()
    step, restored = mgr.restore_latest_valid(target=target)
    assert step == 3 and restored["step"] == 3
    assert restored["v"] is target["v"]             # restored in place
    assert torch.equal(target["v"], torch.arange(6.0) + 3)
    assert torch.equal(target["opt"]["m"], torch.full((2, 3), 3.0))
    assert restored["opt"]["count"] == 3
    mgr.wait()


def test_manifest_written_after_async_commit(tmp_path):
    """A background save gets its manifest once its bytes are committed:
    the manifest lands by the next wait/save boundary; the state
    saved is the one at the call, whatever the caller writes after."""
    mgr = _mgr(tmp_path)
    state = _state(1)
    mgr.save(1, state)
    state["v"].fill_(-1.0)
    mgr.wait()
    assert os.path.exists(manifest_path(str(tmp_path), 1))
    ok, _ = mgr.verify_step(1)
    assert ok
    assert torch.equal(mgr.restore(1)["v"], torch.arange(6.0) + 1)
    assert mgr.registry.counter_value("ckpt.saves") == 1
    assert mgr.registry.histogram("ckpt.write_s").count == 1
    mgr.wait()


@pytest.mark.parametrize("mode", ["flip", "truncate", "delete"])
def test_restore_latest_valid_falls_back(tmp_path, mode):
    """A corrupt newest step: the prior step restores, ckpt.fallbacks
    counts one, the corrupt step moves to the quarantine (gone from the
    step list, its bytes kept aside) and its number saves again."""
    mgr = _mgr(tmp_path)
    mgr.save(3, _state(3), wait=True)
    mgr.save(6, _state(6), wait=True)
    chaos.corrupt_step(str(tmp_path), 6, mode=mode, seed=0)
    step, restored = mgr.restore_latest_valid(target=_target())
    assert step == 3
    assert torch.equal(restored["v"], torch.arange(6.0) + 3)
    assert mgr.registry.counter_value("ckpt.fallbacks") == 1
    assert mgr.registry.counter_value("ckpt.quarantined") == 1
    assert mgr.all_steps() == [3]
    qdir = str(tmp_path) + ".quarantine"
    assert any(n.startswith("6_") for n in os.listdir(qdir))
    mgr.save(6, _state(6), wait=True)
    ok, _ = mgr.verify_step(6)
    assert ok and mgr.latest_step() == 6
    mgr.wait()


def test_all_checkpoints_corrupt_raises_loudly(tmp_path):
    mgr = _mgr(tmp_path)
    mgr.save(2, _state(2), wait=True)
    mgr.save(4, _state(4), wait=True)
    chaos.corrupt_step(str(tmp_path), 2, mode="flip", seed=1)
    chaos.corrupt_step(str(tmp_path), 4, mode="flip", seed=2)
    with pytest.raises(CheckpointCorruptError):
        mgr.restore_latest_valid(target=_target())
    # an empty directory is a fresh start, not a corruption
    with pytest.raises(FileNotFoundError):
        _mgr(tmp_path / "empty").restore_latest_valid(target=_target())
    mgr.wait()


def test_manifestless_step_is_unverified_but_restorable(tmp_path):
    mgr = _mgr(tmp_path)
    mgr.save(5, _state(5), wait=True)
    os.remove(manifest_path(str(tmp_path), 5))
    ok, why = mgr.verify_step(5)
    assert ok and "unverified" in why
    step, _ = mgr.restore_latest_valid(target=_target())
    assert step == 5
    mgr.wait()


def test_unverified_step_with_missing_file_still_falls_back(tmp_path):
    """A step without a manifest that lost a data file falls back to the
    step before (not FileNotFoundError, which means a fresh start)."""
    mgr = _mgr(tmp_path)
    mgr.save(3, _state(3), wait=True)
    mgr.save(6, _state(6), wait=True)
    os.remove(manifest_path(str(tmp_path), 6))
    os.remove(tmp_path / "6" / "opt.pt")
    step, restored = mgr.restore_latest_valid(target=_target())
    assert step == 3 and restored["step"] == 3
    mgr.wait()


def test_torn_manifest_does_not_condemn_intact_data(tmp_path):
    mgr = _mgr(tmp_path)
    mgr.save(3, _state(3), wait=True)
    mgr.save(6, _state(6), wait=True)
    with open(manifest_path(str(tmp_path), 6), "w") as f:
        f.write('{"schema": 1, "files": {"trunc')    # torn json
    step, restored = mgr.restore_latest_valid(target=_target())
    assert step == 6 and restored["step"] == 6
    assert mgr.all_steps() == [3, 6]                 # nothing deleted
    assert not os.path.exists(manifest_path(str(tmp_path), 6))
    assert mgr.registry.counter_value("ckpt.manifests_torn") == 1
    mgr.wait()


def test_retention_prunes_manifests(tmp_path):
    mgr = _mgr(tmp_path, max_to_keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _state(s), wait=True)
    assert mgr.all_steps() == [3, 4]
    assert not os.path.exists(manifest_path(str(tmp_path), 1))
    assert not os.path.exists(manifest_path(str(tmp_path), 2))
    assert os.path.exists(manifest_path(str(tmp_path), 4))
    mgr.wait()


@pytest.mark.parametrize("fault", ["missing", "extra", "shape", "dtype"])
def test_restore_refuses_another_structure_and_writes_nothing(tmp_path,
                                                              fault):
    mgr = _mgr(tmp_path)
    mgr.save(1, _state(1), wait=True)
    target = _target()
    if fault == "missing":
        del target["opt"]["count"]
    elif fault == "extra":
        target["scaler"] = {"scale": torch.zeros(())}
    elif fault == "shape":
        target["opt"]["m"] = torch.zeros(3, 2)
    else:       # another kind: a floating leaf restores cast
        target["opt"]["m"] = torch.zeros(2, 3, dtype=torch.int32)
    with pytest.raises(ValueError):
        mgr.restore(1, target=target)
    assert torch.equal(target["v"], torch.zeros(6))
    mgr.wait()


def test_saving_a_step_on_disk_again_is_skipped(tmp_path):
    mgr = _mgr(tmp_path)
    mgr.save(2, _state(2), wait=True)
    mgr.save(2, _state(9), wait=True)
    assert mgr.registry.counter_value("ckpt.save_skipped") == 1
    assert mgr.restore(2)["step"] == 2
    mgr.wait()


# --------------------------------------------------------------- trainer
_TRAIN = dict(global_batch_size=4, micro_batch_size=2, seq_len=16,
              warmup_steps=1, total_steps=10, log_every=100, lr=1e-3)


def _batches(vocab, n, seed=0):
    out = []
    for i in range(n):
        ids = np.random.default_rng(seed + i).integers(
            0, vocab, (4, 16)).astype(np.int32)
        labels = ids.copy()
        labels[0, 2:5] = -100
        out.append({"input_ids": ids, "labels": labels})
    return out


def _model(family):
    if family == "llama":
        return LlamaLMHeadModel(LlamaConfig.tiny(
            param_dtype=torch.bfloat16, attention_dropout=0.1,
            hidden_dropout=0.1, remat_policy="dots_attn"),
            device="cpu", seed=4)
    return GPTLMHeadModel(GPTConfig.tiny(
        param_dtype=torch.bfloat16, attention_dropout=0.1,
        hidden_dropout=0.1, remat_policy="offload"), device="cpu", seed=4)


def _run(family, ckpt_dir, batches, *, resume=False):
    tr = Trainer(_model(family), TrainingConfig(
        **_TRAIN, seed=7, dropout_deterministic=False, loss_scale="dynamic",
        ckpt_dir=str(ckpt_dir), ckpt_every=2, ckpt_keep=1), device="cpu")
    if resume:
        tr.restore_latest_valid()
    metrics = []
    for batch in batches:
        m = tr.train_step(batch)
        metrics.append({k: float(v) for k, v in m.items()})
        if tr.global_step % tr.config.ckpt_every == 0:
            tr.save()
    tr.settle()
    return tr, metrics


@pytest.mark.parametrize("family", ["llama", "gpt"])
def test_resumed_run_equals_the_uninterrupted_run(tmp_path, family):
    """Four steps straight, against two steps, a save, a fresh model and
    trainer restored from it (`restore_latest_valid`), and two more:
    losses, grad norms, scales, every parameter, both moments and the
    scaler's state have the same bits (bf16 parameters, dynamic scale,
    dropout keyed by step)."""
    vocab = 256
    batches = _batches(vocab, 4, seed=11)
    straight, m_straight = _run(family, tmp_path / "a", batches)
    first, m_first = _run(family, tmp_path / "b", batches[:2])
    first._manager().wait()
    del first
    resumed, m_resumed = _run(family, tmp_path / "b", batches[2:],
                              resume=True)
    assert resumed.global_step == 4
    assert m_first + m_resumed == m_straight
    a, b = straight.state(), resumed.state()
    assert a["opt_state"]["step"] == b["opt_state"]["step"] == 4
    for key in ("m", "v"):
        for name, t in a["opt_state"][key].items():
            assert torch.equal(t, b["opt_state"][key][name]), (key, name)
    for name, p in a["params"].items():
        assert torch.equal(p, b["params"][name]), name
    for k in ("scale", "growth_tracker"):
        assert torch.equal(a["scaler"][k], b["scaler"][k])
    resumed._manager().wait()
    assert resumed._manager().all_steps() == [4]     # ckpt_keep=1


def test_continuation_matches_the_reference_resume(tmp_path):
    """The reference Trainer saves at step 2 (orbax), restores into a
    fresh trainer and takes two more steps; the port does the same with
    its own checkpoints from the same weights: the continuation's loss
    and grad norm to 1e-5 relative, lr to 1e-6."""
    jcfg = JLlamaConfig.tiny(compute_dtype=jnp.float32,
                             use_flash_attention=False, **HD128)
    batches = _batches(jcfg.vocab_size, 4, seed=21)
    runs = []
    for side in ("ref", "port"):
        d = str(tmp_path / side)
        train = dict(_TRAIN, ckpt_dir=d)
        if side == "ref":
            jtr = JTrainer(JLlamaLMHeadModel(jcfg),
                           JTrainingConfig(**train)).build()
            init = jax.tree_util.tree_map(np.asarray, jtr.params)
            make = lambda: JTrainer(JLlamaLMHeadModel(jcfg),  # noqa: E731
                                    JTrainingConfig(**train)).build()
            tr = jtr
        else:
            def make():
                model = LlamaLMHeadModel(LlamaConfig.tiny(
                    compute_dtype=torch.float32, **HD128), device="cpu")
                load_jax_params(model, init)
                return Trainer(model, TrainingConfig(**train),
                               device="cpu").build()
            tr = make()
        for batch in batches[:2]:
            tr.train_step(batch)
        tr.save(wait=True)
        fresh = make()
        fresh.restore()
        assert fresh.global_step == 2
        runs.append([{k: float(v) for k, v in fresh.train_step(b).items()}
                     for b in batches[2:]])
    for ref, port in zip(*runs):
        for k, tol in (("loss", TOL), ("grad_norm", TOL), ("lr", 1e-6)):
            np.testing.assert_allclose(port[k], ref[k], rtol=tol, err_msg=k)


@pytest.mark.parametrize("saved_with", [True, False])
def test_restore_retries_with_the_scaler_presence_toggled(tmp_path,
                                                          saved_with):
    """A checkpoint saved with the scaler restores into a trainer without
    one (the scaler's entry is read and dropped), and one saved without
    into a trainer with one (its scaler keeps its fresh state)."""
    def trainer(scaled):
        return Trainer(LlamaLMHeadModel(LlamaConfig.tiny(), device="cpu",
                                        seed=1),
                       TrainingConfig(**_TRAIN, ckpt_dir=str(tmp_path),
                                      loss_scale="dynamic" if scaled
                                      else "none"), device="cpu")
    src = trainer(saved_with)
    batch = _batches(256, 1)[0]
    src.train_step(batch)
    src.save(wait=True)
    dst = trainer(not saved_with)
    dst.restore()
    assert dst.global_step == 1 and dst.opt_state["step"] == 1
    for p, q in zip(src.params, dst.params):
        assert torch.equal(p, q)
    if not saved_with:
        assert float(dst.scaler_state["scale"]) == 2.0 ** 16


def test_train_saves_every_ckpt_every_steps(tmp_path):
    tr = Trainer(LlamaLMHeadModel(LlamaConfig.tiny(), device="cpu"),
                 TrainingConfig(**_TRAIN, ckpt_dir=str(tmp_path),
                                ckpt_every=2, ckpt_keep=2), device="cpu")
    tr.train(_batches(256, 5))
    tr._manager().wait()
    assert tr._manager().all_steps() == [2, 4]
    assert tr.registry.counter_value("ckpt.saves") == 2
    assert tr.registry.histogram("ckpt.save_blocked_s").count == 2
    shutil.rmtree(tmp_path / "4")
    assert tr.restore_latest_valid().global_step == 2


def test_trainer_without_ckpt_dir_refuses_to_save():
    tr = Trainer(LlamaLMHeadModel(LlamaConfig.tiny(), device="cpu"),
                 TrainingConfig(**_TRAIN), device="cpu")
    with pytest.raises(ValueError, match="ckpt_dir"):
        tr.save()
