"""Checkpoints with verified fallback, the port of
`hetu_tpu/utils/checkpoint.py` (`CheckpointManager`,
`CheckpointCorruptError`, the manifests).

The reference stores through orbax; the port's machines have neither
orbax nor safetensors, so a step is one directory, `<directory>/<step>`,
holding one `torch.save`d file per top-level entry of the state (a
nested dict of tensors and numbers: `params.pt`, `opt_state.pt`, ...).
What the reference guarantees is kept:

  * a save is written into a temporary directory and renamed into place
    (the commit); only then its MANIFEST — the state's structure hash
    and each file's size and crc32 — is written, atomically (tmp +
    rename), beside the step directory;
  * `max_to_keep` prunes the oldest committed steps, manifests too;
  * `save(wait=False)` returns once the tensors' copies are enqueued: on
    the card they go to pinned host buffers on a side stream, and a
    thread waits for them, writes, commits and checksums; `fence()`
    makes the current stream wait for those copies before it writes
    into the saved tensors again (the Trainer calls it before each
    update);
  * `verify_step`, and `restore(step, target)` into the target's
    tensors in place (`copy_`), after the whole structure is checked: a
    different set of entries, shape or kind of dtype raises ValueError
    and writes nothing; a floating tensor saved in another floating
    dtype is rounded to the target's on the copy, as the reference's
    orbax restore casts to its target's dtypes (a bf16-parameter run
    resumed into an fp16 one);
  * `restore_latest_valid` walks back past torn or corrupt steps,
    counting `ckpt.fallbacks` and quarantining checksum failures into
    `<directory>.quarantine/`; a torn manifest is dropped and its step
    restored unverified; `CheckpointCorruptError` when checkpoints exist
    but none restores, FileNotFoundError when there are none.

Counters and timings go to `registry` (a `MetricsRegistry`, the
Trainer's own): ckpt.saves, ckpt.save_skipped, ckpt.manifests_written,
ckpt.manifests_torn, ckpt.fallbacks, ckpt.quarantined; the histograms
ckpt.save_blocked_s (the caller's time in `save`), ckpt.write_s (the
copy wait, writes, commit and manifest) and ckpt.restore_s; the gauge
ckpt.bytes.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from hetu_tpu_torch.obs.metrics import MetricsRegistry
from hetu_tpu_torch.utils.logging import get_logger

logger = get_logger("checkpoint")


class CheckpointCorruptError(RuntimeError):
    """Checkpoints exist on disk but none of them is restorable (every
    step failed manifest verification or raised during restore).
    Distinct from FileNotFoundError (no checkpoints at all: a fresh
    start)."""


# ---------------------------------------------------------------- manifest
def manifest_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"manifest_{int(step)}.json")


def _leaves(tree, prefix=()):
    """(keypath, leaf) pairs of a nested dict, keys in sorted order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (str(k),))
    else:
        yield prefix, tree


def _describe(leaf):
    if isinstance(leaf, torch.Tensor):
        return list(leaf.shape), str(leaf.dtype)
    return [], type(leaf).__name__


def structure_hash(state: Dict[str, Any]) -> str:
    """Stable hash of the state's (keypath, shape, dtype) skeleton."""
    leaves = [(".".join(kp), *_describe(leaf)) for kp, leaf in _leaves(state)]
    blob = json.dumps(sorted(leaves), sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def _file_checksums(step_dir: str) -> Dict[str, Dict[str, int]]:
    """relpath -> {size, crc32} for every file under a step directory."""
    out: Dict[str, Dict[str, int]] = {}
    for root, _dirs, files in os.walk(step_dir):
        for fn in sorted(files):
            p = os.path.join(root, fn)
            crc, size = 0, 0
            with open(p, "rb") as f:
                while True:
                    chunk = f.read(1 << 23)
                    if not chunk:
                        break
                    crc = zlib.crc32(chunk, crc)
                    size += len(chunk)
            out[os.path.relpath(p, step_dir)] = {"size": size,
                                                 "crc32": crc & 0xFFFFFFFF}
    return out


def _fsynced_json(path: str, obj):
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def write_manifest(directory: str, step: int,
                   structure: Optional[str] = None) -> str:
    """Checksum a committed step directory and write its manifest
    atomically (tmp + rename): a crash mid-write leaves no manifest or a
    complete one."""
    step_dir = os.path.join(directory, str(int(step)))
    path = manifest_path(directory, step)
    _fsynced_json(path, {"schema": 1, "step": int(step),
                         "structure": structure,
                         "files": _file_checksums(step_dir),
                         "written_at": time.time()})
    return path


#: verify detail prefix for a torn/unreadable manifest: the data may be
#: fine, so restore_latest_valid drops the manifest instead of
#: quarantining the step
MANIFEST_UNREADABLE = "manifest unreadable"


def verify_manifest(directory: str, step: int) -> Tuple[bool, str]:
    """(ok, detail) for one step.  A missing manifest passes as
    'unverified'; a present but mismatching one fails."""
    path = manifest_path(directory, step)
    if not os.path.exists(path):
        return True, "unverified (no manifest)"
    try:
        with open(path) as f:
            man = json.load(f)
    except (ValueError, OSError) as e:
        return False, f"{MANIFEST_UNREADABLE}: {e!r}"
    step_dir = os.path.join(directory, str(int(step)))
    if not os.path.isdir(step_dir):
        return False, "step directory missing"
    actual = _file_checksums(step_dir)
    expected = man.get("files", {})
    if set(actual) != set(expected):
        missing = sorted(set(expected) - set(actual))
        extra = sorted(set(actual) - set(expected))
        return False, (f"file set mismatch (missing={missing[:3]}, "
                       f"extra={extra[:3]})")
    for rel, meta in expected.items():
        a = actual[rel]
        if a["size"] != meta.get("size") or a["crc32"] != meta.get("crc32"):
            return False, (f"checksum mismatch in {rel} "
                           f"(size {a['size']} vs {meta.get('size')})")
    return True, "verified"


# ------------------------------------------------------------ host copies
class _HostCopy:
    """The state's tensors copied to the host: CUDA tensors into pinned
    buffers (kept for the next save of the same structure) on a side
    stream, CPU tensors cloned.  `ready` waits for the copies."""

    def __init__(self):
        self._buffers: Dict[Tuple, torch.Tensor] = {}
        self.event = None

    def take(self, state):
        cuda = [leaf for _, leaf in _leaves(state)
                if isinstance(leaf, torch.Tensor) and leaf.is_cuda]
        stream = None
        if cuda:
            device = cuda[0].device
            stream = torch.cuda.Stream(device)
            stream.wait_stream(torch.cuda.current_stream(device))
        paths = {}

        def copy(leaf, kp):
            if not isinstance(leaf, torch.Tensor):
                return leaf
            if not leaf.is_cuda:
                return leaf.detach().clone()
            key = (kp, tuple(leaf.shape), leaf.dtype)
            buf = self._buffers.get(key)
            if buf is None:
                buf = self._buffers[key] = torch.empty(
                    leaf.shape, dtype=leaf.dtype, pin_memory=True)
            with torch.cuda.stream(stream):
                buf.copy_(leaf, non_blocking=True)
            return buf

        for kp, leaf in _leaves(state):
            paths[kp] = copy(leaf, kp)
        self.event = None
        if stream is not None:
            self.event = torch.cuda.Event()
            self.event.record(stream)
        return _rebuild(state, paths)

    def ready(self):
        if self.event is not None:
            self.event.synchronize()


def _rebuild(tree, by_path, prefix=()):
    if isinstance(tree, dict):
        return {k: _rebuild(v, by_path, prefix + (str(k),))
                for k, v in tree.items()}
    return by_path[prefix]


def _castable(loaded, target) -> bool:
    """The same dtype, or floating both: the copy rounds to the
    target's."""
    return loaded.dtype == target.dtype or (
        loaded.is_floating_point() and target.is_floating_point())


def _check_like(loaded, target, where="state"):
    """ValueError unless `loaded` has `target`'s entries, shapes and
    dtypes (any floating dtype for a floating target)."""
    if isinstance(target, dict):
        if not isinstance(loaded, dict) or set(loaded) != set(target):
            got = sorted(loaded) if isinstance(loaded, dict) else loaded
            raise ValueError(f"checkpoint structure differs at {where}: "
                             f"{got} vs {sorted(target)}")
        for k in target:
            _check_like(loaded[k], target[k], f"{where}.{k}")
    elif isinstance(target, torch.Tensor):
        if not isinstance(loaded, torch.Tensor) or \
                loaded.shape != target.shape or \
                not _castable(loaded, target):
            raise ValueError(f"checkpoint {where}: {_describe(loaded)} vs "
                             f"{_describe(target)}")


def _copy_into(loaded, target):
    if isinstance(target, dict):
        return {k: _copy_into(loaded[k], target[k]) for k in target}
    if isinstance(target, torch.Tensor):
        with torch.no_grad():
            target.copy_(loaded)
        return target
    return loaded


# ----------------------------------------------------------------- manager
class CheckpointManager:
    """Step-numbered checkpoints under `directory` with retention, saves
    in the background and verified fallback (module docstring)."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 registry: Optional[MetricsRegistry] = None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self._host = _HostCopy()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(self.directory, exist_ok=True)

    # -------------------------------------------------------------- save
    def save(self, step: int, state: Dict[str, Any], wait: bool = False):
        """Checkpoint `state` (a dict of nested dicts of tensors and
        numbers) as `step`.  Returns once its tensors' copies are
        enqueued (`wait`: once it is committed and has its manifest)."""
        t0 = time.perf_counter()
        self._finalize_pending()
        step = int(step)
        if os.path.isdir(self._step_dir(step)):
            self.registry.inc("ckpt.save_skipped")
            logger.warning(f"step {step} is already on disk; state NOT "
                           "re-written")
            return
        host = self._host.take(state)
        structure = structure_hash(state)
        self._thread = threading.Thread(target=self._write,
                                        args=(step, host, structure),
                                        daemon=True)
        self._thread.start()
        self.registry.observe("ckpt.save_blocked_s",
                              time.perf_counter() - t0)
        if wait:
            self.wait()

    def fence(self):
        """Make the current stream wait for the last save's copies, so
        it may write into the saved tensors again."""
        ev = self._host.event
        if ev is not None:
            torch.cuda.current_stream(ev.device).wait_event(ev)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def _write(self, step: int, host, structure: str):
        t0 = time.perf_counter()
        try:
            self._host.ready()
            tmp = os.path.join(self.directory, f".tmp-{step}")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            nbytes = 0
            for name, tree in host.items():
                path = os.path.join(tmp, f"{name}.pt")
                torch.save(tree, path)
                with open(path, "rb+") as f:
                    os.fsync(f.fileno())
                nbytes += os.path.getsize(path)
            os.replace(tmp, self._step_dir(step))
            write_manifest(self.directory, step, structure)
            self.registry.inc("ckpt.manifests_written")
            self.registry.inc("ckpt.saves")
            self.registry.set_gauge("ckpt.bytes", nbytes)
            self._prune()
        except Exception as e:   # raised at the next save/restore/wait
            self._error = e
        self.registry.observe("ckpt.write_s", time.perf_counter() - t0)

    def _prune(self):
        """Drop the oldest committed steps past max_to_keep, and their
        manifests."""
        for step in self.all_steps()[:-self.max_to_keep or None]:
            shutil.rmtree(self._step_dir(step), ignore_errors=True)
            try:
                os.remove(manifest_path(self.directory, step))
            except OSError:
                pass

    def _finalize_pending(self):
        """Join the background writer; raise what it raised."""
        t = self._thread
        if t is not None:
            t.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # ------------------------------------------------------------ queries
    def all_steps(self) -> List[int]:
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and os.path.isdir(self._step_dir(n)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def verify_step(self, step: int) -> Tuple[bool, str]:
        """(ok, detail): do the step's bytes match its manifest?"""
        return verify_manifest(self.directory, step)

    # ----------------------------------------------------------- restore
    def restore(self, step: Optional[int] = None,
                target: Optional[Dict[str, Any]] = None):
        """The state saved as `step` (the latest by default).  With a
        `target` of the same structure, its tensors are overwritten in
        place and returned (numbers come from the checkpoint; a floating
        tensor rounded to the target's dtype); without, the loaded host
        tensors."""
        self._finalize_pending()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        t0 = time.perf_counter()
        step_dir = self._step_dir(step)
        names = sorted(n[:-3] for n in os.listdir(step_dir)
                       if n.endswith(".pt"))
        if target is not None and set(names) != set(target):
            raise ValueError(f"checkpoint step {step} holds {names}, the "
                             f"target {sorted(target)}")
        loaded = {n: torch.load(os.path.join(step_dir, f"{n}.pt"),
                                map_location="cpu", weights_only=True,
                                mmap=True)
                  for n in (names if target is None else target)}
        if target is None:
            return loaded
        _check_like(loaded, target)
        out = _copy_into(loaded, target)
        self.registry.observe("ckpt.restore_s", time.perf_counter() - t0)
        return out

    def restore_latest_valid(self, target=None,
                             restore_fn: Optional[Callable] = None,
                             on_fallback: Optional[Callable] = None):
        """(step, restored): the newest checkpoint that verifies and
        restores, walking back past corrupt and torn saves.
        restore_fn(step) replaces the per-step restore (the Trainer's,
        with its scaler-presence retry); on_fallback(step, why) observes
        each step walked past (the Trainer's `fault` records)."""
        self._finalize_pending()
        reg = self.registry
        steps = sorted(self.all_steps(), reverse=True)
        if not steps:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        last_err: Optional[BaseException] = None
        for step in steps:
            ok, why = self.verify_step(step)
            if not ok and why.startswith(MANIFEST_UNREADABLE):
                reg.inc("ckpt.manifests_torn")
                logger.warning(f"dropping torn manifest for step {step} "
                               f"({why}); step demoted to unverified")
                try:
                    os.remove(manifest_path(self.directory, step))
                except OSError:
                    pass
                ok = True
            if not ok:
                reg.inc("ckpt.fallbacks")
                logger.warning(f"checkpoint step {step} failed "
                               f"verification ({why}); falling back")
                self.quarantine(step, why)
                if on_fallback is not None:
                    on_fallback(step, why)
                continue
            try:
                if restore_fn is not None:
                    return step, restore_fn(step)
                return step, self.restore(step, target=target)
            except Exception as e:
                # unrestorable though it verified: count and fall back,
                # but keep the bytes (they may only mismatch this target)
                last_err = e
                reg.inc("ckpt.fallbacks")
                logger.warning(f"restore of step {step} raised {e!r}; "
                               "falling back")
                if on_fallback is not None:
                    on_fallback(step, repr(e))
        raise CheckpointCorruptError(
            f"no restorable checkpoint among steps {steps} in "
            f"{self.directory}"
            + (f" (last error: {last_err!r})" if last_err else ""))

    def quarantine(self, step: int, why: str = ""):
        """Move a corrupt step into `<directory>.quarantine/` (deleting
        it if the move fails) and drop its manifest, so it can neither
        restore nor shadow a later save of the same step."""
        self.registry.inc("ckpt.quarantined")
        logger.warning(f"quarantining corrupt checkpoint step {step}"
                       + (f" ({why})" if why else ""))
        qdir = self.directory.rstrip("/") + ".quarantine"
        try:
            os.makedirs(qdir, exist_ok=True)
            os.rename(self._step_dir(step),
                      os.path.join(qdir, f"{int(step)}_{int(time.time())}"))
        except OSError as e:
            logger.warning(f"quarantine move of step {step} failed "
                           f"({e!r}); deleting instead")
            shutil.rmtree(self._step_dir(step), ignore_errors=True)
        try:
            os.remove(manifest_path(self.directory, step))
        except OSError:
            pass

    # ------------------------------------------------------------- admin
    def wait(self):
        """Block until the last save is committed with its manifest."""
        self._finalize_pending()
