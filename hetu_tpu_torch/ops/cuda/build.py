"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` compiles with one `nvcc` call into its own shared
library with a plain C interface, loaded with ctypes (no PyTorch
headers, so a build takes seconds, not minutes).  Libraries go to
`build/kernels/` at the repo root (git-ignored), named by a hash of
their sources and flags, so an edited source rebuilds and an unchanged
one is reused.  `build()` starts every missing build at once and waits
for all of them.

Nothing here runs at import: a wrapper calls `library(name)` the first
time it launches its kernel on a CUDA tensor, and a CPU-only process
never builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("adam", "flash_attention", "fused_norm", "paged_attention",
           "rotary", "swiglu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_BUILD_TIMEOUT_S = 600

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "CUDA kernels cannot be built")
    return path


def library_path(name: str) -> Path:
    """Where `name`'s library lives: keyed by its source, the shared
    headers and the flags."""
    h = hashlib.sha256()
    for src in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every named kernel whose library is missing, all in
    parallel.  Returns {name: ptxas report (registers, shared memory,
    spills)}, empty for a library that was already built.  Raises with
    the compiler's output when a build fails."""
    names = list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports = {name: "" for name in names}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        try:
            log, _ = proc.communicate(timeout=_BUILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n"
                          f"{log}")
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return reports


def library(name: str) -> ctypes.CDLL:
    """The loaded library for `name`, built first if missing."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build([name])
            lib = _libs[name] = ctypes.CDLL(str(path))
        return lib


def bind(name: str, symbol: str, argtypes):
    """`symbol` of `name`'s library (built first if missing), its
    argtypes declared and its cudaError_t return typed."""
    fn = getattr(library(name), symbol)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def check_device(kernel: str, device, *tensors) -> torch.device:
    """The device a wrapper runs on, as its caller asked: "cuda" (the
    default) launches the kernel, "cpu" runs the plain version.  Every
    tensor must lie on that device type, so a caller who forgot to move
    its inputs to the card gets an error, not the plain version."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"{kernel} runs on cuda or cpu, not {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{kernel}: device {device!r} requested but no "
                           "CUDA device is available; pass device='cpu' "
                           "for the plain PyTorch version")
    for t in tensors:
        if t.device.type != dev.type:
            raise ValueError(f"{kernel}: a tensor lies on {t.device}, the "
                             f"call asked for {dev}")
    devices = {t.device for t in tensors}
    if len(devices) > 1:
        raise ValueError(f"{kernel}: tensors on several devices: {devices}")
    return dev


def check_launch(err: int, kernel: str):
    """Raise on a nonzero cudaGetLastError() returned by a launch (a
    refused launch never runs, and a later synchronize does not report
    it)."""
    if err:
        raise RuntimeError(f"{kernel} launch failed: cudaError_t {err}")
