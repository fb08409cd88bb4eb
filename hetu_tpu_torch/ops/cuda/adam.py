"""Fused AdamW update of a list of parameter leaves, in place: wrapper,
host table builder, plain version and launch counter.

Replaces `hetu_tpu/ops/pallas/adam.py` `adam_update`.  Kernel:
`csrc/adam.cu`, bound by bytes on the H100 (28 bytes per fp32
element, 24 per bf16 or fp16 one; see its header): one pass reads p, g,
m and v and writes p, m and v in place, over every leaf of a list in
one launch.  Every leaf
goes through it: the Pallas `% 128` gate is a TPU lane rule, and the
CUDA kernel takes any element count (a scalar path takes the tail and
views off a 16-byte boundary).  lr, c1 and c2 arrive as host floats (the
optimizer computes them in fp32 from the step count, as JAX does in its
graph), so the update never reads a value back from the card.  An
optional `skip` flag, an int32 0-d tensor on the card, makes the launch
write nothing when nonzero (a non-finite step under the dynamic loss
scale): p, m and v keep their bits and the host never waits for it.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from hetu_tpu_torch.ops.cuda import build

#: kernel launches (the plain version never counts)
launches = 0
#: the same launches by the parameters' arm (`build.arm_counts`; the
#: kernel has f32, bf16 and f16 arms)
arm_launches = build.arm_counts("launches")

#: leaves a launch's table holds (`ADAM_MAX_LEAVES` in csrc/adam.cu)
MAX_LEAVES = 512
#: elements a block takes at once (`ADAM_CHUNK` in csrc/adam.cu)
CHUNK = 16384

_SYMBOLS = {torch.float32: "hetu_adam_multi_f32",
            torch.bfloat16: "hetu_adam_multi_bf16",
            torch.float16: "hetu_adam_multi_f16"}


class _Leaf(ctypes.Structure):
    """`struct AdamLeaf` of csrc/adam.cu, field for field."""
    _fields_ = ([(n, ctypes.c_void_p) for n in ("p", "g", "m", "v")]
                + [("n", ctypes.c_longlong), ("aligned", ctypes.c_int),
                   ("pad", ctypes.c_int)])


class _Table(ctypes.Structure):
    """`struct AdamTable` of csrc/adam.cu, field for field."""
    _fields_ = ([(n, ctypes.c_float) for n in (
        "b1", "one_minus_b1", "b2", "one_minus_b2", "lr", "c1", "c2", "eps",
        "wd")]
        + [("leaves", ctypes.c_int), ("skip", ctypes.c_void_p),
           ("chunk_start", ctypes.c_int * (MAX_LEAVES + 1)),
           ("leaf", _Leaf * MAX_LEAVES)])


_ARGTYPES = [ctypes.POINTER(_Table), ctypes.c_void_p]
#: every exported symbol -> its ctypes argtypes
_SIGNATURES = dict.fromkeys(_SYMBOLS.values(), _ARGTYPES)


def _f32(x) -> float:
    """A Python float holding x rounded to fp32, the value both the
    kernel (by value) and the plain version (as a scalar) compute with."""
    return float(np.float32(x))


def _scalars(lr, c1, c2, b1, b2, eps, weight_decay):
    """(b1, 1 - b1, b2, 1 - b2, lr, c1, c2, eps, wd) in fp32; 1 - b is
    taken in double and then rounded, as JAX's `(1.0 - b1) * g` does
    with its Python-float b1."""
    return tuple(_f32(v) for v in (b1, 1.0 - b1, b2, 1.0 - b2, lr, c1, c2,
                                   eps, weight_decay))


def adam_plain(p, g, m, v, lr, c1, c2, *, b1, b2, eps, weight_decay,
               skip=None):
    """The kernel's arithmetic in PyTorch ops, updating p, m and v in
    place (fp32 math; p rounded once to its dtype, to nearest even: an
    fp16 p past 65,504 becomes inf, as the reference's astype); with a
    nonzero `skip` (a 0-d tensor on p's device) each keeps its bits."""
    b1, omb1, b2, omb2, lr, c1, c2, eps, wd = _scalars(
        lr, c1, c2, b1, b2, eps, weight_decay)
    # the divisors as tensors: PyTorch's CUDA division by a Python
    # scalar multiplies by its reciprocal, a second rounding (filled on
    # the device, so the update can be captured in a CUDA graph)
    c1, c2 = (torch.full((), c, dtype=torch.float32, device=m.device)
              for c in (c1, c2))
    gf = g.float()
    m_new = m * b1 + gf * omb1
    v_new = v * b2 + (gf * gf) * omb2
    pf = p.float()
    upd = (m_new / c1) / (torch.sqrt(v_new / c2) + eps) + pf * wd
    p_new = (pf - upd * lr).to(p.dtype)
    if skip is not None:
        keep = skip != 0
        p_new, m_new, v_new = (torch.where(keep, old, new) for old, new in (
            (p, p_new), (m, m_new), (v, v_new)))
    p.copy_(p_new)
    m.copy_(m_new)
    v.copy_(v_new)


def plan_tables(sizes: Sequence[int], max_leaves: int = MAX_LEAVES,
                chunk: int = CHUNK) -> List[Tuple[List[int], List[int]]]:
    """Cut leaves of `sizes` elements into launches: a list of (leaf
    indices, chunk_start) per launch, at most `max_leaves` leaves each,
    in order; chunk_start[i] is the first chunk of the launch's i-th
    leaf and its last entry the launch's chunk count (a prefix of
    ceil(size / chunk)).  Empty leaves are left out: they have no work."""
    tables, leaves, starts = [], [], [0]
    for i, n in enumerate(sizes):
        if n <= 0:
            continue
        if len(leaves) == max_leaves:
            tables.append((leaves, starts))
            leaves, starts = [], [0]
        leaves.append(i)
        starts.append(starts[-1] + -(-n // chunk))
    if leaves:
        tables.append((leaves, starts))
    return tables


def vector_aligned(*tensors: torch.Tensor) -> bool:
    """Whether every tensor starts on a 16-byte boundary, so the kernel
    moves the leaf in 16-byte vectors (else its scalar path)."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def make_tables(params, grads, ms, vs, scalars, skip=None) -> List[_Table]:
    """The launches' tables for leaves of one p dtype (`plan_tables`),
    with the nine fp32 scalars of `_scalars` and the skip flag's
    address (None: never skip)."""
    out = []
    for idx, starts in plan_tables([p.numel() for p in params]):
        t = _Table(*scalars)
        t.leaves = len(idx)
        t.skip = None if skip is None else skip.data_ptr()
        t.chunk_start[:len(starts)] = starts
        for j, i in enumerate(idx):
            p, g, m, v = params[i], grads[i], ms[i], vs[i]
            t.leaf[j] = _Leaf(p.data_ptr(), g.data_ptr(), m.data_ptr(),
                              v.data_ptr(), p.numel(),
                              int(vector_aligned(p, g, m, v)), 0)
        out.append(t)
    return out


def _check_leaf(p, g, m, v):
    if not (p.shape == g.shape == m.shape == v.shape):
        raise ValueError(f"p/g/m/v shapes must match, got {tuple(p.shape)} "
                         f"{tuple(g.shape)} {tuple(m.shape)} "
                         f"{tuple(v.shape)}")
    if p.dtype not in _SYMBOLS or (g.dtype, m.dtype, v.dtype) != (
            torch.float32,) * 3:
        raise ValueError(f"adam_update takes an fp32/bf16/fp16 p and fp32 "
                         f"g/m/v, got {p.dtype} {g.dtype} {m.dtype} "
                         f"{v.dtype}")


def _check_skip(skip):
    if skip is not None and (skip.dim() != 0 or skip.dtype != torch.int32):
        raise ValueError(f"adam_update: skip must be a 0-d int32 tensor, "
                         f"got {skip.dtype} of shape {tuple(skip.shape)}")


def adam_update_multi(params, grads, ms, vs, lr, c1, c2, *, b1: float,
                      b2: float, eps: float, weight_decay: float,
                      skip: Optional[torch.Tensor] = None,
                      device="cuda") -> None:
    """One AdamW step over lists of leaves, IN PLACE on each p (fp32,
    bf16 or fp16), m and v (fp32), from the fp32 gradients.  lr, c1 =
    1 - b1^step and c2 = 1 - b2^step are host numbers; `skip`, a 0-d
    int32 tensor beside the leaves, nonzero leaves every p, m and v as
    it was.
    `device` "cuda" launches the kernel once for each p dtype (or once
    for each `MAX_LEAVES` leaves of it), "cpu" runs the plain version
    leaf by leaf; the tensors must lie there."""
    leaves = list(zip(params, grads, ms, vs))
    if not len(params) == len(grads) == len(ms) == len(vs):
        raise ValueError(f"{len(params)} params, {len(grads)} grads, "
                         f"{len(ms)} m, {len(vs)} v")
    dev = build.check_device(
        "adam_update", device, *(t for leaf in leaves for t in leaf),
        *([] if skip is None else [skip]))
    for leaf in leaves:
        _check_leaf(*leaf)
    _check_skip(skip)
    with torch.no_grad():
        if dev.type == "cpu":
            for leaf in leaves:
                adam_plain(*leaf, lr, c1, c2, b1=b1, b2=b2, eps=eps,
                           weight_decay=weight_decay, skip=skip)
            return
        for leaf in leaves:
            for name, t in zip("pgmv", leaf):
                if not t.is_contiguous():
                    raise ValueError(f"adam_update needs contiguous {name}")
        scalars = _scalars(lr, c1, c2, b1, b2, eps, weight_decay)
        for dtype, symbol in _SYMBOLS.items():
            group = [leaf for leaf in leaves if leaf[0].dtype == dtype]
            if not group:
                continue
            device_ = group[0][0].device
            with torch.cuda.device(device_):
                fn = build.bind("adam", symbol, _ARGTYPES)
                stream = torch.cuda.current_stream(device_).cuda_stream
                for table in make_tables(*zip(*group), scalars, skip):
                    build.check_launch(fn(ctypes.byref(table), stream),
                                       "adam_update")
                    build.count(globals(), "launches", dtype)


def adam_update(p, g, m, v, lr, c1, c2, *, b1: float, b2: float,
                eps: float, weight_decay: float, skip=None,
                device="cuda") -> None:
    """One leaf's AdamW step, IN PLACE on p (fp32, bf16 or fp16), m and
    v (fp32), from the fp32 gradient g: `adam_update_multi` over a list of
    one leaf."""
    adam_update_multi([p], [g], [m], [v], lr, c1, c2, b1=b1, b2=b2, eps=eps,
                      weight_decay=weight_decay, skip=skip, device=device)
