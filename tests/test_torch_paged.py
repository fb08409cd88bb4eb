"""The paged kernel's split plan and its split-then-merge arithmetic, on
the CPU.

The CUDA kernel (`hetu_tpu_torch/csrc/paged_attention.cuh`) splits each
slot's keys across blocks by `split_plan` and merges the splits' fp32
partials in split order; `paged_verify_split_plain` is that arithmetic
in PyTorch.  Here the plan is held to depend on shapes alone, and the
composition is held against the plain version (`paged_verify_plain`,
one softmax over every key) within 1e-6 in fp32 and against the JAX
reference's Pallas kernels in interpret mode (HETU_TPU_PALLAS=1, as
tests/test_torch_spec.py runs them) at the reference's 1e-5: every page
mode, decode (C = 1) and verify (C = 5), at split sizes that cut a
page's run of keys, with splits that start past a slot's last key
(empty) and verify rows whose limit falls inside a split.
"""
from __future__ import annotations

import inspect

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from hetu_tpu.ops.pallas import paged_attention as jpaged
from hetu_tpu_torch.ops.cuda import paged_attention as tpaged
from test_torch_spec import _jax_kw, _pages, _port_kw, _t

PLAIN_TOL = 1e-6
FWD_TOL = 1e-5
PS = 8
# 4 slots on 16 pages of 8 (128 keys a slot): slot 0 deep, slot 1's
# verify rows straddle key 24 (a boundary of K = 8, 12 and 24), slot 2
# shallow (most splits empty), slot 3 inactive on the null page
TABLE = np.array([[1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 0, 0, 0, 0],
                  [13, 14, 15, 16, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
                  [17, 18, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
                  [0] * 16], np.int32)
POSITIONS = np.array([90, 22, 9, 0], np.int32)


@pytest.fixture
def pallas(monkeypatch):
    monkeypatch.setenv("HETU_TPU_PALLAS", "1")
    monkeypatch.setenv("HETU_TPU_PALLAS_KERNELS", "paged_attn,paged_verify")


def _case(quant, C, seed):
    k, v, ks, vs = _pages(seed, quant, P=19, ps=PS)
    q = np.random.default_rng(seed + 1).standard_normal(
        (4, C, 8, 128)).astype(np.float32)
    return q, k, v, ks, vs


@pytest.mark.parametrize("max_pages,page_size,rows", [
    (128, 16, 4), (128, 16, 20), (64, 16, 1), (64, 16, 5), (130, 16, 4),
    (4, 8, 4), (16, 8, 32), (100, 7, 8), (1, 1, 1), (2048, 1, 9)])
def test_split_plan_depends_on_shapes_alone(max_pages, page_size, rows):
    """The plan takes the table's width, the page size and the row
    count — no tensor, so never `positions` — and covers the table in
    whole pages: splits x K >= the table's keys, the last split starts
    inside it, K is a multiple of the page size within the kernel's
    limit, and one split covers a small table."""
    params = list(inspect.signature(tpaged.split_plan).parameters)
    assert params == ["max_pages", "page_size", "rows"]
    splits, K = tpaged.split_plan(max_pages, page_size, rows)
    assert (splits, K) == tpaged.split_plan(max_pages, page_size, rows)
    total = max_pages * page_size
    assert K % page_size == 0 and 0 < K <= tpaged.MAX_SPLIT
    assert splits * K >= total > (splits - 1) * K
    if total <= tpaged._SPLIT_KEYS_MANY_ROWS:
        assert splits == 1
    # more query rows a kv head never means more keys a split
    assert K <= tpaged.split_plan(max_pages, page_size, 1)[1]


@pytest.mark.parametrize("K", [5, 8, 12, 24, 128])
@pytest.mark.parametrize("C", [1, 5])
@pytest.mark.parametrize("quant", ["none", "int8", "int4"])
def test_split_composition_matches_plain(quant, C, K):
    """Splits of 5 and 12 keys cut a page's run of 8; slot 2's keys end
    in split 0 or 1, so the later splits are empty; slot 1's rows see
    keys up to 22..26, a limit inside a split of 8, 12 or 24."""
    q, k, v, ks, vs = _case(quant, C, 31 + K)
    args = (_t(q), _t(k), _t(v), _t(TABLE), _t(POSITIONS), 128 ** -0.5,
            None if ks is None else _t(ks), None if vs is None else _t(vs),
            quant)
    ref = tpaged.paged_verify_plain(*args)
    out = tpaged.paged_verify_split_plain(*args, keys_per_split=K)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=PLAIN_TOL,
                               rtol=0)


@pytest.mark.parametrize("C", [1, 5])
def test_split_composition_default_plan_matches_plain(C):
    """At the plan's own split (a 2,048-key table, depths to 2,000) the
    composition still equals the one-pass softmax."""
    rng = np.random.default_rng(41 + C)
    mp, P = 128, 260
    k = rng.standard_normal((P, 16, 2, 64)).astype(np.float32)
    v = rng.standard_normal((P, 16, 2, 64)).astype(np.float32)
    q = rng.standard_normal((3, C, 8, 64)).astype(np.float32)
    table = np.zeros((3, mp), np.int32)
    table[0, :126] = np.arange(1, 127)
    table[1, :20] = np.arange(127, 147)
    positions = np.array([2000, 300, 0], np.int32)
    splits, K = tpaged.split_plan(mp, 16, C * 4)
    assert splits > 1
    args = (_t(q), _t(k), _t(v), _t(table), _t(positions), 0.125)
    np.testing.assert_allclose(
        tpaged.paged_verify_split_plain(*args).numpy(),
        tpaged.paged_verify_plain(*args).numpy(), atol=PLAIN_TOL, rtol=0)


@pytest.mark.parametrize("K", [8, 12])
@pytest.mark.parametrize("C", [1, 5])
@pytest.mark.parametrize("quant", ["none", "int8", "int4"])
def test_split_composition_matches_pallas_kernel(pallas, quant, C, K):
    """The composition against the reference's paged kernels in
    interpret mode (C = 1: `paged_attention`, else `paged_verify`)."""
    q, k, v, ks, vs = _case(quant, C, 51 + K)
    jargs = (jnp.asarray(k), jnp.asarray(v), jnp.asarray(TABLE),
             jnp.asarray(POSITIONS))
    if C == 1:
        ref = jpaged.paged_attention(jnp.asarray(q[:, 0]), *jargs,
                                     **_jax_kw(ks, vs, quant))[:, None]
    else:
        ref = jpaged.paged_verify(jnp.asarray(q), *jargs,
                                  **_jax_kw(ks, vs, quant))
    kw = _port_kw(ks, vs, quant)
    out = tpaged.paged_verify_split_plain(
        _t(q), _t(k), _t(v), _t(TABLE), _t(POSITIONS), 128 ** -0.5,
        kw.get("k_scale"), kw.get("v_scale"), quant, keys_per_split=K)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FWD_TOL)
