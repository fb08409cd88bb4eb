"""The fused KV page write's plain versions (`ops/cuda/kv_write.py`)
against the reference pool's page writes, on the CPU.

`write_kv_tokens` (one layer a call) is held against the reference's
`PagePool.write_token` (decode, [L, S, n_kv, hd]) and `write_tokens`
(a verify block, [L, S, C, n_kv, hd]), and `write_kv_pages` against
`write_pages`, in the three page modes (exact, int8, int4), at L = 2,
n_kv = 2, page size 4 and head dims 64 and 128.  The pools start from
the same seeded bytes, so pages a write must not touch are compared
too.  The cases: a row that is not decoding (its zeroed table row,
position 0: its writes land in the null page), a verify block that runs
past its slot's table row (those positions land in the null page), and
a page row with null entries (the prefix cache's shared pages ahead,
the unused tail behind), whose pages the port skips and the reference
fills with garbage: page 0 is compared only where one write lands on
each of its slots.  int8 runs the reference's quantize by its XLA chain
and by its Pallas kernel (interpret mode, HETU_TPU_PALLAS=1; block 128
only, so hd 64 keeps the chain).

Tolerances: payloads bit for bit, scales within one fp32 ulp (the
Pallas file's own note, `hetu_tpu/ops/pallas/quant.py:13-15`: XLA may
realize / qmax as a multiply by the reciprocal), exact pools equal.
"""
from __future__ import annotations

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from hetu_tpu.serving import kv_pool as jkv_pool
from hetu_tpu_torch.ops.cuda import kv_write as tkv
from hetu_tpu_torch.serving import kv_pool as tkv_pool

L, NKV, PS, P = 2, 2, 4, 11
# (page mode, the reference's quantize route, head dim): the Pallas
# quantize takes blocks of 128 only
CASES = [(quant, route, hd) for hd in (64, 128)
         for quant, route in (("none", "xla"), ("int8", "xla"),
                              ("int8", "pallas"), ("int4", "xla"))
         if route == "xla" or hd % 128 == 0]
CASE_IDS = [f"{q}-{r}-{hd}" for q, r, hd in CASES]


@pytest.fixture
def route(request, monkeypatch):
    if request.param == "pallas":
        monkeypatch.setenv("HETU_TPU_PALLAS", "1")
        monkeypatch.setenv("HETU_TPU_PALLAS_KERNELS", "quant")
    return request.param


def _pools(quant, hd, seed):
    """Seeded pool contents in a page mode, as numpy: (k, v, k_scale,
    v_scale), the scales None for exact pages."""
    rng = np.random.default_rng(seed)
    shape = (L, P + 1, PS, NKV, hd)
    if quant == "none":
        return (rng.standard_normal(shape).astype(np.float32),
                rng.standard_normal(shape).astype(np.float32), None, None)
    hd_p = hd // 2 if quant == "int4" else hd
    dtype, lo, hi = ((np.uint8, 0, 256) if quant == "int4"
                     else (np.int8, -127, 128))
    pay = [rng.integers(lo, hi, shape[:-1] + (hd_p,)).astype(dtype)
           for _ in range(2)]
    sc = [rng.exponential(size=shape[:-1]).astype(np.float32)
          for _ in range(2)]
    return pay[0], pay[1], sc[0], sc[1]


def _reference(quant, hd):
    return jkv_pool.PagePool(num_layers=L, num_pages=P, page_size=PS,
                             num_kv_heads=NKV, head_dim=hd, quant=quant,
                             device_arrays=False)


def _tree(arrays):
    k, v, ks, vs = arrays
    return jkv_pool.PoolArrays(*(None if a is None else jnp.asarray(a)
                                 for a in (k, v, ks, vs))).tree()


def _port(arrays):
    return [None if a is None else torch.from_numpy(a.copy())
            for a in arrays]


def _same(port, ref, pages=slice(None)):
    """Payloads equal, scales within one fp32 ulp, over `pages`."""
    k, v, ks, vs = port
    ref = list(ref) + [None] * (4 - len(ref))
    for a, b in ((k, ref[0]), (v, ref[1])):
        np.testing.assert_array_equal(a.numpy()[:, pages],
                                      np.asarray(b)[:, pages])
    if ks is not None:
        for a, b in ((ks, ref[2]), (vs, ref[3])):
            np.testing.assert_array_max_ulp(a.numpy()[:, pages],
                                            np.asarray(b)[:, pages],
                                            maxulp=1)


def _heads(seed, *lead, hd):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((*lead, NKV, hd)).astype(np.float32)
    return x * rng.exponential(size=(*lead, NKV, 1)).astype(np.float32)


def _write_layers(port, table, positions, k, v, quant):
    """The port's page write a layer at a time, as the paged forwards
    call it: k, v [L, S, C, n_kv, hd]."""
    kp, vp, ks, vs = port
    for li in range(L):
        tkv.write_kv_tokens(
            kp[li], vp[li], torch.from_numpy(table),
            torch.from_numpy(positions), torch.from_numpy(k[li]),
            torch.from_numpy(v[li]),
            k_scale=None if ks is None else ks[li],
            v_scale=None if vs is None else vs[li], quant=quant,
            device="cpu")


# slot 0 decodes in its second page, slot 1 in its first, slot 2 is not
# decoding (a zeroed table row at position 0: the null page)
_TABLE = np.array([[3, 7, 1, 0], [9, 0, 0, 0], [0, 0, 0, 0]], np.int32)


@pytest.mark.parametrize("quant,route,hd", CASES, ids=CASE_IDS,
                         indirect=["route"])
def test_decode_write_matches_write_token(quant, route, hd):
    positions = np.array([6, 2, 0], np.int32)
    arrays = _pools(quant, hd, 1)
    k, v = _heads(2, L, 3, hd=hd), _heads(3, L, 3, hd=hd)
    ref = _reference(quant, hd).write_token(
        _tree(arrays), jnp.asarray(_TABLE), jnp.asarray(positions),
        jnp.asarray(k), jnp.asarray(v))
    port = _port(arrays)
    before = tkv.launches
    _write_layers(port, _TABLE, positions, k[:, :, None], v[:, :, None],
                  quant)
    assert tkv.launches == before          # the plain version never counts
    _same(port, ref)
    # the inactive row wrote the null page's first slot, nothing else
    assert not np.array_equal(port[0].numpy()[:, 0, 0], arrays[0][:, 0, 0])
    np.testing.assert_array_equal(port[0].numpy()[:, 0, 1:],
                                  arrays[0][:, 0, 1:])


@pytest.mark.parametrize("quant,route,hd", CASES, ids=CASE_IDS,
                         indirect=["route"])
@pytest.mark.parametrize("case", ["inactive_row", "past_the_row"])
def test_verify_write_matches_write_tokens(quant, route, hd, case):
    """A verify block of C = 3: with a row that is not decoding, or with
    slot 1 at position 3 of a one-page row (positions 4 and 5 are past
    it: the null page's slots 0 and 1)."""
    C = 3
    if case == "inactive_row":
        table, start = _TABLE, np.array([5, 1, 0], np.int32)
    else:
        table, start = _TABLE[:2, :1], np.array([0, 3], np.int32)
    S = table.shape[0]
    arrays = _pools(quant, hd, 4)
    k, v = _heads(5, L, S, C, hd=hd), _heads(6, L, S, C, hd=hd)
    positions = start[:, None] + np.arange(C, dtype=np.int32)
    ref = _reference(quant, hd).write_tokens(
        _tree(arrays), jnp.asarray(table), jnp.asarray(positions),
        jnp.asarray(k), jnp.asarray(v))
    port = _port(arrays)
    _write_layers(port, table, start, k, v, quant)
    _same(port, ref)
    written = np.zeros(PS, bool)
    written[:C if case == "inactive_row" else 2] = True
    assert not np.array_equal(port[1].numpy()[:, 0, written],
                              arrays[1][:, 0, written])
    np.testing.assert_array_equal(port[1].numpy()[:, 0, ~written],
                                  arrays[1][:, 0, ~written])


@pytest.mark.parametrize("quant,route,hd", CASES, ids=CASE_IDS,
                         indirect=["route"])
def test_page_write_matches_write_pages(quant, route, hd):
    """A prefill's scratch into a row whose first two entries are the
    prefix cache's shared pages (null: not written) and whose last is
    the unused tail; the scratch is a view of the dense cache [L, 1, M,
    n_kv, hd], as the engine hands it over."""
    row = np.array([0, 0, 5, 2, 8, 0], np.int32)
    M = row.shape[0] * PS
    arrays = _pools(quant, hd, 7)
    ks, vs = _heads(8, L, 1, M, hd=hd), _heads(9, L, 1, M, hd=hd)
    ref = _reference(quant, hd).write_pages(
        _tree(arrays), jnp.asarray(row), jnp.asarray(ks[:, 0]),
        jnp.asarray(vs[:, 0]))
    port = _port(arrays)
    before = tkv.pages_launches
    tkv.write_kv_pages(port[0], port[1], torch.from_numpy(row),
                       torch.from_numpy(ks)[:, 0], torch.from_numpy(vs)[:, 0],
                       k_scale=port[2], v_scale=port[3], quant=quant,
                       device="cpu")
    assert tkv.pages_launches == before
    _same(port, ref, pages=slice(1, None))
    # page 0 untouched (the reference scatters its null entries there)
    for a, b in zip(port, arrays):
        if b is not None:
            np.testing.assert_array_equal(a.numpy()[:, 0], b[:, 0])


@pytest.mark.parametrize("quant", ["none", "int8", "int4"])
def test_pool_write_pages_runs_the_page_write(quant):
    """`PagePool.write_pages` is one call of `write_kv_pages`: a host
    page row in, the real pages equal to the plain page write's."""
    pool = tkv_pool.PagePool(num_layers=L, num_pages=P, page_size=PS,
                             num_kv_heads=NKV, head_dim=64, quant=quant,
                             device="cpu")
    row = np.array([4, 0, 6], np.int32)
    ks = torch.from_numpy(_heads(10, L, 3 * PS, hd=64))
    vs = torch.from_numpy(_heads(11, L, 3 * PS, hd=64))
    pool.write_pages(row, ks, vs)
    want = [torch.zeros_like(t) if t is not None else None
            for t in (pool.k, pool.v, pool.k_scale, pool.v_scale)]
    tkv.write_kv_pages_plain(want[0], want[1], torch.from_numpy(row), ks,
                             vs, want[2], want[3], quant)
    for a, b in zip((pool.k, pool.v, pool.k_scale, pool.v_scale), want):
        if b is not None:
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="positions"):
        pool.write_pages(row[:2], ks, vs)


def test_token_blocks_of_bf16_write_their_fp32_widening():
    """bf16 K and V quantize as their exact fp32 widening, and exact bf16
    pages take them unchanged."""
    hd = 64
    table, positions = torch.from_numpy(_TABLE), torch.tensor([6, 2, 0],
                                                              dtype=torch.int32)
    x = torch.from_numpy(_heads(12, 3, 1, hd=hd)).bfloat16()
    for quant in ("int8", "int4"):
        outs = []
        for t in (x, x.float()):
            kp, vp, ks, vs = _port(_pools(quant, hd, 13))
            tkv.write_kv_tokens(kp[0], vp[0], table, positions, t, t,
                                k_scale=ks[0], v_scale=vs[0], quant=quant,
                                device="cpu")
            outs.append((kp, ks))
        assert torch.equal(outs[0][0], outs[1][0])
        assert torch.equal(outs[0][1], outs[1][1])
    kp = torch.zeros((P + 1, PS, NKV, hd), dtype=torch.bfloat16)
    tkv.write_kv_tokens(kp, kp.clone(), table, positions, x, x, device="cpu")
    assert torch.equal(kp[7, 2], x[0, 0])     # slot 0: page 7, offset 2


def test_page_writes_refuse_what_they_do_not_take(monkeypatch):
    hd = 64
    kp, vp, ks, vs = _port(_pools("int8", hd, 14))
    table = torch.from_numpy(_TABLE)
    pos = torch.tensor([1, 2, 0], dtype=torch.int32)
    k = torch.zeros((3, 1, NKV, hd))
    with pytest.raises(ValueError, match="k_scale and v_scale"):
        tkv.write_kv_tokens(kp[0], vp[0], table, pos, k, k, k_scale=ks[0],
                            device="cpu")
    with pytest.raises(ValueError, match="head vectors of"):
        tkv.write_kv_tokens(kp[0], vp[0], table, pos, k, k, k_scale=ks[0],
                            v_scale=vs[0], quant="int4", device="cpu")
    with pytest.raises(ValueError, match="disagree"):
        tkv.write_kv_tokens(kp[0], vp[0], table, pos[:2], k, k,
                            k_scale=ks[0], v_scale=vs[0], device="cpu")
    with pytest.raises(ValueError, match="fp32"):
        tkv.write_kv_tokens(kp[0], vp[0], table, pos, k, k,
                            k_scale=ks[0].double(), v_scale=vs[0],
                            device="cpu")
    with pytest.raises(ValueError, match="mp \\* page_size"):
        tkv.write_kv_pages(kp, vp, torch.tensor([1, 2], dtype=torch.int32),
                           torch.zeros((L, 3 * PS, NKV, hd)),
                           torch.zeros((L, 3 * PS, NKV, hd)), k_scale=ks,
                           v_scale=vs, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):         # no card: the default device
        tkv.write_kv_pages(kp, vp, torch.tensor([1, 2], dtype=torch.int32),
                           torch.zeros((L, 2 * PS, NKV, hd)),
                           torch.zeros((L, 2 * PS, NKV, hd)), k_scale=ks,
                           v_scale=vs)
