"""The PyTorch port's flash attention against the JAX reference's Pallas
kernels, on the CPU.

The reference side runs its kernels in interpret mode with explicit
small blocks, as tests/test_flash_attention.py does; the port's side
runs the plain versions its CUDA kernels are held against on the card
(tests/test_torch_cuda.py), so these tests pin what "right" means for
the kernels: the block mask as semantics (a dead tile is never
computed), masks by explicit positions and segment ids, bottom-right
alignment for sq != sk, o = 0 and lse = -1e30 for a row that sees
nothing, fp32 gradients from `_bwd`.  Inputs are numpy arrays made from
a seed and handed to both.  Everything is fp32: o and lse agree to 1e-5,
gradients to 1e-4 of each tensor's largest entry (a backward's worth of
sums in another order).

The bf16 Hopper kernels' tile classes (dead / partial / full) are held
here too, through their PyTorch mirror `tile_classes`: a full tile needs
no element mask, a dead one is a dead API block.
"""
from __future__ import annotations

import ctypes
import re

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import jax
import jax.numpy as jnp
import torch

from hetu_tpu.ops.pallas import flash_attention as jflash
from hetu_tpu_torch.ops.cuda import build
from hetu_tpu_torch.ops.cuda import flash_attention as tflash

TOL = 1e-5
GRAD_TOL = 1e-4

_DEAD_ROW = ((True, False, True, False), (False, False, False, False))
_SPARSE = ((True, False, False, False), (False, True, True, False))
# q block 0 skips k blocks 1-7, which its neighbours see
_GAP = ((True,) + (False,) * 7 + (True,), (True,) * 9, (True,) * 9)

#: name -> (sq, sk, hq, hkv, block_q, block_k, options)
CASES = {
    "causal_mha": (128, 128, 2, 2, 64, 64, {}),
    "causal_gqa4": (128, 128, 4, 1, 64, 64, {}),
    "non_causal": (128, 256, 2, 1, 64, 128, {"causal": False}),
    "segments": (128, 128, 2, 1, 64, 64, {"segments": True}),
    "sq_ne_sk": (128, 256, 2, 2, 64, 64, {}),
    "future_chunk": (128, 128, 2, 1, 64, 64, {"k_offset": 1000}),
    "dead_row": (128, 256, 2, 1, 64, 64, {"block_mask": _DEAD_ROW,
                                          "causal": False}),
    "sparse_mask": (128, 256, 4, 2, 64, 64, {"block_mask": _SPARSE}),
    "asymmetric_blocks": (256, 256, 2, 1, 128, 64, {}),
    "causal_blocks_of_512": (1024, 1024, 2, 1, 512, 512, {}),
    "gap_mask": (192, 576, 2, 1, 64, 64, {"block_mask": _GAP,
                                          "causal": False}),
}
GRAD_CASES = ("causal_gqa4", "segments", "sparse_mask", "dead_row",
              "asymmetric_blocks", "sq_ne_sk", "causal_blocks_of_512",
              "gap_mask")


def _inputs(name, d=64, b=2, seed=0):
    """(q, k, v numpy, the reference's kwargs, the port's kwargs)."""
    sq, sk, hq, hkv, bq, bk, opts = CASES[name]
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((b, sq, hq, d), (b, sk, hkv, d),
                             (b, sk, hkv, d)))
    static = {key: opts[key] for key in ("causal", "block_mask")
              if key in opts}
    static.update(block_q=bq, block_k=bk)
    arrays = {}
    if opts.get("segments"):
        # packed sequences of uneven lengths, other cuts per batch row
        arrays["segment_ids"] = np.stack([
            (np.arange(sq) >= cut).astype(np.int32) + 1
            for cut in (sq // 3, sq // 2)][:b])
    if "k_offset" in opts:
        arrays["q_positions"] = np.tile(np.arange(sq, dtype=np.int32), (b, 1))
        arrays["kv_positions"] = np.tile(
            np.arange(sk, dtype=np.int32) + opts["k_offset"], (b, 1))
    jkw = dict(static, **{key: jnp.asarray(a) for key, a in arrays.items()})
    tkw = dict(static, device="cpu",
               **{key: torch.from_numpy(a) for key, a in arrays.items()})
    return (q, k, v), jkw, tkw


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_matches_the_pallas_kernel(name):
    """o and lse of `flash_attention_with_lse`; rows that see nothing
    give exactly o = 0 and lse = NEG_INF on both sides."""
    qkv, jkw, tkw = _inputs(name)
    jo, jlse = jflash.flash_attention_with_lse(*map(jnp.asarray, qkv), **jkw)
    to, tlse = tflash.flash_attention_with_lse(*map(torch.from_numpy, qkv),
                                               **tkw)
    assert to.shape == jo.shape and tlse.shape == jlse.shape
    assert tlse.dtype == torch.float32
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=TOL)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), rtol=TOL,
                               atol=TOL)
    blind = np.asarray(jlse) <= jflash.NEG_INF / 2
    assert blind.any() == (name in ("future_chunk", "dead_row"))
    assert (tlse.numpy()[blind] == np.float32(tflash.NEG_INF)).all()
    assert (to.numpy().transpose(0, 2, 1, 3)[blind] == 0).all()


@pytest.mark.parametrize("name", GRAD_CASES)
def test_gradients_match_the_pallas_kernels(name):
    """dq, dk, dv of `flash_attention` (the Function's backward: the
    explicit formulas from the saved lse and delta) against `jax.grad`
    through the reference's custom VJP."""
    qkv, jkw, tkw = _inputs(name, seed=1)
    w = np.random.default_rng(2).standard_normal(qkv[0].shape).astype(
        np.float32)
    jgrads = jax.grad(
        lambda q, k, v: (jflash.flash_attention(q, k, v, **jkw) * w).sum(),
        argnums=(0, 1, 2))(*map(jnp.asarray, qkv))
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in qkv]
    (tflash.flash_attention(*leaves, **tkw) * torch.from_numpy(w)).sum(
        ).backward()
    for leaf, ref, label in zip(leaves, jgrads, "qkv"):
        ref = np.asarray(ref)
        assert leaf.grad.shape == ref.shape
        np.testing.assert_allclose(leaf.grad.numpy(), ref,
                                   atol=GRAD_TOL * np.abs(ref).max(),
                                   err_msg=f"d{label}")


@pytest.mark.parametrize("pass_delta", [False, True])
def test_fwd_and_bwd_on_bhsd_match_the_reference(pass_delta):
    """The ring layer's entries: `_fwd`/`_bwd` on [b, h, s, d] with
    explicit positions and a causal block mask with offsets; gradients
    come back fp32 for bf16 inputs, with delta passed in or left out."""
    rng = np.random.default_rng(3)
    b, hq, hkv, s, d = 1, 4, 2, 128, 64
    q, do = (rng.standard_normal((b, hq, s, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((b, hkv, s, d)).astype(np.float32)
            for _ in range(2))
    # "my queries" sit 64 positions after this KV chunk's start
    q_pos = np.arange(s, dtype=np.int32)[None] + 64
    k_pos = np.arange(s, dtype=np.int32)[None]
    mask = jflash.causal_block_mask(s, s, 64, 64, q_offset=64, k_offset=0)
    assert mask == tflash.causal_block_mask(s, s, 64, 64, q_offset=64,
                                            k_offset=0)
    kw = dict(scale=d ** -0.5, causal=True, block_q=64, block_k=64,
              block_mask=mask)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    jo, jlse = jflash._fwd(jq, jk, jv, jnp.asarray(q_pos),
                           jnp.asarray(k_pos), None, None, **kw)
    jdelta = jnp.sum(jdo * jo, axis=-1) if pass_delta else None
    jg = jflash._bwd(jq, jk, jv, jo, jlse, jdo, jnp.asarray(q_pos),
                     jnp.asarray(k_pos), None, None, delta=jdelta, **kw)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    tpos = torch.from_numpy(q_pos), torch.from_numpy(k_pos)
    to, tlse = tflash._fwd(tq, tk, tv, *tpos, None, None, device="cpu", **kw)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=TOL)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), atol=TOL)
    tdelta = (tdo * to).sum(-1) if pass_delta else None
    tg = tflash._bwd(tq, tk, tv, to, tlse, tdo, *tpos, None, None,
                     delta=tdelta, device="cpu", **kw)
    for mine, ref in zip(tg, jg):
        ref = np.asarray(ref)
        np.testing.assert_allclose(mine.numpy(), ref,
                                   atol=GRAD_TOL * np.abs(ref).max())
    half = tflash._bwd(tq.bfloat16(), tk.bfloat16(), tv.bfloat16(),
                       to.bfloat16(), tlse, tdo.bfloat16(), *tpos, None,
                       None, device="cpu", **kw)
    assert all(g.dtype == torch.float32 for g in half)
    assert [tuple(g.shape) for g in half] == [q.shape, k.shape, v.shape]


def test_dead_tiles_are_never_computed():
    """The block mask is semantics: a dead tile takes and gives no
    gradient and adds nothing to the output, though its elements would
    pass the (absent) position mask."""
    (q, k, v), _, tkw = _inputs("dead_row")
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = tflash.flash_attention(*leaves, **tkw)
    out.sum().backward()
    dq, dk, dv = (leaf.grad for leaf in leaves)
    assert bool((dq[:, 64:] == 0).all())            # the all-dead q row
    assert bool((dq[:, :64] != 0).any())
    for g in (dk, dv):                              # k blocks 1 and 3
        assert bool((g[:, 64:128] == 0).all())
        assert bool((g[:, 192:] == 0).all())
        assert bool((g[:, :64] != 0).any())
    full = tflash.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                  **dict(tkw, block_mask=None))
    assert not torch.allclose(full[:, :64], out[:, :64].detach())


@pytest.mark.parametrize("sq,sk,bq,bk", [
    (256, 256, 64, 64), (128, 512, 64, 128), (512, 128, 128, 64),
    (384, 384, 128, 128), (96, 96, 32, 48)])
@pytest.mark.parametrize("offsets", [{}, {"q_offset": 128, "k_offset": 0},
                                     {"q_offset": 0, "k_offset": 256}])
def test_block_mask_helpers_equal_the_reference(sq, sk, bq, bk, offsets):
    mine = tflash.causal_block_mask(sq, sk, bq, bk, **offsets)
    assert mine == jflash.causal_block_mask(sq, sk, bq, bk, **offsets)
    assert tflash.full_block_mask(sq, sk, bq, bk) == \
        jflash.full_block_mask(sq, sk, bq, bk)
    assert tflash.block_mask_live_frac(mine) == \
        jflash.block_mask_live_frac(mine)
    assert tflash.NEG_INF == jflash.NEG_INF


@pytest.mark.parametrize("requested,s", [
    (128, 2048), (1024, 2048), (1024, 1536), (512, 640), (128, 100),
    (64, 96), (1024, 77), (256, 384)])
def test_fit_block_equals_the_reference(requested, s):
    assert tflash.fit_block(requested, s) == jflash.fit_block(requested, s)


def test_wrong_block_mask_and_shapes_raise():
    (q, k, v), _, tkw = _inputs("causal_mha")
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    with pytest.raises(ValueError, match="block_mask shape"):
        tflash.flash_attention(tq, tk, tv, **dict(tkw,
                                                  block_mask=((True,),)))
    with pytest.raises(ValueError, match="hq must divide"):
        tflash.flash_attention(tq, tk[:, :, :1].expand(-1, -1, 3, -1),
                               tv[:, :, :1].expand(-1, -1, 3, -1), **tkw)
    with pytest.raises(ValueError, match="one dtype"):
        tflash.flash_attention(tq.double(), tk.double(), tv.double(), **tkw)
    pos = torch.zeros((2, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="must divide by blocks"):
        tflash._fwd(tq.transpose(1, 2), tk.transpose(1, 2),
                    tv.transpose(1, 2), pos, pos, None, None, scale=1.0,
                    causal=True, block_q=96, block_k=64, device="cpu")


def test_ctypes_mirror_matches_the_source():
    """`_FlashArgs` is `struct FlashArgs` of the CUDA source field for
    field — same names, same order, same widths — and every symbol the
    wrappers bind is exported with (args, d, stream): checked here,
    where no compiler runs."""
    text = (build.CSRC / "flash_attention.cu").read_text()
    body = re.search(r"struct FlashArgs \{(.*?)\n\};", text, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    fields = []
    for decl in filter(None, (d.strip() for d in body.split(";"))):
        ctype, names = re.match(r"(.*?[\s*])(\w+(?:\s*,\s*\w+)*)$",
                                decl, re.S).groups()
        ctype = ctype.strip()
        width = (ctypes.c_void_p if ctype.endswith("*") else
                 {"long long": ctypes.c_longlong, "int": ctypes.c_int,
                  "float": ctypes.c_float}[ctype])
        fields += [(n.strip(), width) for n in names.split(",")]
    assert fields == list(tflash._FlashArgs._fields_)
    for sym, argtypes in tflash._SIGNATURES.items():
        kernel = sym[len("hetu_flash_"):sym.rindex("_")]
        assert re.search(rf"HETU_FLASH_ENTRY\({sym}, {kernel}, ", text), sym
        assert len(argtypes) == 3
    assert text.count("HETU_FLASH_ENTRY(hetu_") == len(tflash._SIGNATURES)


def test_default_device_is_the_card(monkeypatch):
    """Every entry runs where it was asked to: "cuda" by default, which
    raises without a card, never the plain version quietly; a CPU call
    counts no launch."""
    (q, k, v), _, tkw = _inputs("causal_mha")
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    before = tflash.launches, tflash.dq_launches, tflash.dkv_launches
    tq.requires_grad_(True)
    tflash.flash_attention(tq, tk, tv, **tkw).sum().backward()
    assert (tflash.launches, tflash.dq_launches,
            tflash.dkv_launches) == before
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for entry in (tflash.flash_attention, tflash.flash_attention_with_lse):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry(tq, tk, tv)
    with pytest.raises(ValueError):
        tflash.flash_attention(tq, tk, tv, device="meta")


# ------------------------------------------------------------ tile classes
#: (sq, sk, block_q, block_k, options) of every case here and of the card
#: tests' `_FLASH_CASES` (tests/test_torch_cuda.py)
_CLASS_SHAPES = sorted({(sq, sk, bq, bk, tuple(sorted(
    (k, v) for k, v in opts.items())))
    for sq, sk, _, _, bq, bk, opts in CASES.values()} | {
    (256, 256, 128, 128, ()),
    (128, 256, 64, 128, (("causal", False),)),
    (128, 256, 64, 64, ()),
    (256, 256, 128, 64, (("segments", True),)),
    (128, 256, 64, 64, (("block_mask", _DEAD_ROW), ("causal", False))),
    (192, 96, 96, 96, ()),
    (128, 128, 64, 64, (("k_offset", 1000),)),
    (192, 256, 64, 64, ()),
    (256, 256, 128, 128, (("k_offset", 0),)),
    # `test_flash_bf16_block_shapes_match_plain`'s
    (192, 192, 96, 96, ()),
    (192, 192, 64, 64, ()),
    (256, 256, 128, 128, (("segments", True),)),
    (1024, 1024, 512, 512, ()),
    (192, 576, 64, 64, (("block_mask", _GAP), ("causal", False))),
    # chip_smoke.py's sq != sk and the GPT training shape
    (128, 384, 128, 128, ()),
    (1024, 1024, 128, 128, ())},
    key=repr)


def _check_classes(q_pos, k_pos, q_seg, k_seg, causal, bq, bk, mask):
    """Every FULL tile has all its elements visible and every EMPTY tile
    none, both with all 64 rows a side; every DEAD tile lies in a dead
    API block and every tile of a dead API block is DEAD.  Returns the
    classes."""
    b, sq, sk = q_pos.shape[0], q_pos.shape[1], k_pos.shape[1]
    live = tflash._mask_tensor(mask, torch.device("cpu"))
    classes = tflash.tile_classes(q_pos, k_pos, q_seg, k_seg, causal=causal,
                                  block_q=bq, block_k=bk, live=live)
    elem = tflash._element_mask(b, sq, sk, q_pos, k_pos, q_seg, k_seg,
                                causal, bq, bk, live)[:, 0, 0]
    q_tiles = list(tflash._tiles(bq, sq // bq))
    k_tiles = list(tflash._tiles(bk, sk // bk))
    assert classes.shape == (b, len(q_tiles), len(k_tiles))
    for i, (qb, q0, qr) in enumerate(q_tiles):
        for j, (kb, k0, kr) in enumerate(k_tiles):
            got = classes[:, i, j]
            assert bool((got == tflash.DEAD).all()) == (not mask[qb][kb])
            assert bool((got == tflash.DEAD).any()) == (not mask[qb][kb])
            tile = elem[:, q0:q0 + qr, k0:k0 + kr]
            for cls, seen in ((tflash.FULL, True), (tflash.EMPTY, False)):
                hit = got == cls
                if hit.any():
                    assert qr == kr == tflash.TILE
                    assert bool((tile[hit] == seen).all()), (cls, i, j)
            if not causal:
                assert not bool((got == tflash.EMPTY).any())
    return classes


@pytest.mark.parametrize("shape", _CLASS_SHAPES, ids=repr)
def test_tile_classes_agree_with_the_element_mask(shape):
    """The full / partial / dead rule of the bf16 kernels against
    `_element_mask` at every flash test shape, with its default
    positions (bottom-right), segments cut at a third and the offset of a
    future chunk; interior tiles of the causal mask come out full."""
    sq, sk, bq, bk, opts = shape
    opts = dict(opts)
    b, causal = 2, opts.get("causal", True)
    k_pos = (torch.arange(sk, dtype=torch.int32)
             + opts.get("k_offset", 0)).expand(b, sk)
    q_pos = (torch.arange(sq, dtype=torch.int32)
             + (0 if "k_offset" in opts else sk - sq)).expand(b, sq)
    q_seg = k_seg = None
    if opts.get("segments"):
        q_seg = (q_pos >= sk // 3).int()
        k_seg = (k_pos >= sk // 3).int()
    mask = opts.get("block_mask") or (
        tflash.causal_block_mask(sq, sk, bq, bk) if causal
        and "k_offset" not in opts else tflash.full_block_mask(sq, sk, bq,
                                                                bk))
    classes = _check_classes(q_pos, k_pos, q_seg, k_seg, causal, bq, bk,
                             mask)
    if causal and bq % 64 == 0 and bk % 64 == 0 and not {
            "segments", "k_offset", "block_mask"} & set(opts):
        # bottom-right causal: a tile wholly below the diagonal is full,
        # a live one wholly above it empty
        for i, (qb, q0, _) in enumerate(tflash._tiles(bq, sq // bq)):
            for j, (kb, k0, _) in enumerate(tflash._tiles(bk, sk // bk)):
                want = (tflash.FULL if q0 + sk - sq >= k0 + 63 else
                        tflash.EMPTY if q0 + sk - sq + 63 < k0
                        and mask[qb][kb] else None)
                if want is not None:
                    assert bool((classes[:, i, j] == want).all())


@settings(max_examples=60, deadline=None, derandomize=True, database=None)
@given(data=st.data(), bq=st.sampled_from([32, 64, 96, 128, 192]),
       bk=st.sampled_from([32, 64, 96, 128]), nq=st.integers(1, 3),
       nk=st.integers(1, 3), causal=st.booleans(), segs=st.integers(0, 3))
def test_tile_classes_hold_for_random_positions_and_segments(
        data, bq, bk, nq, nk, causal, segs):
    """Random (not monotone) positions, random segment ids from a few
    values (none when `segs` is 0) and a random block mask: the rule
    still never calls a tile full that holds a masked element."""
    b, sq, sk = 2, nq * bq, nk * bk
    seed = data.draw(st.integers(0, 2 ** 31 - 1))
    rng = np.random.default_rng(seed)
    spread = data.draw(st.sampled_from([4, 64, 4096]))
    q_pos = torch.from_numpy(rng.integers(0, spread, (b, sq)).astype(
        np.int32))
    k_pos = torch.from_numpy(rng.integers(0, spread, (b, sk)).astype(
        np.int32))
    if data.draw(st.booleans()):            # mostly ordered, as in training
        q_pos, k_pos = q_pos.sort(1).values, k_pos.sort(1).values
    q_seg = k_seg = None
    if segs:
        q_seg = torch.from_numpy(rng.integers(0, segs, (b, sq)).astype(
            np.int32))
        k_seg = torch.from_numpy(rng.integers(0, segs, (b, sk)).astype(
            np.int32))
    mask = tuple(tuple(bool(x) for x in row)
                 for row in rng.random((nq, nk)) < 0.7)
    _check_classes(q_pos, k_pos, q_seg, k_seg, causal, bq, bk, mask)
