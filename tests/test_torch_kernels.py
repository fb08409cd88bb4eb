"""The port's kernel modules (hetu_tpu_torch/ops) against the JAX
reference's Pallas kernels and plain compositions.

On the CPU each kernel wrapper runs its plain PyTorch version; the JAX
side runs its Pallas kernel in interpret mode, as
tests/test_pallas_kernels.py does, and its plain composition.  Inputs
are seeded numpy arrays handed to both.  Float32 forward tolerance
1e-5 (docs/kernels.md); bf16 comparisons allow one bf16 ulp.

The CUDA kernels themselves are held against their plain versions on
the card in tests/test_torch_cuda.py, which imports no JAX.
"""
from __future__ import annotations

import re

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from hetu_tpu import ops as jops
from hetu_tpu.models import generation as jgen
from hetu_tpu.ops.pallas import paged_attention as jpaged
from hetu_tpu.ops.pallas import rotary as jrotary
from hetu_tpu.ops.pallas import swiglu as jswiglu
from hetu_tpu_torch.ops import norms, rotary
from hetu_tpu_torch.ops.activations import swiglu
from hetu_tpu_torch.ops.cuda import build
from hetu_tpu_torch.ops.cuda import paged_attention as tpaged
from hetu_tpu_torch.ops.cuda import rotary as trotary
from hetu_tpu_torch.ops.cuda import swiglu as tswiglu

FWD_TOL = 1e-5


def _rand(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _bf16_close(a: torch.Tensor, b: torch.Tensor):
    """Within one bf16 ulp (8 significant bits) of the larger of the
    two, elementwise."""
    a, b = a.float(), b.float()
    _, exp = torch.frexp(torch.maximum(a.abs(), b.abs()))
    ulp = torch.ldexp(torch.ones_like(a), exp - 8)
    assert bool(((a - b).abs() <= ulp).all()), \
        f"max diff {(a - b).abs().max().item()}"


# ------------------------------------------------------------- rms norm
def test_rms_norm_matches_reference():
    x, w = _rand((3, 5, 64), 0), _rand((64,), 1)
    ref = jops.rms_norm(jnp.asarray(x), jnp.asarray(w))
    out = norms.rms_norm(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FWD_TOL)


# --------------------------------------------------------------- rotary
@pytest.mark.parametrize("max_len,hd,theta", [(256, 16, 1e4),
                                              (8192, 128, 5e5)])
def test_rope_cache_matches_reference(max_len, hd, theta):
    jc, js = jops.build_rope_cache(max_len, hd, theta)
    tc, ts = rotary.build_rope_cache(max_len, hd, theta)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=FWD_TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=FWD_TOL)


def _rotary_case(seed, b=2, s=5, nq=4, nk=2, hd=128):
    q, k = _rand((b, s, nq, hd), seed), _rand((b, s, nk, hd), seed + 1)
    pos = np.random.default_rng(seed + 2).integers(
        0, 64, size=(b, s)).astype(np.int32)
    cos, sin = jops.build_rope_cache(64, hd, 10000.0)
    cos_t, sin_t = np.asarray(cos)[pos], np.asarray(sin)[pos]
    return q, k, pos, cos_t, sin_t


def test_fused_rotary_matches_pallas_kernel():
    q, k, _, cos_t, sin_t = _rotary_case(0)
    jq, jk = jrotary.fused_rotary_qk(*map(jnp.asarray, (q, k, cos_t, sin_t)))
    tq, tk = trotary.fused_rotary_qk(
        *map(torch.from_numpy, (q, k, cos_t, sin_t)), device="cpu")
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=FWD_TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=FWD_TOL)


def test_apply_rotary_qk_matches_reference_composition():
    """The serving forwards' RoPE (`rope_tables` gathers the rows once,
    then one fused call) against the reference's dispatcher on its
    plain two-call composition."""
    q, k, pos, _, _ = _rotary_case(3)
    jc, js = jops.build_rope_cache(64, 128, 10000.0)
    jq, jk = jops.apply_rotary_qk(jnp.asarray(q), jnp.asarray(k), jc, js,
                                  jnp.asarray(pos), use_pallas=False)
    tc, ts = rotary.build_rope_cache(64, 128, 10000.0)
    b, s = pos.shape
    cos_t, sin_t = rotary.rope_tables(tc, ts, b, s,
                                      torch.from_numpy(pos).long())
    tq, tk = trotary.fused_rotary_qk(torch.from_numpy(q), torch.from_numpy(k),
                                     cos_t, sin_t, device="cpu")
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=FWD_TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=FWD_TOL)
    tq1 = rotary.apply_rotary(torch.from_numpy(q), tc, ts,
                              torch.from_numpy(pos).long())
    np.testing.assert_allclose(tq1.numpy(), np.asarray(jq), atol=FWD_TOL)


def test_fused_rotary_bf16_matches_pallas_kernel():
    q, k, _, cos_t, sin_t = _rotary_case(5)
    jq, jk = jrotary.fused_rotary_qk(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(cos_t), jnp.asarray(sin_t))
    tq, tk = trotary.fused_rotary_qk(
        torch.from_numpy(q).bfloat16(), torch.from_numpy(k).bfloat16(),
        torch.from_numpy(cos_t), torch.from_numpy(sin_t), device="cpu")
    _bf16_close(tq, torch.from_numpy(np.asarray(jq, np.float32)))
    _bf16_close(tk, torch.from_numpy(np.asarray(jk, np.float32)))


# --------------------------------------------------------------- swiglu
def test_fused_swiglu_matches_pallas_kernel():
    g, u = _rand((16, 256), 0), _rand((16, 256), 1)
    ref = jswiglu.fused_swiglu(jnp.asarray(g), jnp.asarray(u))
    out = tswiglu.fused_swiglu(torch.from_numpy(g), torch.from_numpy(u),
                               device="cpu")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FWD_TOL)


def test_swiglu_matches_reference_composition_on_strided_views():
    """The MLP's call: gate/up are strided views of the fused [.., 2, I]
    projection; fp32 against the reference's plain `silu(g) * u`."""
    gu = _rand((2, 8, 2, 256), 4)
    ref = jops.swiglu(jnp.asarray(gu[:, :, 0]), jnp.asarray(gu[:, :, 1]),
                      use_pallas=False)
    t = torch.from_numpy(gu)
    out = swiglu(t[:, :, 0, :], t[:, :, 1, :])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FWD_TOL)


def test_fused_swiglu_bf16_rounds_once_like_pallas_kernel():
    g, u = _rand((16, 256), 6), _rand((16, 256), 7)
    ref = jswiglu.fused_swiglu(jnp.asarray(g, jnp.bfloat16),
                               jnp.asarray(u, jnp.bfloat16))
    out = tswiglu.fused_swiglu(torch.from_numpy(g).bfloat16(),
                               torch.from_numpy(u).bfloat16(), device="cpu")
    _bf16_close(out, torch.from_numpy(np.asarray(ref, np.float32)))


# ------------------------------------------------------ paged attention
def _paged_case(seed, dtype=np.float32):
    """hd 128, GQA group 2, mixed depths, one inactive slot on the null
    page (the reference's own parity case plus the inactive row)."""
    S, P, ps, n_kv, nq, hd = 4, 9, 8, 2, 4, 128
    kp = _rand((P, ps, n_kv, hd), seed, dtype)
    vp = _rand((P, ps, n_kv, hd), seed + 1, dtype)
    q = _rand((S, nq, hd), seed + 2, dtype)
    table = np.array([[1, 2, 3, 0], [4, 5, 0, 0], [6, 7, 8, 0],
                      [0, 0, 0, 0]], np.int32)
    positions = np.array([20, 9, 17, 0], np.int32)
    return q, kp, vp, table, positions


def test_paged_attention_matches_pallas_kernel():
    q, kp, vp, table, positions = _paged_case(3)
    ref = jpaged.paged_attention(*map(jnp.asarray,
                                      (q, kp, vp, table, positions)))
    out = tpaged.paged_attention(*map(torch.from_numpy,
                                      (q, kp, vp, table, positions)),
                                 device="cpu")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FWD_TOL)


def test_paged_attention_matches_reference_composition():
    """Against the reference's plain gather + `_attend_cached`."""
    q, kp, vp, table, positions = _paged_case(8)
    S, nq, hd = q.shape
    dense = lambda pool: jnp.asarray(pool[table].reshape(S, -1,
                                                         *pool.shape[2:]))
    ref = jgen._attend_cached(jnp.asarray(q)[:, None], dense(kp), dense(vp),
                              jnp.asarray(positions), hd ** -0.5)[:, 0]
    out = tpaged.paged_attention(*map(torch.from_numpy,
                                      (q, kp, vp, table, positions)),
                                 device="cpu")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FWD_TOL)


def test_paged_attention_ignores_stale_bytes_past_each_position():
    """Freed and null pages hold stale bytes: NaN there, past every
    slot's position, must not reach the output (0 * NaN is NaN)."""
    q, kp, vp, table, positions = _paged_case(9)
    clean = tpaged.paged_attention(*map(torch.from_numpy,
                                        (q, kp, vp, table, positions)),
                                   device="cpu")
    ps = kp.shape[1]
    for s in range(table.shape[0]):
        for j in range(table.shape[1] * ps):
            if j > positions[s] and table[s, j // ps] != 0:
                kp[table[s, j // ps], j % ps] = np.nan
                vp[table[s, j // ps], j % ps] = np.nan
    kp[0, 1:], vp[0, 1:] = np.nan, np.nan
    out = tpaged.paged_attention(*map(torch.from_numpy,
                                      (q, kp, vp, table, positions)),
                                 device="cpu")
    assert torch.isfinite(out).all()
    np.testing.assert_array_equal(out.numpy(), clean.numpy())


def test_paged_attention_rejects_what_the_kernel_does_not_take():
    q, kp, vp, table, positions = map(torch.from_numpy, _paged_case(1))
    with pytest.raises(ValueError):
        tpaged.paged_attention(q, kp, vp, table.long(), positions,
                               device="cpu")
    with pytest.raises(ValueError):
        tpaged.paged_attention(q[:, :3], kp, vp, table, positions,
                               device="cpu")
    with pytest.raises(ValueError):
        tpaged.paged_attention(q.double(), kp, vp, table, positions,
                               device="cpu")


# ---------------------------------------------- the wrappers' contract
@pytest.mark.parametrize("call", ["paged", "rotary", "swiglu"])
def test_wrappers_default_to_the_card(monkeypatch, call):
    """Default device is "cuda": with no card, CPU inputs without
    device="cpu" raise instead of quietly running the plain version,
    and the plain version never counts as a launch."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod, args = {
        "paged": (tpaged, map(torch.from_numpy, _paged_case(2))),
        "rotary": (trotary, map(torch.from_numpy, _rotary_case(2)[:2]
                                + _rotary_case(2)[3:])),
        "swiglu": (tswiglu, (torch.ones(8, 128), torch.ones(8, 128))),
    }[call]
    args = list(args)
    fn = {"paged": tpaged.paged_attention,
          "rotary": trotary.fused_rotary_qk,
          "swiglu": tswiglu.fused_swiglu}[call]
    with pytest.raises(RuntimeError):
        fn(*args)
    before = mod.launches
    fn(*args, device="cpu")
    assert mod.launches == before


def test_exported_symbols_match_the_wrappers():
    """Each wrapper's C symbol is exported by its source, with as many
    parameters as the wrapper's argtypes declare — checked here, where
    no compiler runs."""
    for mod, src in ((tpaged, "paged_attention"), (trotary, "rotary"),
                     (tswiglu, "swiglu")):
        text = (build.CSRC / f"{src}.cu").read_text()
        for sym in mod._SYMBOLS.values():
            m = re.search(rf"HETU_EXPORT int {sym}\(([^)]*)\)", text)
            assert m, f"{sym} not exported by {src}.cu"
            assert len(m.group(1).split(",")) == len(mod._ARGTYPES), sym
    assert set(build.SOURCES) == {p.stem for p in build.CSRC.glob("*.cu")}
