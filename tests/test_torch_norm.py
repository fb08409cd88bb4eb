"""The fused residual norm's launch plan (`ops/cuda/fused_norm.py`
`launch_plan`), checked on the CPU where no compiler or card runs: every
width the wrapper takes gets a plan that covers the row within a
block's limits and one of the kernels' instantiations; the scalar arm
runs exactly where a width or a pointer is off 16 bytes; the Python
tables mirror csrc/fused_norm.cu."""
from __future__ import annotations

import re

import pytest
import torch

from hetu_tpu_torch.ops.cuda import build
from hetu_tpu_torch.ops.cuda import fused_norm as fn

DTYPES = (torch.float32, torch.bfloat16)


def _esize(dtype) -> int:
    return torch.finfo(dtype).bits // 8


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_every_width_gets_a_plan_within_a_blocks_limits(dtype, backward):
    """hidden 1 .. MAX_HIDDEN: a warp-multiple of threads a row, at most
    MAX_THREADS a block, chunks enough to cover the row and no warp
    wholly past it, an instantiated VPT; the forward's narrow rows share
    a block up to 256 threads, the backward's rows a block up to
    MAX_THREADS, and its grid is one wave: a block an SM, two where a
    thread holds one chunk (`kBlocksPerSm`)."""
    sms, vec = 132, 16 // _esize(dtype)
    for hidden in range(1, fn.MAX_HIDDEN + 1):
        for rows in (1, 7, 8193):
            p = fn.launch_plan(hidden, dtype, rows, (0,),
                               backward=backward, sms=sms)
            chunks = -(-hidden // vec)
            block = p.threads * p.block_rows
            assert p.vpt in fn.INSTANCES[dtype], (hidden, p)
            assert p.threads % 32 == 0 and 32 <= block <= fn.MAX_THREADS
            assert p.threads * p.vpt >= chunks, (hidden, p)
            assert (p.threads - 32) * p.vpt < chunks, (hidden, p)
            cap = fn.MAX_THREADS if backward else 256
            assert p.block_rows == 1 or block <= cap, (hidden, p)
            assert p.block_rows == min(rows, max(1, cap // p.threads))
            groups = -(-rows // p.block_rows)
            wave = sms * (2 if p.vpt == 1 else 1)
            assert 1 <= p.grid <= (min(groups, wave) if backward
                                   else groups)


@pytest.mark.parametrize("dtype", DTYPES)
def test_plan_spreads_the_models_rows_as_designed(dtype):
    """GPT-2-large's 1280 in bf16 is 160 chunks: 160 threads of one, no
    masked slot; Llama's 4096 256 threads of two; the draft's 2048 256
    threads of one; a thread holds at most 16 values where the row fits
    256 threads."""
    want = {torch.bfloat16: {1280: (1, 160), 4096: (2, 256),
                             2048: (1, 256), 8192: (2, 512)},
            torch.float32: {1280: (2, 160), 4096: (4, 256),
                            2048: (2, 256), 8192: (4, 512)}}[dtype]
    for hidden, (vpt, threads) in want.items():
        p = fn.launch_plan(hidden, dtype, 4096, (0,), backward=False,
                           sms=132)
        assert (p.vpt, p.threads, p.block_rows) == (vpt, threads, 1)
        assert p.vpt * 16 // _esize(dtype) <= 16


@pytest.mark.parametrize("dtype", DTYPES)
def test_scalar_arm_exactly_where_alignment_fails(dtype):
    """The vector arm needs a width of whole 16-byte chunks and every
    pointer on a 16-byte boundary; anything else takes the scalar arm."""
    esize = _esize(dtype)
    for hidden in range(1, 300):
        for ptrs in ((0, 256), (0, 256 + esize), (8, 0), (4096, 16)):
            p = fn.launch_plan(hidden, dtype, 3, ptrs, backward=True,
                               sms=132)
            aligned = (hidden * esize) % 16 == 0 and all(
                q % 16 == 0 for q in ptrs)
            assert p.scalar == (not aligned), (hidden, ptrs)
    # a tensor one element off a 16-byte boundary, as the card tests
    # build it
    buf = torch.empty(1 + 4 * 1280, dtype=dtype)
    view = buf[1:].view(4, 1280)
    assert fn.launch_plan(1280, dtype, 4, (view.data_ptr(),),
                          backward=False, sms=132).scalar
    assert not fn.launch_plan(1280, dtype, 4, (buf.data_ptr(),),
                              backward=False, sms=132).scalar


def test_plan_backward_is_one_wave_and_forward_a_block_a_row_group():
    p = fn.launch_plan(4096, torch.bfloat16, 4096, (0,), backward=True,
                       sms=132)
    assert (p.grid, p.block_rows) == (132, 2)   # 2 rows of 256 threads
    p = fn.launch_plan(1280, torch.bfloat16, 8192, (0,), backward=True,
                       sms=132)
    assert (p.grid, p.block_rows) == (264, 3)   # 3 rows of 160, 2 an SM
    p = fn.launch_plan(1280, torch.bfloat16, 7, (0,), backward=True,
                       sms=132)
    assert (p.grid, p.block_rows) == (3, 3)     # fewer row groups than SMs
    p = fn.launch_plan(2048, torch.bfloat16, 256, (0,), backward=False,
                       sms=132)
    assert p.grid == 256                     # the draft: a block a row
    p = fn.launch_plan(64, torch.bfloat16, 10 ** 7, (0,), backward=False,
                       sms=132)
    assert p.grid == 65535                   # grid-stride beyond


def test_norm_tables_mirror_the_source():
    """`INSTANCES` and `MAX_THREADS` are csrc/fused_norm.cu's `kMaxVpt`
    (fp32, and its bf16 and fp16 specialisations) and `kMaxThreads`;
    MAX_HIDDEN is the widest row the widest instantiation covers; every
    entry point takes the plan's five ints and the stream after eps."""
    text = (build.CSRC / "fused_norm.cu").read_text()
    threads = int(re.search(r"constexpr int kMaxThreads = (\d+);",
                            text).group(1))
    vpt_f32 = int(re.search(r"constexpr int kMaxVpt = (\d+);",
                            text).group(1))
    vpt_bf16 = int(re.search(
        r"constexpr int kMaxVpt<__nv_bfloat16> = (\d+);", text).group(1))
    vpt_f16 = int(re.search(
        r"constexpr int kMaxVpt<__half> = (\d+);", text).group(1))
    assert threads == fn.MAX_THREADS
    powers = lambda top: tuple(1 << i for i in range(top.bit_length()))
    assert fn.INSTANCES == {torch.float32: powers(vpt_f32),
                            torch.bfloat16: powers(vpt_bf16),
                            torch.float16: powers(vpt_f16)}
    assert re.search(r"constexpr int kBlocksPerSm = VPT == 1 \? 2 : 1;",
                     text)
    for dtype, vpts in fn.INSTANCES.items():
        assert fn.MAX_THREADS * max(vpts) * 16 // _esize(dtype) \
            == fn.MAX_HIDDEN
    for sym in fn._SIGNATURES:
        m = re.search(rf"HETU_EXPORT int {sym}\(([^)]*)\)", text)
        params = [a.split()[-1] for a in m.group(1).split(",")]
        assert params[params.index("eps"):] == [
            "eps", "vpt", "threads", "block_rows", "grid", "scalar",
            "stream"], sym
