#!/usr/bin/env python3
"""Smoke run of the PyTorch port (hetu_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure exits non-zero and nothing carries on:

 1. the card: `nvidia-smi` name and power limit, `torch` device name
    (no CUDA device -> exit 1 before anything else runs);
 2. build: every CUDA kernel from hetu_tpu_torch/csrc, one nvcc per
    source, all at once; prints the ptxas report (registers, shared
    memory, spills) and the build time, then the 16-bit flash kernels'
    (dq, forward, dk/dv; bf16 and fp16 instantiations), the
    paged kernels' (split and merge), the SwiGLU forward's, RoPE's,
    the four fused-norm kernels', the quantize's and the page write's
    (tokens and pages) registers and spills; a
    (C7520) warning (ptxas serialising wgmma) fails the run;
 3. kernels: each kernel at the shapes each path gives it for Llama-3-8B
    (serving: decode and a 256-token prefill chunk, checked here;
    training: 2 x 2048 tokens per micro-batch, every kernel of that
    path, SwiGLU and RoPE forward again at its shapes, checked after
    phase 6, so their large buffers and CUDA graphs never precede the
    host-bound serving run), held against its plain PyTorch version on
    the same inputs at the stated tolerance, and timed on the card
    (CUDA-graph replay, CUDA events) beside its plain version, its
    bound — the larger of the bytes it must move over 3.35 TB/s and its
    operations over the peak rate of their type (fp32 math outside the
    tensor cores, 67 TFLOP/s; the flash kernels' products, the
    sampler's LM head and the second serving slice's attention against
    the bf16 tensor-core peak, 989 TFLOP/s) — and, where one PyTorch call
    computes the same function, that call (`torch._fused_adamw_` for
    AdamW, `scaled_dot_product_attention` for the flash kernels,
    `torch.mm` with fp32 output for the sampler's product; timed
    as yardsticks only, the port never calls them), else the few
    PyTorch calls that compose it, one CUDA graph (SwiGLU: `F.silu(g) *
    u` on the bf16 halves; RoPE: the half-split rotation's ops on the
    bf16 tensors); RoPE also as the LLaMA attention calls it, q and k
    read in place from the fused QKV projection (the training shape
    and the draft's); the RMS norm's scalar arm (`norm_scalar_cases`:
    the training shape one element off a 16-byte boundary, the vector
    arm's bits, and hidden 4092); AdamW through its
    multi-tensor launch, beside the rates PyTorch's copy and add reach
    at the same size, its bf16 leaf again with the device-side skip
    flag clear (the bits of a launch without it) and set (p, m and v
    byte for byte as before); dq and dk/dv run twice give the same bits, and
    so does every paged case (its splits merged in a fixed order).
    Tolerances:
    one bf16 ulp where a kernel rounds once to bf16 (paged attention on
    bf16 pools: the plain version on the same values in fp32, rounded
    once — half an ulp, plus 1e-5 for fp32 summation order); fp32
    outputs 1e-5 relative (the norm's dw, a sum over 4096 rows taken in
    another order: 1e-5 of its largest entry); AdamW one fp32 ulp
    (rtol 3e-7), its bf16 parameter one bf16 ulp; the flash kernels as
    `flash_kernel_phase` states; the second serving slice's kernels
    (int8/int4 paged attention, the verify kernel, the blockwise
    quantize, the page write, the sampler) as `serving2_kernel_phase`
    states (the page write beside the parent tree's quantize +
    scatters, its pools byte for byte); the
    blockwise dequantize (the draft model's embedding [128256 x 2048]
    at blocks 128 and 64, payloads [4096, 64] and [4096, 128], bf16 and
    fp32 out) bit for bit (`serving3_kernel_phase`);
 4. serving reference: Llama-3-8B widths cut to 1 layer, in fp32 — the
    serving engine on the card (the kernels) against the same engine on
    the CPU (the plain versions), same weights and trace: prefill logits
    within 1e-3 and identical greedy tokens; then, half the requests
    seeded-sampled, n-gram speculation on exact pages (tokens
    identical), on int8 pages and sampled decode on int4 pages (tokens
    identical, or the first divergence at a token whose CPU top-two gap
    after noise is under 1e-3; the int4 run's launch counts are its
    path's); the two speculative runs again with a drafter that proposes
    the CPU's own continuation without speculation (the CPU's tokens
    equal it, the card's the CPU's as above, and the card accepts
    drafts); then the third serving slice (`reference_serving3_phase`):
    the prefix cache with the model drafter built by the engine from
    `draft_model=` (a narrow draft) and passed as `drafter=` (a copy of
    the target at temperature 0, drafts accepted), greedy, card tokens
    equal to the CPU's and to the run without speculation;
 5. serving: Llama-3-8B at full width, depth cut to 8 layers (bf16
    weights drawn on
    the card from --seed) behind `ServingEngine(ServeConfig(num_slots=8,
    page_size=16, max_len=2048, prefill_chunk=256))`: warmup, then 8
    Poisson-arriving requests with 64-1024-token prompts and 32 new
    tokens each.  Every launch count is set to 0 just before the run and
    read just after; each serving kernel must have launched;
 6. serving time: one decode step over 8 slots and one 256-token
    prefill chunk, each timed on the host (enqueue, and wall to a
    synchronize) and under torch.profiler (the summed time of the
    kernels it saw on the card): the card's idle share, its heaviest
    kernels and the paged kernels' time and share of it; both again as
    they ran before RoPE read q and k in place from the fused projection
    (q and k copied first), which must cost exactly 2 x the layers more
    device operations, and the decode step again with the parent tree's page
    writes (`parent_page_writes`: a scatter a tensor), at least one more
    device operation a layer; then the same
    model and trace with half the requests at
    SamplingParams(temperature=0.8, top_k=50, top_p=0.95) on int8 pages,
    (b) without speculation, then (a) with n-gram speculation (spec_k
    4), then (a) again with (a)'s own continuation as its drafts (its
    tokens equal (a)'s, and it accepts drafts): every request ends by
    length with 32 tokens, no page leaks, every launch count exact
    (verify: paged_verify layers a step, fused_sample once a step, its
    product on the N-major tensor-core arm, the
    page write once a layer a step and once a prefill, the draw over
    existing logits once a sampled request's first token; decode: the
    int8 arm layers a step and the draw once a step instead); TTFT, the
    decode gap, tokens/s, acceptance, tokens a verify step and peak
    memory; a sampled decode step of (b) and a verify step of (a)
    profiled as phase 6 does, with their device operations a step,
    and the decode forward and the verify step again with the parent's
    page writes (a quantize of a copy and two scatters a tensor);
    then the third serving slice ("serving3", `serving3_phase`): a
    Llama-3.2-1B-width draft model resident in int8 drafting for the
    same target, verified by the stochastic rule on int8 pages with the
    prefix cache, 16 requests sharing a 512-token system prompt (exact
    launch counts; TTFT, gap, tokens/s, acceptance, prefix hits, draft
    ms a propose, peak memory; one propose, one draft forward and one
    verify step profiled, with the paged kernels' share; the draft
    forward again with q and k copied before RoPE: exactly 2 x 16 more
    device operations), and the same trace greedy
    on exact pages with the prefix cache and without it (TTFT of both,
    tokens identical);
 7. training reference: a narrow Llama (hidden 512, 4 q / 2 kv heads of
    128, SwiGLU 1536, vocab 4096, 2 layers, fp32, flash attention,
    recompute policy "dots_attn") takes 3 `Trainer` steps on the card
    (the kernels; flash's fp32 arm) and on the CPU (the plain versions)
    from the same weights and batches: losses and grad norms within
    1e-5 relative; parameters within 2 x the summed lr everywhere and
    within 1e-5 on all but 0.1% of elements (AdamW divides by sqrt(v),
    so a gradient within rounding of zero moves its element by up to lr
    in one run and not the other);
 8. training: Llama-3-8B at full width cut to 8 layers (fp32 parameters
    and AdamW state, bf16 compute, flash attention, recompute policy
    "dots_attn": the reference benchmark's training configuration)
    through `Trainer(model, TrainingConfig(global_batch_size=4,
    micro_batch_size=2, seq_len=2048), device="cuda").train(...)`, 6
    steps on one repeated seeded batch.  Every launch count is set to 0
    just before and read after each step: each training kernel must
    grow by exactly its count per step (norm, RoPE and SwiGLU forwards
    2 x layers x micro-batches — every policy recomputes them; the flash
    forward and every backward kernel layers x micro-batches — the
    policy keeps o and lse; AdamW once a step, one launch over every
    parameter leaf).  The first
    loss lies within 0.5 of ln(vocab) + sigma^2 / 2 (sigma = 0.02 *
    sqrt(4096), the logits' spread at init), every loss is finite and
    the last is below the first.  Prints step time p50, tokens/s, mfu
    (model FLOPs per token, no recompute, over 989 TFLOP/s), peak
    memory; then one step under torch.profiler (idle share, heaviest
    kernels, the time of each ported kernel in the step, the attention's
    from its three kernels; every dq kernel the profiler sees must be
    the bf16 Hopper kernel) and flash attention, the dense attention
    and the LM head + loss timed apart at the step's shapes.  Past
    70 GiB of peak memory the micro-batch halves (printed as a cut).
    Then the first training slice's path — the dense attention, whole
    blocks recomputed (policy "nothing") — at 2 layers for 2 steps, with
    its launch counts (every forward kernel twice, no flash kernel).
    "dots_attn" keeps the reference's set (the projections' outputs and
    the attention's, not the projections' inputs): the peak is printed
    beside 60.84 GiB, the peak when the projections' inputs were kept
    too (PERF.md).
 9. GPT kernels (`gpt_kernel_phase`): the fused norm's LayerNorm
    arm at GPT-2-large's training shape [8192, 1280], forward and
    backward, bf16 and fp32, with a bias, each timed beside its plain
    version, its bound and the composition it replaces (`x + h` then
    `F.layer_norm`; aten's layer-norm backward then `+ dr`: one CUDA
    graph each; the RMS arm is timed beside `x + h` then `F.rms_norm`,
    and PyTorch's rms_norm backward then `+ dr`, the same way);
    scale-only, hidden 1000 and one row checked, and the scalar arm
    (the training shape one element off a 16-byte boundary, the vector
    arm's bits; hidden 1004 bf16 and 1002 fp32); every other kernel of
    the GPT paths at their own shapes, bf16, timed as in phase 3: the
    three flash kernels at q/kv [8, 1024, 20, 64] causal (group 1),
    paged attention on exact and int8 pages (8 slots, 20 q and kv
    heads of 64, pages of 16, 64 a slot), the verify kernel on int8
    pages (q [8, 5, 20, 64]), the blockwise quantize at block 64 (a
    decode step's K of one layer, [160, 64], and a prompt's K of every
    layer, [552960, 64]), the page write (decode [8, 1, 20, 64] on exact
    and int8 pages, a 768-token prefill over 36 layers), and the fused
    sampler over the tied head, a
    transposed view of `wte` (the product's K-major arm, beside
    `product_yardstick`); AdamW over GPT-2-large's 436 leaves with
    a 1,001-element leaf and a view off a 16-byte boundary, one launch;
10. GPT reference: GPT-2-large widths cut to 2 layers, fp32, the engine
    on the card and on the CPU (greedy tokens identical), then 3
    `Trainer` steps on both to phase 7's tolerances;
11. GPT training: `GPTConfig.gpt2_large()` at full depth (36 layers,
    774.0M parameters, fp32 parameters and AdamW state, bf16 compute,
    flash attention, policy "nothing") through
    `TrainingConfig(global_batch_size=16, micro_batch_size=8,
    seq_len=1024)`, 6 steps on one seeded batch, launch counts exact
    each step (LayerNorm forward 2 x 36 x 2, backward 36 x 2; flash
    forward 144, dq and dk/dv 72; AdamW 1), the loss check of phase
    8, step p50, tokens/s, mfu, peak memory, and one step profiled as
    phase 8 profiles its;
12. GPT serving: GPT-2-large in bf16 behind ServeConfig(num_slots=8,
    page_size=16, max_len=1024, prefill_chunk=256), 8 Poisson requests
    at 10/s with 64-768-token prompts and 32 new tokens each: greedy on
    exact pages, then the odd requests sampled on int8 pages without
    and with n-gram speculation; exact launch counts (the page write
    once a layer a step and once a prefill on every path; the verify
    step's `fused_sample` products all on the K-major tensor-core arm,
    none on the FMAs), TTFT, gap,
    tokens/s, peak memory; then one 256-token prefill chunk timed with
    an int start (the engine's) and with a [1] start (the per-row
    scatter), logits and caches identical;
13. the draft forward's elementwise kernels (`draft_kernel_phase`):
    RoPE at q [1,256,32,64] / k [1,256,8,64] (contiguous, and read in
    place from the fused projection [1,256,8,4+2,64]), SwiGLU at [256,
    8192] and the RMS forward at [256, 2048], bf16, timed as phase 3
    times them (the RMS forward beside `x + h` then `F.rms_norm`);
14. the third training slice ("training3"): (a) GPT-2-large widths cut
    to 2 layers, bf16 parameters, fp32 compute, `loss_scale="dynamic"`,
    dropout 0.1 / 0.1 keyed by the step, 3 `Trainer` steps on the card
    and on the CPU to phase 7's tolerances, every dropout mask of the
    run equal on both; then a step at the largest fp32 scale on a batch
    of one token: AdamW's launch writes nothing (p, m, v byte for byte),
    its step count stays, the scale halves; (b) GPT-2-large's widths
    (12 of its 36 layers, dropout 0.1 / 0.1, bf16 parameters, the dynamic scale,
    policy "nothing", `TrainingConfig(16, 8, 1024, seed=1, ...)`,
    checkpoints every 3 steps, 1 kept): 6 steps, then a fresh model and
    trainer restored from the step-3 checkpoint (hard-linked aside as a
    crash after step 3 leaves it) take steps 4-6 — losses, grad norms,
    scales and every parameter bit for bit the uninterrupted run's;
    exact launch counts (LayerNorm forward 144, backward 72, no flash:
    attention dropout runs the dense attention, AdamW once on its bf16
    arm), phase 8's loss checks, step p50, tokens/s, mfu, peak memory,
    one step profiled (the dropout hash's int64 kernels) and the dropout
    timed apart, checkpoint bytes, the host's time blocked in `save`,
    the write's and the restore's; (c) Llama-3-8B widths cut to 8
    layers, bf16 parameters, flash, `TrainingConfig(4, 2, 2048)`, 3
    steps under "dots_attn" and under "offload" (exact launch counts:
    the flash forward once a layer and micro-batch under "dots_attn",
    twice under "offload", which keeps the "dots" set on the host), step
    p50, tokens/s, mfu, peak memory and the bytes staged to the host a
    step.  The phase prints its wall time.
15. the fourth training slice ("training4"): (a) every fp16 arm (the
    flash forward, dq and dk/dv; the fused RMS and LayerNorm forward and
    backward; SwiGLU and RoPE forward and backward) against its plain
    version at the training shapes of the bf16 rows — flash also over a
    packed batch's segments — timed beside its bound, its plain version
    and its yardstick (`training4_kernel_phase`); (b) a narrow Llama in
    fp16 over fp32 parameters, card vs CPU, 3 `Trainer` steps on packed
    batches with the scale on "auto", then a forced overflow: both
    sides skip and halve alike (`training4_reference_phase`); (c) each
    sequence of two packed rows scored as alone, on the card
    (`training4_packed_phase`); (d) Llama-3-8B widths cut to 8 layers in
    fp16, "dots_attn", 6 steps on packed rows made by the collator
    (`TrainingConfig(4, 2, 2048, packing=True)`, at least 85% of the
    slots real tokens): exact launch counts on the fp16 arms, the loss
    falls, step p50, tokens/s over slots and real tokens, mfu, peak
    memory, the scale's course, one step profiled; (e) GPT-2-large in
    fp16, 3 steps through `Trainer.train` over the padded prefetching
    `build_data_loader` (`training4_gpt_phase`).  The phase prints its
    wall time.

16. LoRA fine-tuning ("lora") with the run-log, health and numerics
    hooks: (a) a narrow Llama ("dots_attn": segments keep W, A and B and
    merge again in the backward) and a narrow GPT ("nothing": whole
    blocks rebind their adapters), bf16 base, fp32 compute, flash, LoRA
    rank 4 on every reference target, 4 `SFTTrainer` steps on the card
    and on the CPU from one base and one set of adapters, the numerics
    collector on: phase 15's limits on losses, grad norms, moments and
    the adapters' AdamW-direction bound, the last step's numerics record
    key for key (`lora_reference_phase`); (b) Llama-3-8B at full width
    cut to 8 layers (bf16 frozen base), `LoRAConfig(rank=16)`,
    `TrainingConfig(8, 2, 2048)`, 4 steps on a chat batch through
    `build_sft_example`, every hook flag on: exact launch counts by arm,
    the loss falling, the base's fingerprint unchanged, peak memory at
    most 70 GiB, step p50 and max, tokens/s over slots and loss tokens,
    mfu, idle share, the run log's records and anomalies, the numerics'
    device operations a record step (`lora_llama_phase`); (c) two
    tasks' adapters through `schedule_micro_batches` and
    `MultiTaskSFTEngine` on the card: each task's adapters change only
    on its own rows (`lora_multitask_phase`); (d) phase 8's step cut to
    2 layers with the flags unset: launches by arm and device operations
    equal those with the hooks' call sites taken out
    (`lora_identity_phase`).  Phase 3's SwiGLU backward rows (bf16 and
    fp16) are timed beside autograd's backward of `F.silu(g) * u`.
17. the serving host layers ("serving4", `serving4_phase`), Llama-3-8B
    at full width, 8 layers, in bf16, one model shared by every engine,
    `ServeConfig(8, page_size=16, max_len=2048, prefill_chunk=256)`, 24
    requests in bursts of 8 at 20/s (prompts 64-1,024, 32 new; gold and
    bulk classes, tenants acme and free, half sampled): (a) the
    undisturbed run, then preemption, free capped at 3 slots, deadlines,
    a retry budget of one, brownout, a run log, the tracer, health and a
    cost model, and an `engine_kill` at step 40 through `run(on_step=)`
    — every completed request's tokens equal the undisturbed run's,
    preemptions and quota stalls happen, the kill requeues every live
    slot, the scheduler's invariants hold before every step, the SLO
    report reconciles every request's spans with zero residual and the
    record keys equal a CPU run's; both again with n-gram speculation;
    (b) a 2-slot `PrefillWorker` and a decode engine over the exact,
    int8 and int4 wires (bytes a shipment as predicted, a real scratch
    within each wire's grid, the exact wire's tokens the colocated
    run's, the int8 wire's quantize and dequantize launches 2 a pack and
    2 an unpack) and the exact wire under a shipment storm and a prefill
    kill (survivors' tokens equal, invariants each coordinator step);
    ship times (pack, adopt, pack to adopt) and TTFT against the
    colocated run; (c) two replicas behind a `Frontend` (free capped at
    3 live across both, hedging after 2 router steps, replica 0 killed
    at step 12 for 6 steps), the single replica's tokens, then a drain
    and a rejoin.  The phase prints its wall time and peak memory.
18. Mixture-of-Experts ("moe", `moe_phase`): (a) a narrow MoE Llama
    (2 layers, hidden 256, 8 experts, top-2, fp32, capacity factor 0.5)
    card vs CPU under each of the six gates: logits within 1e-4, every
    layer's routing plan equal (a plan that differs must hold a counted
    near-tie, a gate margin under 1e-6), greedy engine tokens equal;
    (b) Mixtral-8x7B widths cut to 12 layers, bf16, phase 5's trace with
    the odd requests sampled, served with the experts as they are,
    resident in int8, resident in int4, and in int8 with n-gram
    speculation: exact launch counts (quantize 2 x layers at build,
    dequantize 2 x layers a forward, SwiGLU layers a forward), the int8
    and int4 tokens equal to the dequantized weights' served as they
    are, the speculative run's tokens equal to the int8 run's but where
    a verify step's capacity dropped one of the request's pairs first,
    TTFT, decode step, tokens/s, peak memory and a decode step's device
    work against its host enqueue; (c) 2 layers trained in bf16 with
    flash and "dots_attn", `TrainingConfig(8, 2, 2048)`, 4 steps: exact
    launch counts, phase 8's loss checks, peak at most 70 GiB, `mfu`
    over the active parameters beside the reference's `flops_per_token`
    (all 8 experts); (d) SwiGLU forward at [64 / 640 / 10240, 14336]
    and backward at [10240, 14336], the quantize (int8 and the int4
    grid) and dequantize of a layer's expert leaves at block 256, each
    against its plain version and timed, the dequantize beside
    PyTorch's per-channel qint8 `dequantize`.
19. fp16 serving ("serving_fp16", `serving_fp16_phase`): (a) every fp16
    arm of the serving kernels at Llama-2-7B's shapes against its plain
    version, timed beside its bound, its library call and its bf16 arm
    on the same work in this call: paged decode q [8, 32, 128] and
    verify [8, 5, 32, 128] over 32 kv heads at depths 40-1,100 in the
    three page modes (o within one fp16 ulp + 1e-5, two runs the same
    bits), `write_kv_tokens` [8, 1 | 5, 32, 128] and `write_kv_pages`
    (32 layers x 1,024 positions) byte for byte, the product + draw at
    hidden [40, 4096] x head [4096, 32000] (library `torch.mm` in fp16
    with fp32 out) and GPT's tied [1280, 50257] (K-major), the draw over
    fp16 logits [8 | 40, 32000], the quantize and the dequantize to fp16
    at the TinyLlama draft's matrices, bit for bit; (b) a narrow fp16
    Llama with Llama-2's geometry (MHA, 4 heads of 128, vocab 32000,
    2 layers) card vs CPU: greedy on fp16 exact pages, sampled + n-gram
    on int8 and on int4 pages, tokens equal but after a counted near-tie
    of fp16 logits (`F16_NEAR_TIE`); (c) Llama-2-7B as published in fp16
    (depth cut to 16 layers: phase 20 (d) serves Llama-2-13B at full
    depth) behind phase 5's `ServeConfig` and trace: greedy on fp16
    exact pages, sampled on int8 pages, with n-gram speculation, with
    its own continuation as drafts (the same tokens, drafts accepted),
    sampled on int4 pages, a TinyLlama-width fp16 draft resident in int8
    with stochastic verify and the prefix cache over 16 requests sharing
    a 512-token prompt; TTFT, gap, tokens/s, peak memory and the fp16
    launches by kernel of each run (every serving kernel's fp16 arm must
    launch), a decode step and a verify step profiled, and the greedy
    run again with the weights cast to bf16, its decode step beside the
    fp16 one.
20. fp16 parameters ("fp16_params", `fp16_params_phase`): (a) AdamW's
    fp16 arm over Llama-2-7B's 8-layer leaf table (1.881 B elements)
    and over a mixed fp32 / bf16 / fp16 list of odd sizes, tails and
    views off 16 bytes, bit for bit against its plain version with the
    skip flag absent, set (nothing written) and clear, timed beside its
    bound, the bf16 arm on the same count and `torch._fused_adamw_`
    (null where it refuses fp16 p with fp32 g, m, v, with its words);
    every kernel of (c) and (d) at Llama-2-13B's widths in fp16 (flash
    [2, 2048, 40, 128], the RMS norm [4096, 5120], SwiGLU [4096, 13824],
    RoPE from the fused projection at group 1, paged decode and the
    page writes at 40 kv heads, the product [40, 5120] x [5120, 32000]);
    (b) a narrow Llama with fp16 parameters and compute card vs CPU: a
    forced overflow (one token everywhere) then 3 steps, the scale's
    course equal, phase 15's limits, the parameters within the AdamW-
    direction bound plus one fp16 ulp a step, a bit-exact resume from
    step 2, LoRA SFT of 2 steps on the fp16 base, the merges within one
    fp16 ulp a rounding; (c) Llama-2-7B as published, 8 layers, fp16
    parameters (`TrainingConfig(4, 2, 2048)`, flash, "dots_attn"), 6
    steps, the third overflowing (skipped, scale halved): exact launch
    counts with AdamW on its fp16 arm, step p50, tokens/s, mfu, peak,
    AdamW's ms a step, bf16 parameters' step p50 beside; (d) Llama-2-13B
    as published at full depth: LoRA rank 16 on its fp16 base,
    `TrainingConfig(8, 2, 2048)`, 3 steps (peak at most 70 GiB), the
    adapters merged, the trainer freed, the merged weights loaded into
    a fresh fp16 model and served with phase 5's config and trace,
    greedy on exact pages and sampled on int8 pages; TTFT, tokens/s,
    peak, a decode step's device busy and host enqueue; then the greedy
    run again under a probe of the engine's logits, and models of the
    same widths at 1 and 10 layers: at each depth the fp16 rounding
    measured against an fp32 forward of the same weights (nu, the
    uncached fp16 forward's largest distance from it), the engine's
    logits within 2 nu of it, and its tokens the uncached forward's
    argmax but at near ties of that forward's logits (a gap under 2 nu).

Each phase's end prints `phase <name>: done at <s>` (where the run's
time goes).  Prints the `kernels` JSON line, the nvidia-smi line, and last the
`{"ok": true, "device": ...}` line; the `kernels` line gives AdamW's
launches by arm ("f32", "bf16", "f16") over the training paths, and
each fp16 arm as an entry of its own (`flash_fwd_f16`, ...,
`rotary_qk_bwd_f16`, since phase 19 `paged_attention_f16`, ...,
`dequantize_blockwise_f16`, and since phase 20 `adam_update_f16`), whose
launches are also in its kernel's entry.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

PEAK_BYTES_PER_S = 3.35e12                 # H100 SXM HBM3
PEAK_OPS_PER_S = {torch.bfloat16: 989e12,  # dense tensor-core bf16
                  torch.float16: 989e12,   # and fp16
                  torch.float32: 67e12}    # fp32 outside the tensor cores
TRAIN_PEAK_GIB = 70.0
_DTYPE_NAMES = {torch.float32: "fp32", torch.bfloat16: "bf16",
                torch.float16: "fp16"}


def check(cond: bool, msg: str):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ptxas_check(report: str, kernel: str):
    """Print the registers, shared memory and spills ptxas reports for
    each instantiation of `kernel`, and fail on a (C7520) warning: ptxas
    serialises a kernel's wgmma.mma_async instructions where a product is
    issued or awaited on a branch of its own.  An empty report means the
    library was already built (nothing to read)."""
    if not report:
        print(f"ptxas {kernel}: library already built, no report")
        return
    check("C7520" not in report,
          "ptxas serialises wgmma (C7520):\n" + "\n".join(
              line for line in report.splitlines() if "C7520" in line))
    lines, entry = report.splitlines(), None
    for line in lines:
        if "Compiling entry function" in line:
            entry = line if kernel in line else None
        elif entry is not None and ("Used" in line or "spill" in line):
            name = entry.split("'")[1] if "'" in entry else entry
            print(f"ptxas {name}: {line.split(':', 1)[-1].strip()}")
    check(any(kernel in line for line in lines),
          f"ptxas reported no {kernel}")


def device_ms(fn, inner: int = 20, reps: int = 5) -> float:
    """Device time of one call: `inner` calls captured in a CUDA graph,
    replayed `reps` times between CUDA events, so host launch overhead
    does not count."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (inner * reps)


def event_ms(fn, reps: int = 5) -> float:
    """Time of one call between CUDA events, after one warm call (for
    work that allocates through autograd and cannot be graph-captured;
    at these sizes the card, not the host, sets the time)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def ulps(n: float, atol: float = 0.0, dtype=torch.bfloat16):
    """Tolerance: |a - b| <= n ulps of `dtype` (bf16: 8 significant bits,
    fp16: 11, and its smallest subnormal below its normal range) at the
    larger of the two + atol; returns how far the worst element goes past
    it (<= 0: within)."""
    fi = torch.finfo(dtype)

    def excess(a, b):
        a, b = a.float(), b.float()
        _, exp = torch.frexp(torch.maximum(a.abs(), b.abs()))
        ulp = torch.maximum(torch.ldexp(torch.full_like(a, fi.eps), exp - 1),
                            torch.full_like(a, fi.tiny * fi.eps))
        return ((a - b).abs() - n * ulp - atol).max().item()
    excess.text = f"{n} {_DTYPE_NAMES[dtype]} ulp + {atol}"
    return excess


def rel(rtol: float, atol: float = 0.0, of_max: bool = False):
    """Tolerance: |a - b| <= rtol * |b| + atol, or with `of_max`
    rtol * max|b| + atol."""
    def excess(a, b):
        a, b = a.float(), b.float()
        scale = b.abs().max() if of_max else b.abs()
        return ((a - b).abs() - rtol * scale - atol).max().item()
    excess.text = (f"{rtol} x {'max|ref|' if of_max else '|ref|'}"
                   f" + {atol}")
    return excess


def same():
    """Tolerance: equal bit for bit (the count of differing elements)."""
    def excess(a, b):
        return float((a != b).sum().item())
    excess.text = "identical"
    return excess


def fp32_ulps(n: float):
    """Tolerance: |a - b| <= n fp32 ulps of the larger of the two."""
    def excess(a, b):
        a, b = a.float(), b.float()
        _, exp = torch.frexp(torch.maximum(a.abs(), b.abs()))
        ulp = torch.ldexp(torch.ones_like(a), exp - 24)
        return ((a - b).abs() - n * ulp).max().item()
    excess.text = f"{n} fp32 ulp"
    return excess


def bound(nbytes: float, ops: float, op_dtype=torch.float32) -> tuple:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[op_dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def compare(label, tols, out, ref):
    """Hold a kernel's outputs against its plain version's, output by
    output with `tols` (one tolerance, or one per output); returns (max
    abs err, worst excess over a tolerance, the tolerances' text)."""
    torch.cuda.synchronize()
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    tols = tols if isinstance(tols, tuple) else (tols,) * len(outs)
    err = max((a.float() - b.float()).abs().max().item()
              for a, b in zip(outs, refs))
    excess = max(t(a, b) for t, a, b in zip(tols, outs, refs))
    check(all(bool(torch.isfinite(a).all()) for a in outs),
          f"{label}: non-finite output")
    check(excess <= 0, f"{label}: kernel disagrees with its plain version "
                       f"(max abs err {err}, {excess} past the tolerance)")
    return err, excess, " / ".join(dict.fromkeys(t.text for t in tols))


def same_bits(label, run):
    """Two launches of `run` on the same inputs give the same bits (the
    paged kernels merge their splits in a fixed order, no atomics)."""
    a, b = run(0), run(0)
    torch.cuda.synchronize()
    check(torch.equal(a, b), f"{label}: two runs differ")
    print(f"kernel {label}: two runs the same bits")


def checked(label, tols, out, ref):
    """A correctness-only case: compared, not timed."""
    err, excess, text = compare(label, tols, out, ref)
    print(f"kernel {label}: max_abs_err={err:.3g} (excess over tolerance "
          f"{excess:.3g}), not timed")
    return {"case": label, "max_abs_err": err, "tolerance": text,
            "excess": excess, "ms": None, "plain_ms": None,
            "bound_ms": None, "bound_by": None, "library_ms": None,
            "composition_ms": None}


def case(label, tols, run, plain, nbytes, ops, *, exact=None, library=None,
         library_ms=None, composition=None, composition_ms=None,
         op_dtype=torch.float32, inner=20):
    """Hold run(0) against plain(0) (or `exact`(0), the plain version on
    the same values in fp32, where given) as `compare` does; then time
    the kernel, its plain version and `library` (one PyTorch call
    computing the same function, a yardstick; or its time `library_ms`
    where the caller measured it) on the card, and `composition` (a few
    PyTorch calls computing it where no one call does, a yardstick too;
    or its time `composition_ms`) the same way.  Each is called with a running count, so a case can
    cycle through copies of its inputs.  `op_dtype` picks the peak rate
    the operations are bound by; `inner` the calls a timed CUDA graph
    holds (fewer where a call allocates hundreds of MB)."""
    err, excess, text = compare(label, tols, run(0), (exact or plain)(0))
    calls = [0]

    def cycled(fn):
        def go():
            calls[0] += 1
            return fn(calls[0])
        return go
    ms = device_ms(cycled(run), inner)
    plain_ms = device_ms(cycled(plain), inner)
    if library:
        library_ms = device_ms(cycled(library), inner)
    if composition:
        composition_ms = device_ms(cycled(composition), inner)
    b_ms, b_by = bound(nbytes, ops, op_dtype)
    res = {"case": label, "max_abs_err": err, "tolerance": text,
           "excess": excess, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
           "composition_ms": composition_ms}
    print(f"kernel {label}: max_abs_err={err:.3g} (excess over tolerance "
          f"{excess:.3g}) ms={ms:.5f} plain_ms={plain_ms:.5f} "
          f"bound_ms={b_ms:.5f} ({b_by})"
          + ("" if library_ms is None else f" library_ms={library_ms:.5f}")
          + ("" if composition_ms is None
             else f" composition_ms={composition_ms:.5f}"))
    return res


# ------------------------------------------------------------ kernels
def paged_case(dtype, seed, copies):
    """Decode at Llama-3-8B's attention shape: 8 slots at mixed depths
    (one inactive, pinned to the null page), 32 q heads over 8 kv heads,
    head dim 128, pages of 16, 128 pages per slot.  `copies` distinct
    pools so timed launches find their pages cold in L2, as decode does
    (a whole step of weight reads separates a layer's two visits)."""
    S, nq, n_kv, hd, ps, mp = 8, 32, 8, 128, 16, 128
    P = S * mp + 1
    g = torch.Generator(device="cuda").manual_seed(seed)
    depths = [2047, 1536, 1100, 777, 400, 130, 17]
    positions = torch.tensor(depths + [0], dtype=torch.int32, device="cuda")
    perm = torch.randperm(P - 1, generator=g, device="cuda") + 1
    table = torch.zeros((S, mp), dtype=torch.int32, device="cuda")
    used = 0
    for s, d in enumerate(depths):
        n = d // ps + 1
        table[s, :n] = perm[used:used + n]
        used += n
    pools = [(torch.randn((P, ps, n_kv, hd), generator=g, device="cuda")
              .to(dtype),
              torch.randn((P, ps, n_kv, hd), generator=g, device="cuda")
              .to(dtype)) for _ in range(copies)]
    q = torch.randn((S, nq, hd), generator=g, device="cuda").to(dtype)
    live = sum(d + 1 for d in depths) + 1          # + the inactive row
    esize = torch.finfo(dtype).bits // 8
    nbytes = (2 * S * nq * hd * esize + table.numel() * 4 + S * 4
              + 2 * live * n_kv * hd * esize)
    ops = 4 * live * nq * hd
    return q, pools, table, positions, nbytes, ops


def serving_kernel_phase(seed: int):
    """The serving kernels at the serving path's shapes."""
    from hetu_tpu_torch.ops.cuda import paged_attention as pa
    from hetu_tpu_torch.ops.cuda import rotary as ro
    from hetu_tpu_torch.ops.cuda import swiglu as sw
    from hetu_tpu_torch.ops.rotary import build_rope_cache

    # paged attention: bf16 pools (the path's) held against the plain
    # version in fp32 on the same values, fp32 pools at 1e-4
    paged = []
    for dtype, tol in ((torch.bfloat16, ulps(0.5, 1e-5)),
                       (torch.float32, ulps(0, 1e-4))):
        q, pools, table, pos, nbytes, ops = paged_case(dtype, seed, 4)
        scale = 128 ** -0.5
        label = (f"paged_attention S=8 nq=32 n_kv=8 hd=128 ps=16 mp=128 "
                 f"{str(dtype)[6:]}")

        def run(i, q=q, pools=pools, table=table, pos=pos):
            return pa.paged_attention(q, *pools[i % len(pools)], table, pos,
                                      softmax_scale=scale)
        same_bits(label, run)
        paged.append(case(
            label, tol, run,
            lambda i, q=q, pools=pools, table=table, pos=pos:
                pa.paged_attention_plain(q, *pools[i % len(pools)], table,
                                         pos, scale),
            nbytes, ops,
            exact=lambda i, q=q, pools=pools, table=table, pos=pos:
                pa.paged_attention_plain(
                    q.float(), *(t.float() for t in pools[i % len(pools)]),
                    table, pos, scale)))
        del pools
    # rotary: the decode shape and the prefill chunk
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    cos, sin = build_rope_cache(8192, 128, 500000.0, device="cuda")
    rotary = []
    for b, s in ((8, 1), (1, 256)):
        q = torch.randn((b, s, 32, 128), generator=g,
                        device="cuda").bfloat16()
        k = torch.randn((b, s, 8, 128), generator=g,
                        device="cuda").bfloat16()
        pos = torch.randint(0, 2048, (b, s), generator=g, device="cuda")
        cos_t, sin_t = cos[pos].contiguous(), sin[pos].contiguous()
        nbytes = 2 * (q.numel() + k.numel()) * 2 + 2 * cos_t.numel() * 4
        ops = 6 * (q.numel() + k.numel()) // 2
        rotary.append(case(
            f"fused_rotary_qk q=[{b},{s},32,128] k=[{b},{s},8,128] bf16",
            ulps(1),
            lambda i, q=q, k=k, c=cos_t, s_=sin_t:
                ro.fused_rotary_qk(q, k, c, s_),
            lambda i, q=q, k=k, c=cos_t, s_=sin_t:
                ro.rotary_qk_plain(q, k, c, s_),
            nbytes, ops, composition=rope_composition(q, k, cos_t, sin_t)))
    # swiglu: the fused gate/up projection's strided halves
    swiglu = []
    for tokens in (8, 256):
        gu = torch.randn((tokens, 2, 14336), generator=g,
                         device="cuda").bfloat16()
        n = tokens * 14336
        swiglu.append(case(
            f"fused_swiglu [{tokens},14336] bf16", ulps(1),
            lambda i, gu=gu: sw.fused_swiglu(gu),
            lambda i, gu=gu: sw.swiglu_plain(gu[:, 0], gu[:, 1]),
            3 * n * 2, 5 * n, composition=swiglu_composition(gu)))
    return {"paged_attention": paged, "fused_rotary_qk": rotary,
            "fused_swiglu": swiglu}


# the verify grid's slots: 8 live slots at the depths a serving run of
# prompts up to 1,024 tokens and 32 new ones reaches
SPEC_DEPTHS = [1100, 1040, 900, 700, 520, 300, 128, 40]


def serving_pages(seed, quant, C, copies, depths=SPEC_DEPTHS, *, nq=32,
                  n_kv=8, hd=128, mp=128, dtype=torch.bfloat16):
    """Pools at an attention shape (by default Llama-3-8B's: 32 q / 8 kv
    heads, head dim 128, 128 pages of 16 a slot) in a page mode,
    `copies` of them so timed launches find their pages cold in L2; q
    [S, C, nq, hd] of `dtype` (exact pages too), a slot for each of
    `depths`.  Every row no query reads (past positions[s] + C - 1,
    and the null page) holds NaN (exact pages) or a NaN scale
    (quantized pages): no kernel may load it.  Returns q, pools (k, v,
    k_scale, v_scale), table, positions, the bytes a launch must move
    (q and out, the live payload and scale rows, table, positions) and
    its operations (4 x head dim a visible (query, key) pair)."""
    from hetu_tpu_torch.ops.quantization import quantize_heads
    S, ps = len(depths), 16
    P = S * mp + 1
    g = torch.Generator(device="cuda").manual_seed(seed)
    positions = torch.tensor(depths, dtype=torch.int32, device="cuda")
    perm = torch.randperm(P - 1, generator=g, device="cuda") + 1
    table = torch.zeros((S, mp), dtype=torch.int32, device="cuda")
    live = torch.zeros(P * ps, dtype=torch.bool, device="cuda")
    used = 0
    for s, d in enumerate(depths):
        n = (d + C - 1) // ps + 1
        table[s, :n] = perm[used:used + n]
        used += n
        keys = torch.arange(d + C, device="cuda")
        live[table[s, keys // ps].long() * ps + keys % ps] = True
    pools = []
    for _ in range(copies):
        kv = []
        for _ in range(2):
            x = torch.randn((P, ps, n_kv, hd), generator=g, device="cuda")
            if quant == "none":
                x = x.to(dtype)
                x.view(P * ps, n_kv, hd)[~live] = float("nan")
                kv.append((x, None))
            else:
                q, sc = quantize_heads(x, 4 if quant == "int4" else 8)
                sc.view(P * ps, n_kv)[~live] = float("nan")
                kv.append((q, sc))
        pools.append((kv[0][0], kv[1][0], kv[0][1], kv[1][1]))
    q = torch.randn((S, C, nq, hd), generator=g, device="cuda").to(dtype)
    rows = sum(d + C for d in depths)
    row_bytes = {"none": hd * 2, "int8": hd + 4, "int4": hd // 2 + 4}[quant]
    nbytes = (2 * q.numel() * 2 + 2 * rows * n_kv * row_bytes
              + table.numel() * 4 + S * 4)
    pairs = sum(d + 1 + c for d in depths for c in range(C))
    ops = 4 * pairs * nq * hd
    return q, pools, table, positions, nbytes, ops


# ------------------------------------------------------ the page write
def served_kv(g, S, C, n_kv, hd, layout, dtype=torch.bfloat16, group=4):
    """K and V [S, C, n_kv, hd] of `dtype` as the serving forwards hand
    them to the page write: LLaMA's K out of RoPE (contiguous) and V a
    view of the fused projection [S, C, n_kv, group + 2, hd]; GPT's K
    and V views of [S, C, n_kv, 3, hd].  The projection's q columns then
    hold NaN, so a write that read them would carry NaN into a page."""
    from hetu_tpu_torch.ops.cuda import rotary as ro
    if layout == "llama":
        qkv = torch.randn((S, C, n_kv, group + 2, hd), generator=g,
                          device="cuda").to(dtype)
        cos_t, sin_t = (torch.randn((S, C, hd // 2), generator=g,
                                    device="cuda") for _ in range(2))
        _, k = ro.fused_rotary_qk(qkv[..., :group, :], qkv[..., group, :],
                                  cos_t, sin_t)
        v = qkv[..., group + 1, :]
        qkv[..., :group, :] = float("nan")
    else:
        qkv = torch.randn((S, C, n_kv, 3, hd), generator=g,
                          device="cuda").to(dtype)
        k, v = qkv[..., 1, :], qkv[..., 2, :]
        qkv[..., 0, :] = float("nan")
    return k, v


def nan_pools(quant, shape, dtype=torch.bfloat16):
    """Pools [..., P, ps, n_kv, hd] (and scales) holding what no write may
    leave behind: NaN exact values, or payload bytes 0x5a under NaN
    scales."""
    if quant == "none":
        k = torch.full(shape, float("nan"), dtype=dtype, device="cuda")
        return [k, k.clone(), None, None]
    hd_p = shape[-1] // 2 if quant == "int4" else shape[-1]
    pay = torch.full((*shape[:-1], hd_p), 0x5a, device="cuda",
                     dtype=torch.uint8 if quant == "int4" else torch.int8)
    sc = torch.full(shape[:-1], float("nan"), device="cuda")
    return [pay, pay.clone(), sc, sc.clone()]


def bytes_differing(pools, ref):
    """The bytes in which two sets of pools (and scales) differ, NaN
    payloads included."""
    return sum(int((a.view(torch.uint8) != b.view(torch.uint8)).sum())
               for a, b in zip(pools, ref) if a is not None)


def parent_token_write(pools, page, offset, k, v, quant):
    """One layer's page write as the parent tree ran it
    (`models/generation.py` `_paged_write_tokens(_q)`): for K and for V a
    scatter of the cast values (exact pages), or `quantize_heads` of a
    contiguous copy (the blockwise quantize kernel for int8, the plain
    chain for int4) and a scatter of the payload and one of the scales;
    `page` and `offset` were computed once a call."""
    from hetu_tpu_torch.ops.quantization import quantize_heads
    kp, vp, ks, vs = pools
    for pool, scale, t in ((kp, ks, k), (vp, vs, v)):
        if scale is None:
            pool[page, offset] = t.to(pool.dtype)
            continue
        q, sc = quantize_heads(t, 4 if quant == "int4" else 8)
        pool[page, offset] = q
        scale[page, offset] = sc


def parent_page_write(pools, dst, src, ks, vs, quant, paged):
    """The parent tree's `PagePool.write_pages`: the whole K and V scratch
    quantized (one quantize launch each for int8), then the real pages'
    payloads and scales scattered; dst / src on the device."""
    from hetu_tpu_torch.ops.quantization import quantize_heads
    kp, vp, kscale, vscale = pools
    for pool, scale, x in ((kp, kscale, ks), (vp, vscale, vs)):
        x = x.reshape(paged)
        if scale is None:
            pool[:, dst] = x[:, src].to(pool.dtype)
            continue
        q, sc = quantize_heads(x, 4 if quant == "int4" else 8)
        pool[:, dst] = q[:, src]
        scale[:, dst] = sc[:, src]


def page_write_result(label, sets, written, nbytes, ops, ms, plain_ms,
                      parent_ms):
    """Check a page-write case (the kernel's pools and the parent path's
    equal to the plain version's byte for byte, `written` slots written
    and no other) and print and return it as `case` does; the parent
    path's time stands in `composition_ms`."""
    for name in ("kernel", "parent"):
        n = bytes_differing(sets[name], sets["plain"])
        check(n == 0, f"{label}: the {name} pools differ from the plain "
                      f"version's in {n} bytes")
    kp, _, ksc, _ = sets["kernel"]
    probe = kp.float().flatten(-2) if ksc is None else ksc   # [..., P, ps, .]
    done = torch.isfinite(probe).all(-1)
    check(torch.equal(done, written), f"{label}: slots written "
                                      f"{int(done.sum())}, expected "
                                      f"{int(written.sum())}")
    b_ms, b_by = bound(nbytes, ops)
    print(f"kernel {label}: identical to its plain version (bytes, NaN "
          f"included), as is the parent's path; ms={ms:.5f} "
          f"plain_ms={plain_ms:.5f} bound_ms={b_ms:.5f} ({b_by}) "
          f"parent_path_ms={parent_ms:.5f} "
          f"(kernel / bound {ms / b_ms:.2f})")
    return {"case": label, "max_abs_err": 0.0,
            "tolerance": "identical (bytes, NaN included)", "excess": 0.0,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None, "composition_ms": parent_ms,
            "composition": "the parent's quantize + scatters"}


def kv_token_cases(seed, modes, depths=SPEC_DEPTHS, *, n_kv=8, hd=128,
                   mp=128, ps=16, layout="llama", dtype=torch.bfloat16,
                   group=4):
    """`write_kv_tokens` at a serving step's shape, one layer, K and V
    of `dtype` (exact pages too) as `served_kv` hands them over, a slot for each of `depths` (page
    rows of `mp` pages of `ps`), in each (page mode, C) of `modes`: held
    against its plain version (and the parent's path, `parent_token_write`)
    byte for byte over pools that start as NaN, and timed beside both and
    its bound (K and V read once, the payload and scales and the table
    entries a token needs)."""
    from hetu_tpu_torch.ops.cuda import kv_write as kw
    S = len(depths)
    P = S * mp + 1
    g = torch.Generator(device="cuda").manual_seed(seed)
    positions = torch.tensor(depths, dtype=torch.int32, device="cuda")
    out = []
    for quant, C in modes:
        k, v = served_kv(g, S, C, n_kv, hd, layout, dtype, group)
        perm = torch.randperm(P - 1, generator=g, device="cuda") + 1
        table = torch.zeros((S, mp), dtype=torch.int32, device="cuda")
        written = torch.zeros((P, ps), dtype=torch.bool, device="cuda")
        used = 0
        for s_, d in enumerate(depths):
            n = (d + C - 1) // ps + 1
            table[s_, :n] = perm[used:used + n]
            used += n
            at = torch.arange(d, d + C, device="cuda")
            written[table[s_, at // ps].long(), at % ps] = True
        sets = {name: nan_pools(quant, (P, ps, n_kv, hd), dtype)
                for name in ("kernel", "plain", "parent")}
        page, offset = kw.token_block_pages(table, positions, C, ps)

        def run(i, p=sets["kernel"], quant=quant, table=table, k=k, v=v):
            kw.write_kv_tokens(p[0], p[1], table, positions, k, v,
                               k_scale=p[2], v_scale=p[3], quant=quant)

        def plain(i, p=sets["plain"], quant=quant, table=table, k=k, v=v):
            kw.write_kv_tokens_plain(p[0], p[1], table, positions, k, v,
                                     p[2], p[3], quant)

        def parent(i, p=sets["parent"], quant=quant, page=page,
                   offset=offset, k=k, v=v):
            parent_token_write(p, page, offset, k, v, quant)
        for fn in (run, plain, parent):
            fn(0)
        torch.cuda.synchronize()
        heads = 2 * S * C * n_kv
        hd_p = {"none": 2 * hd, "int8": hd + 4, "int4": hd // 2 + 4}[quant]
        nbytes = heads * (2 * hd + hd_p) + S * C * 4 + S * 4
        ops = 0 if quant == "none" else 4 * heads * hd
        out.append(page_write_result(
            f"kv_write_tokens {quant} pages [{S},{C},{n_kv},{hd}] "
            f"{layout}'s K and V {_DTYPE_NAMES[dtype]}", sets, written,
            nbytes, ops,
            device_ms(lambda: run(0)), device_ms(lambda: plain(0)),
            device_ms(lambda: parent(0))))
    return out


def kv_pages_cases(seed, modes, *, layers, tokens, max_len, n_kv, hd,
                   ps=16, dtype=torch.bfloat16):
    """`write_kv_pages` for a prefill of `tokens` positions: the scratch
    [layers, 1, max_len, n_kv, hd] of `dtype` (the engine's dense cache, read
    as `cache[:, 0]`), a page row of max_len / ps entries whose first
    tokens / ps are real pages and the rest the null tail, in each page
    mode of `modes`: byte for byte against its plain version and the
    parent's path (`parent_page_write`: the whole scratch quantized, then
    the real pages scattered), and timed beside both and its bound (the
    real pages' rows read once, their payload and scales written once)."""
    from hetu_tpu_torch.ops.cuda import kv_write as kw
    mp, real = max_len // ps, tokens // ps
    P = real + 1
    g = torch.Generator(device="cuda").manual_seed(seed)
    cache = [torch.randn((layers, 1, max_len, n_kv, hd), generator=g,
                         device="cuda").to(dtype) for _ in range(2)]
    ks, vs = cache[0][:, 0], cache[1][:, 0]
    row = torch.zeros(mp, dtype=torch.int32, device="cuda")
    row[:real] = torch.randperm(real, generator=g, device="cuda") + 1
    dst = row[:real].long()
    src = torch.arange(real, device="cuda")
    written = torch.ones((layers, P, ps), dtype=torch.bool, device="cuda")
    written[:, 0] = False
    paged = (layers, mp, ps, n_kv, hd)
    out = []
    for quant in modes:
        sets = {name: nan_pools(quant, (layers, P, ps, n_kv, hd), dtype)
                for name in ("kernel", "plain", "parent")}

        def run(p=sets["kernel"], quant=quant):
            kw.write_kv_pages(p[0], p[1], row, ks, vs, k_scale=p[2],
                              v_scale=p[3], quant=quant)

        def plain(p=sets["plain"], quant=quant):
            kw.write_kv_pages_plain(p[0], p[1], row, ks, vs, p[2], p[3],
                                    quant)

        def parent(p=sets["parent"], quant=quant):
            parent_page_write(p, dst, src, ks, vs, quant, paged)
        for fn in (run, plain, parent):
            fn()
        torch.cuda.synchronize()
        heads = 2 * layers * tokens * n_kv
        hd_p = {"none": 2 * hd, "int8": hd + 4, "int4": hd // 2 + 4}[quant]
        nbytes = heads * (2 * hd + hd_p) + mp * 4
        ops = 0 if quant == "none" else 4 * heads * hd
        # the plain version finds the real entries on the host (a
        # synchronize): timed between events, not in a graph
        out.append(page_write_result(
            f"kv_write_pages {quant} pages, {layers} layers x {tokens} of "
            f"{max_len} positions x {n_kv} x {hd} {_DTYPE_NAMES[dtype]}",
            sets, written, nbytes,
            ops, device_ms(run), event_ms(plain), device_ms(parent, 4)))
        del sets
    return out


def _sampler_rows(seed, R, V):
    """Per-row sampling arguments of a verify step's 8 slots x 5 rows:
    greedy, temperature only, top-k 50, top-p 0.95, top-k + top-p."""
    from hetu_tpu_torch.serving.sampling import key_words
    temps = torch.tensor([0.0, 1.0, 0.8, 0.9, 0.7] * (R // 5), device="cuda")
    top_ks = torch.tensor([0, 0, 50, 0, 50] * (R // 5), dtype=torch.int32,
                          device="cuda")
    top_ps = torch.tensor([0.0, 0.0, 0.0, 0.95, 0.95] * (R // 5),
                          device="cuda")
    words = key_words(torch.arange(R) * 7919 + seed,
                      torch.arange(R) + 1000).cuda()
    return temps, top_ks, top_ps, words


def product_yardstick(dtype=torch.bfloat16):
    """One PyTorch call computing the sampler's product, a yardstick the
    port never calls: `torch.mm` of the 16-bit operands with fp32 output
    where this PyTorch takes `out_dtype`, else a 16-bit `torch.matmul`
    (16-bit logits: half the output bytes).  Returns (fn, its label)."""
    a = torch.ones((16, 16), device="cuda", dtype=dtype)
    try:
        torch.mm(a, a, out_dtype=torch.float32)
    except (TypeError, RuntimeError):
        return torch.matmul, f"torch.matmul, {_DTYPE_NAMES[dtype]} out"
    return (lambda x, w: torch.mm(x, w, out_dtype=torch.float32),
            "torch.mm(out_dtype=fp32)")


def sampler_cases(g, seed, head, head_text, R=40):
    """The fused sampler over hidden [R, H] and `head` [H, V] (bf16 or
    fp16, the head's type):
    the product alone (kernel (a)), timed beside the fp32 product and
    `product_yardstick`, held within 1e-5 of the largest logit; then
    product + draw, its tokens identical on every row whose plain
    top-two gap after noise exceeds 1e-3 (the others counted)."""
    from hetu_tpu_torch.ops.cuda import sample as sa
    H, V = head.shape
    temps, top_ks, top_ps, words = _sampler_rows(seed, R, V)
    dt = _DTYPE_NAMES[head.dtype]
    hidden = torch.randn((R, H), generator=g, device="cuda").to(head.dtype)
    ref = hidden.float() @ head.float()
    mm, mm_text = product_yardstick(head.dtype)
    route = sa.lm_head_route(hidden, head)
    product = case(
        f"fused_sample product hidden [{R},{H}] x head {head_text} {dt} -> "
        f"fp32 logits, {route} arm (library: {mm_text})",
        rel(1e-5, of_max=True),
        lambda i: sa.lm_head_logits(hidden, head),
        lambda i: hidden.float() @ head.float(),
        H * V * 2 + R * H * 2 + R * V * 4, 2 * R * H * V,
        library=lambda i: mm(hidden, head), op_dtype=torch.bfloat16,
        inner=2)
    print(f"lm_head ratio {head_text}: kernel / {mm_text} "
          f"{product['ms'] / product['library_ms']:.3f}")
    noisy = sa.filtered_logits(ref, temps, top_ks, top_ps) + sa.gumbel(
        words[:, :1], words[:, 1:], torch.arange(V, device="cuda")[None])
    noisy = torch.where(temps[:, None] > 0, noisy, ref)
    top2 = noisy.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 1e-3
    print(f"fused_sample {head_text}: {int((~clear).sum())} of {R} rows "
          f"with a plain top-two gap after noise <= 1e-3 (tokens not "
          f"compared there)")
    sel = clear.nonzero()[:, 0]     # fixed indices: graph-capturable
    del ref, noisy
    args = (words, temps, top_ks, top_ps)
    fused = case(
        f"fused_sample hidden [{R},{H}] x head {head_text} {dt}, greedy / "
        "temperature / top-k 50 / top-p 0.95 / both", same(),
        lambda i: sa.fused_sample(hidden, head, *args).index_select(0, sel),
        lambda i: sa.fused_sample_plain(hidden, head, *args).index_select(
            0, sel),
        H * V * 2 + R * H * 2 + R * 4 * 5, 2 * R * H * V,
        op_dtype=torch.bfloat16, inner=2)
    return [fused, product]


def paged_cases(seed, modes, depths=SPEC_DEPTHS, **shape):
    """The paged kernels in each (page mode, C) of `modes` over
    `serving_pages(..., depths, **shape)`: C = 1 is `paged_attention`
    (decode), C > 1 `paged_verify`; each held against the plain version
    on the same pool in fp32 (half a bf16 ulp + 1e-5) and timed beside
    it and its bound.  Returns [(kernel name, case)]."""
    from hetu_tpu_torch.ops.cuda import paged_attention as pa

    S = len(depths)
    nq, n_kv = shape.get("nq", 32), shape.get("n_kv", 8)
    hd, mp = shape.get("hd", 128), shape.get("mp", 128)
    scale = hd ** -0.5
    res = []
    for quant, C in modes:
        q, pools, table, pos, nbytes, ops = serving_pages(
            seed + 10 + C, quant, C, 4, depths, **shape)
        kw = {} if quant == "none" else {"quant": quant}
        text = f"nq={nq} n_kv={n_kv} hd={hd} ps=16 mp={mp} bf16"
        if C == 1:
            name = ("paged_attention" if quant == "none"
                    else f"paged_attention_{quant}")
            label = f"paged_attention {quant} pages S={S} {text}"

            def run(i, q=q[:, 0], pools=pools, kw=kw, table=table, pos=pos):
                k, v, ks, vs = pools[i % len(pools)]
                return pa.paged_attention(q, k, v, table, pos,
                                          softmax_scale=scale, k_scale=ks,
                                          v_scale=vs, **kw)

            def plain(i, q=q[:, 0], pools=pools, quant=quant, table=table,
                      pos=pos, f32=False):
                k, v, ks, vs = pools[i % len(pools)]
                if f32 and quant == "none":
                    k, v = k.float(), v.float()
                return pa.paged_attention_plain(
                    q.float() if f32 else q, k, v, table, pos, scale, ks,
                    vs, quant)
        else:
            name = "paged_verify"
            label = f"paged_verify {quant} pages q=[{S},{C},{nq},{hd}] {text}"

            def run(i, q=q, pools=pools, kw=kw, table=table, pos=pos):
                k, v, ks, vs = pools[i % len(pools)]
                return pa.paged_verify(q, k, v, table, pos,
                                       softmax_scale=scale, k_scale=ks,
                                       v_scale=vs, **kw)

            def plain(i, q=q, pools=pools, quant=quant, table=table,
                      pos=pos, f32=False):
                k, v, ks, vs = pools[i % len(pools)]
                if f32 and quant == "none":
                    k, v = k.float(), v.float()
                return pa.paged_verify_plain(
                    q.float() if f32 else q, k, v, table, pos, scale, ks,
                    vs, quant)
        # the products of bf16 queries with int8 / int4 / bf16 keys run
        # on the bf16 tensor cores (the scales applied a key after)
        same_bits(label, run)
        res.append((name, case(label, ulps(0.5, 1e-5), run, plain, nbytes,
                               ops, exact=lambda i, plain=plain:
                                   plain(i, f32=True),
                               op_dtype=torch.bfloat16)))
        del pools
    return res


def serving2_kernel_phase(seed: int):
    """The second serving slice's kernels at its path's shapes: paged
    attention over int8/int4 pages (decode, q [8, 32, 128] bf16), the
    verify kernel in the three page modes (q [8, 5, 32, 128]), the
    blockwise quantize (one verify step's K of one layer, [320, 128],
    and one prefill page write of all 32 layers, [524288, 128], bf16),
    and the sampler: the fused LM head + draw at hidden [40, 4096] x
    head [4096, 128256] bf16 (rows greedy, temperature only, top-k,
    top-p, top-k + top-p), the product timed beside
    `product_yardstick`, and the draw alone over bf16 logits [8,
    128256], [40, 128256] and [40, 50257] (a verify step's rows), each
    run twice for the same bits, with the clusters the card runs at
    once; the page write (`kv_token_cases`: decode [8, 1, 8, 128] and
    verify [8, 5, 8, 128] in the three page modes; `kv_pages_cases`: a
    1,024-token prefill over 32 layers of a 2,048-position scratch) beside
    the parent tree's quantize + scatters.  Tolerances: the quantize
    payload bit for bit, scales within one fp32 ulp; the page write's
    pools byte for byte; attention as the exact pages' (the plain
    version on the same quantized pool in fp32, half a bf16 ulp +
    1e-5); the draw alone token for token; the product within 1e-5 of
    the largest logit; the fused tokens identical on every row whose
    plain top-two gap after noise exceeds 1e-3 (the others counted)."""
    from hetu_tpu_torch.ops.cuda import quant as qu
    from hetu_tpu_torch.ops.cuda import sample as sa

    out = {"paged_attention_int8": [], "paged_attention_int4": [],
           "paged_verify": [], "quantize_blockwise": [], "fused_sample": [],
           "sample_logits": []}
    for name, res in paged_cases(seed, (("int8", 1), ("int4", 1),
                                        ("none", 5), ("int8", 5),
                                        ("int4", 5))):
        out[name].append(res)
    # blockwise quantize, bf16 in
    g = torch.Generator(device="cuda").manual_seed(seed + 20)
    for rows, inner in ((320, 20), (524288, 2)):
        x = torch.randn((rows, 128), generator=g, device="cuda").bfloat16()
        n = x.numel()
        out["quantize_blockwise"].append(case(
            f"quantize_blockwise [{rows},128] bf16 -> int8", (same(),
                                                              fp32_ulps(1)),
            lambda i, x=x: qu.quantize_blockwise(x, 128),
            lambda i, x=x: qu.quantize_blockwise_plain(x, 128),
            n * 2 + n + rows * 4, 4 * n, inner=inner))
        del x
    # the page write: a decode and a verify step's layer in each page
    # mode, and a 1,024-token prefill's pages (32 layers)
    out["kv_write_tokens"] = kv_token_cases(
        seed + 30, [(quant, C) for C in (1, 5)
                    for quant in ("none", "int8", "int4")])
    out["kv_write_pages"] = kv_pages_cases(
        seed + 31, ("none", "int8", "int4"), layers=32, tokens=1024,
        max_len=2048, n_kv=8, hd=128)
    gc.collect()
    torch.cuda.empty_cache()
    # the sampler
    R, H, V = 40, 4096, 128256
    head = (0.02 * torch.randn((H, V), generator=g, device="cuda")).bfloat16()
    out["fused_sample"].extend(sampler_cases(g, seed, head, f"[{H},{V}]"))
    del head
    # the draw alone: a decode step's 8 rows, and the 40 rows of a
    # verify step's fused sampler over Llama's and GPT-2's vocabularies
    # (the draw's share of those rows); each twice on the same inputs
    for rows, vocab, what in ((8, V, "the decode step's draw"),
                              (40, V, "a verify step's draw"),
                              (40, 50257, "GPT's verify step's draw")):
        temps, top_ks, top_ps, words = _sampler_rows(seed, 40, vocab)
        lg = (4.0 * torch.randn((rows, vocab), generator=g,
                                device="cuda")).bfloat16()
        args = tuple(t[:rows] for t in (words, temps, top_ks, top_ps))
        label = f"sample_logits logits [{rows},{vocab}] bf16 ({what})"
        same_bits(label, lambda i, lg=lg, args=args: sa.sample_logits(
            lg, *args))
        out["sample_logits"].append(case(
            label, same(), lambda i, lg=lg, args=args: sa.sample_logits(
                lg, *args),
            lambda i, lg=lg, args=args: sa.sample_plain(lg, *args),
            rows * vocab * 2 + rows * 4 * 5, rows * vocab * 4))
        clusters = sa.active_clusters(rows, vocab)
        print(f"sample_logits V={vocab}: {clusters} clusters of 8 at once, "
              f"{rows} rows in {-(-rows // clusters)} wave(s)")
        if rows > 8:   # the kernel's two builds (many waves, one): one draw
            whole = sa.sample_logits(lg, *args)
            eights = torch.cat([sa.sample_logits(
                lg[i:i + 8], *(a[i:i + 8] for a in args))
                for i in range(0, rows, 8)])
            check(torch.equal(whole, eights),
                  f"{label}: 8-row launches differ from one launch")
            print(f"kernel {label}: launches of 8 rows the same tokens")
    return out


def _add_then(norm, x, h, *args):
    """The two-call composition a fused residual norm replaces: s = x + h,
    then PyTorch's norm of s (the kernel's yardstick, no one PyTorch call
    returns both)."""
    s = x + h
    return norm(s, *args), s


def norm_scalar_cases(kind, dtype, rows, hidden, odd, g):
    """The fused norms' scalar arm (`kind` "rms", or "ln" with a bias):
    [rows, hidden] one element off a 16-byte boundary (x, h, and the s,
    dy, dr of the backward) must give the vector arm's bits, forward and
    backward, and is held against the plain version; [rows, odd], no
    whole number of 16-byte chunks, too.  Tolerances as the vector
    arm's: y, s, dx one bf16 ulp + 1e-6 (fp32: 1e-5 relative + 1e-5),
    dw and db 1e-5 of their largest entry.  Returns {kernel: [cases]}."""
    from hetu_tpu_torch.ops.cuda import fused_norm as fn
    eps, bf16 = 1e-5, dtype == torch.bfloat16
    tol = ulps(1, 1e-6) if bf16 else rel(1e-5, 1e-5)
    sums = rel(1e-5, of_max=True)
    names = {"rms": ("residual_rmsnorm_fwd", "residual_rmsnorm_bwd"),
             "ln": ("residual_layernorm_fwd", "residual_layernorm_bwd")}
    f_name, b_name = names[kind]

    def inputs(width):
        def randn(*shape, std=1.0):
            return std * torch.randn(shape, generator=g, device="cuda")
        x, h, dy, dr = (randn(rows, width).to(dtype) for _ in range(4))
        w = 1.0 + randn(width, std=0.1)
        return x, h, dy, dr, w, randn(width, std=0.1) if kind == "ln" \
            else None

    def off(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device="cuda")
        return buf[1:].view(t.shape).copy_(t)

    def fwd(x, h, w, b, plain=False):
        if kind == "rms":
            return (fn.residual_rmsnorm_plain(x, h, w, eps) if plain
                    else fn.residual_rmsnorm_fwd(x, h, w, eps))
        return (fn.residual_layernorm_plain(x, h, w, b, eps) if plain
                else fn.residual_layernorm_fwd(x, h, w, b, eps))

    def bwd(s, w, dy, dr, plain=False):
        if kind == "rms":
            return (fn.residual_rmsnorm_bwd_plain if plain
                    else fn.residual_rmsnorm_bwd)(s, w, dy, dr, eps)
        return (fn.residual_layernorm_bwd_plain(s, w, dy, dr, eps) if plain
                else fn.residual_layernorm_bwd(s, w, dy, dr, eps))
    bwd_tols = (tol, sums) + ((sums,) if kind == "ln" else ())
    out = {f_name: [], b_name: []}
    text = "bf16" if bf16 else "fp32"
    x, h, dy, dr, w, b = inputs(hidden)
    xo, ho, dyo, dro = (off(t) for t in (x, h, dy, dr))
    check(fn.launch_plan(hidden, dtype, rows, (xo.data_ptr(),),
                         backward=False, sms=1).scalar,
          "the offset view does not take the scalar arm")
    vec_f = fwd(x, h, w, b)
    sca_f = fwd(xo, ho, w, b)
    so = off(vec_f[1])
    vec_b, sca_b = bwd(vec_f[1], w, dy, dr), bwd(so, w, dyo, dro)
    torch.cuda.synchronize()
    for name, a, r in ((f_name, sca_f, vec_f), (b_name, sca_b, vec_b)):
        check(all(torch.equal(u, v) for u, v in zip(a, r)),
              f"{name}: the scalar arm's bits differ from the vector arm's")
        print(f"kernel {name} [{rows},{hidden}] {text} one element off 16 "
              f"bytes (scalar arm): the vector arm's bits")
    label = f"[{rows},{hidden}] {text} one element off 16 bytes (scalar arm)"
    out[f_name].append(checked(f"{f_name} {label}", tol, sca_f,
                               fwd(xo, ho, w, b, plain=True)))
    out[b_name].append(checked(f"{b_name} {label}", bwd_tols, sca_b,
                               bwd(so, w, dyo, dro, plain=True)))
    del x, h, dy, dr, xo, ho, dyo, dro, so, vec_f, sca_f, vec_b, sca_b
    x, h, dy, dr, w, b = inputs(odd)
    s = fwd(x, h, w, b)[1]
    label = f"[{rows},{odd}] {text} (scalar arm)"
    out[f_name].append(checked(f"{f_name} {label}", tol, fwd(x, h, w, b),
                               fwd(x, h, w, b, plain=True)))
    out[b_name].append(checked(f"{b_name} {label}", bwd_tols,
                               bwd(s, w, dy, dr),
                               bwd(s, w, dy, dr, plain=True)))
    return out


def rope_composition(q, k, cos_t, sin_t, sign: float = 1.0):
    """The rotary rows' yardstick for `case(composition=)`: the
    half-split rotation as PyTorch ops on q and k in their own dtype
    (the tables cast to it once, here), by sign * theta."""
    c, s = cos_t.to(q.dtype), (sign * sin_t).to(q.dtype)

    def rot(x):
        shape = x.shape[:2] + (1,) * (x.dim() - 3) + (c.shape[-1],)
        cx, sx = c.view(shape), s.view(shape)
        x1, x2 = x.chunk(2, dim=-1)
        return torch.cat([x1 * cx - x2 * sx, x2 * cx + x1 * sx], dim=-1)
    return lambda i: (rot(q), rot(k))


def swiglu_composition(gu):
    """The SwiGLU rows' yardstick: `F.silu(gate) * up` on gu's strided
    bf16 halves."""
    import torch.nn.functional as F
    return lambda i: F.silu(gu[:, 0]) * gu[:, 1]


def swiglu_bwd_composition_ms(gu, dy):
    """The SwiGLU backward's yardstick, ms: autograd's backward of
    `F.silu(gate) * up` on gu's halves (in its dtype) for dy — its
    forward + backward in one CUDA graph, less the forward alone, as
    the RMS backward's composition is timed."""
    import torch.nn.functional as F
    leaves = [gu[:, j].detach().clone().requires_grad_(True)
              for j in range(2)]

    def fwd_bwd():
        return torch.autograd.grad(F.silu(leaves[0]) * leaves[1], leaves, dy)
    with torch.no_grad():
        f = device_ms(lambda: F.silu(leaves[0]) * leaves[1])
    fb = device_ms(fwd_bwd)
    print(f"swiglu_bwd composition {gu.dtype}: silu * up forward + "
          f"backward {fb:.5f} ms, forward {f:.5f} ms")
    return fb - f


def rope_qkv_case(label, qkv, group, cos_t, sin_t, tol=None):
    """RoPE as the LLaMA attention calls it: q (the grouped view [b, s,
    n_kv, group, hd]) and k read in place from the fused projection qkv
    [b, s, n_kv, group+2, hd], held against the plain version on
    contiguous copies (one bf16 ulp, or `tol`) and timed beside the
    composition on the same views."""
    from hetu_tpu_torch.ops.cuda import rotary as ro
    b, s, n_kv, _, hd = qkv.shape
    q, k = qkv[..., :group, :], qkv[..., group, :]
    q4, k4 = q.reshape(b, s, n_kv * group, hd), k.contiguous()
    n = q4.numel() + k4.numel()
    return case(
        label, tol or ulps(1),
        lambda i: ro.fused_rotary_qk(q, k, cos_t, sin_t),
        lambda i: ro.rotary_qk_plain(q4, k4, cos_t, sin_t),
        2 * n * qkv.element_size() + 2 * cos_t.numel() * 4, 6 * n // 2,
        composition=rope_composition(q, k, cos_t, sin_t))


@contextlib.contextmanager
def parent_rope_copies():
    """The LLaMA paths as they ran before RoPE read q and k in place: q
    copied to [b, s, nq, hd] and k made contiguous before every
    `fused_rotary_qk` call (two copy kernels a layer), to count on the
    card what reading them in place removed."""
    from hetu_tpu_torch.models import generation
    from hetu_tpu_torch.models.llama import model as llama
    rotate = llama.fused_rotary_qk

    def copying(q, k, *args, **kw):
        return rotate(q.reshape(*q.shape[:2], -1, q.shape[-1]),
                      k.contiguous(), *args, **kw)
    llama.fused_rotary_qk = generation.fused_rotary_qk = copying
    try:
        yield
    finally:
        llama.fused_rotary_qk = generation.fused_rotary_qk = rotate


def device_ops(fn, sides, tries: int = 6, lead: int = 256) -> tuple:
    """The device operations of one call of `fn` under each of `sides`
    (context-manager factories: this tree's path, the parent's, ...),
    one total a side.  After a warm call under each side, each of
    `tries` rounds profiles one call under every side in turn, and the
    most common round counts (ties: the largest).  A library now and
    then runs another kernel sequence for the same call for a stretch
    of a run (a draft forward counted 443 or 448 operations by the
    stretch, its parent path 475 or 480), so the sides are compared
    within a round, never across rounds.  Each profile opens with
    `lead` marker launches that take the profiler's loss of a window's
    first records (late in a long run it lost a few dozen a profile),
    and a round counts only if every profile in it kept some markers."""
    for side in sides:
        with side():
            fn()
    rounds = []
    for _ in range(tries):
        totals = []
        for side in sides:
            counts = {}
            with side():
                _profile(fn, 1, counts=counts, lead=lead)
            if not counts.pop(MARKER, 0):
                break
            totals.append(round(sum(counts.values())))
        else:
            rounds.append(tuple(totals))
    check(bool(rounds), f"device_ops: every round lost all {lead} markers "
                        f"of a profile")
    return max(rounds, key=lambda r: (rounds.count(r), sum(r)))


def rope_copy_drop(name, fn, layers: int, tries: int = 6) -> tuple:
    """The device operations of one call of `fn` as this tree runs it
    and as the parent's path runs it (`parent_rope_copies`), counted by
    `device_ops`; checks that this tree runs 2 x layers fewer and
    returns (this tree's, the parent path's)."""
    now, parent = device_ops(fn, (contextlib.nullcontext,
                                  parent_rope_copies), tries)
    print(f"rope in place: {name} {parent} -> {now} device operations "
          f"a call ({parent - now} fewer, 2 x {layers} layers expected)")
    check(parent - now == 2 * layers,
          f"{name}: reading q and k in place removed {parent - now} "
          f"device operations, not 2 x {layers}")
    return now, parent


@contextlib.contextmanager
def parent_page_writes():
    """The paged forwards as they wrote pages before the fused page
    write: `write_kv_tokens` replaced by `parent_token_write` (a scatter,
    or a quantize of a contiguous copy and two scatters, for K and for
    V), its page ids and offsets computed once a call, as the parent's
    `_token_block_pages` did; to count on the card what the fused write
    removed."""
    from hetu_tpu_torch.models import generation
    from hetu_tpu_torch.ops.cuda import kv_write as kw
    fused, last = generation.write_kv_tokens, {}

    def parent(kp, vp, table, positions, k, v, *, k_scale=None,
               v_scale=None, quant=None, device="cuda"):
        key = last.get("key", (None, None))
        if key[0] is not table or key[1] is not positions:
            last["key"] = (table, positions)    # held: no id is reused
            last["slots"] = kw.token_block_pages(table, positions,
                                                 k.shape[1], kp.shape[1])
        parent_token_write((kp, vp, k_scale, v_scale), *last["slots"], k,
                           v, quant)
    generation.write_kv_tokens = parent
    try:
        yield
    finally:
        generation.write_kv_tokens = fused


def page_write_drop(name, fn, layers: int, tries: int = 6) -> tuple:
    """The device operations of one call of `fn` with the fused page
    write and as the parent's path ran it (`parent_page_writes`),
    counted by `device_ops`; checks that the fused write removed at
    least one operation a layer and returns (this tree's, the parent
    path's)."""
    now, before = device_ops(fn, (contextlib.nullcontext,
                                  parent_page_writes), tries)
    print(f"page write: {name} {before} -> {now} device operations a "
          f"call ({before - now} fewer, {(before - now) / layers:.2f} a "
          f"layer)")
    check(before - now >= layers, f"{name}: the fused page write removed "
                                  f"{before - now} device operations, "
                                  f"fewer than one a layer ({layers})")
    return now, before


def training_kernel_phase(seed: int):
    """Every kernel the training path launches, at its shapes: 2 x 2048
    tokens per micro-batch, Llama-3-8B widths, bf16 activations (SwiGLU
    and RoPE forward too, keyed beside their serving shapes); AdamW on
    the largest leaf (w_gate_up, 117M fp32 elements) and a bf16 leaf."""
    import torch.nn.functional as F
    from hetu_tpu_torch.ops.cuda import fused_norm as fn
    from hetu_tpu_torch.ops.cuda import rotary as ro
    from hetu_tpu_torch.ops.cuda import swiglu as sw
    from hetu_tpu_torch.ops.rotary import build_rope_cache, rope_tables

    g = torch.Generator(device="cuda").manual_seed(seed + 2)

    def randn(*shape, dtype=torch.bfloat16, std=1.0):
        return (std * torch.randn(shape, generator=g, device="cuda")).to(
            dtype)

    tokens, hidden, inter, eps = 4096, 4096, 14336, 1e-5
    # fused residual RMSNorm: forward (y, s), backward (dx, dw)
    x, h, dy, dr = (randn(tokens, hidden) for _ in range(4))
    w = 1.0 + randn(hidden, dtype=torch.float32, std=0.1)
    act = tokens * hidden * 2
    # y and dx: one bf16 ulp, plus 1e-6 for the fp32 row sums taken in
    # another order (dx can cancel to far below its terms)
    wb = w.bfloat16()
    norm_fwd = [case(
        f"residual_rmsnorm_fwd [{tokens},{hidden}] bf16, w fp32",
        ulps(1, 1e-6),
        lambda i: fn.residual_rmsnorm_fwd(x, h, w, eps),
        lambda i: fn.residual_rmsnorm_plain(x, h, w, eps),
        4 * act + hidden * 4, 6 * tokens * hidden,
        composition=lambda i: _add_then(F.rms_norm, x, h, (hidden,), wb,
                                        eps))]
    _, s = fn.residual_rmsnorm_fwd(x, h, w, eps)
    # the backward's composition: PyTorch's rms_norm backward, then
    # `+ dr` — autograd's forward + backward in one CUDA graph, less
    # the forward alone
    leaves = [t.detach().clone().requires_grad_(True) for t in (s, wb)]

    def rms_fwd_bwd():
        ds, dw = torch.autograd.grad(
            F.rms_norm(leaves[0], (hidden,), leaves[1], eps), leaves, dy)
        return ds + dr, dw
    with torch.no_grad():
        rms_f = device_ms(lambda: F.rms_norm(s, (hidden,), wb, eps))
    rms_fb = device_ms(rms_fwd_bwd)
    del leaves
    norm_bwd = [case(
        f"residual_rmsnorm_bwd [{tokens},{hidden}] bf16, dw fp32",
        (ulps(1, 1e-6), rel(1e-5, of_max=True)),
        lambda i: fn.residual_rmsnorm_bwd(s, w, dy, dr, eps),
        lambda i: fn.residual_rmsnorm_bwd_plain(s, w, dy, dr, eps),
        4 * act + 2 * hidden * 4, 11 * tokens * hidden,
        composition_ms=rms_fb - rms_f)]
    print(f"residual_rmsnorm_bwd composition: rms_norm forward + backward "
          f"{rms_fb:.5f} ms, forward {rms_f:.5f} ms")
    del x, h, dy, dr, s
    scalar = norm_scalar_cases("rms", torch.bfloat16, tokens, hidden,
                               hidden - 4, g)
    norm_fwd += scalar["residual_rmsnorm_fwd"]
    norm_bwd += scalar["residual_rmsnorm_bwd"]
    # SwiGLU forward from the strided gate/up halves, and its backward
    # into one [tokens, 2, inter] buffer
    gu, dy = randn(tokens, 2, inter), randn(tokens, inter)
    n = tokens * inter
    swiglu = [case(
        f"fused_swiglu [{tokens},{inter}] bf16", ulps(1),
        lambda i: sw.fused_swiglu(gu),
        lambda i: sw.swiglu_plain(gu[:, 0], gu[:, 1]),
        3 * n * 2, 5 * n, composition=swiglu_composition(gu))]
    swiglu_bwd = [case(
        f"swiglu_bwd [{tokens},{inter}] bf16", ulps(1),
        lambda i: sw.swiglu_bwd(gu, dy),
        lambda i: torch.stack(sw.swiglu_bwd_plain(gu[:, 0], gu[:, 1], dy),
                              dim=-2),
        5 * n * 2, 12 * n,
        composition_ms=swiglu_bwd_composition_ms(gu, dy))]
    del gu, dy
    # RoPE backward: the forward kernel rotating by -theta
    cos, sin = build_rope_cache(8192, 128, 500000.0, device="cuda")
    cos_t, sin_t = rope_tables(cos, sin, 2, 2048)
    dq, dk = randn(2, 2048, 32, 128), randn(2, 2048, 8, 128)
    pairs = (dq.numel() + dk.numel()) // 2
    rotary = [case(
        "fused_rotary_qk q=[2,2048,32,128] k=[2,2048,8,128] bf16", ulps(1),
        lambda i: ro.fused_rotary_qk(dq, dk, cos_t, sin_t),
        lambda i: ro.rotary_qk_plain(dq, dk, cos_t, sin_t),
        2 * (dq.numel() + dk.numel()) * 2 + 2 * cos_t.numel() * 4,
        6 * pairs, composition=rope_composition(dq, dk, cos_t, sin_t)),
        rope_qkv_case(
            "fused_rotary_qk q,k views of qkv [2,2048,8,4+2,128] bf16",
            randn(2, 2048, 8, 6, 128), 4, cos_t, sin_t)]
    rotary_bwd = [case(
        "rotary_qk_bwd q=[2,2048,32,128] k=[2,2048,8,128] bf16", ulps(1),
        lambda i: ro.rotary_qk_bwd(dq, dk, cos_t, sin_t),
        lambda i: ro.rotary_qk_plain(dq, dk, cos_t, -sin_t),
        2 * (dq.numel() + dk.numel()) * 2 + 2 * cos_t.numel() * 4,
        6 * pairs, composition=rope_composition(dq, dk, cos_t, sin_t, -1.0))]
    del dq, dk
    # AdamW on the largest leaf and a bf16 leaf, one launch each; the
    # bf16 leaf again with the skip flag clear (the dynamic scale's
    # finite step) and set (a non-finite one)
    adam = [adam_case(f"adam_update {label}", [numel], dtype, g, skip=skip)
            for label, numel, dtype, skip in (
                ("w_gate_up [4096,2,14336] fp32", hidden * 2 * inter,
                 torch.float32, None),
                ("wqkv [4096,8,6,128] bf16", hidden * 8 * 6 * 128,
                 torch.bfloat16, None),
                ("wqkv [4096,8,6,128] bf16, skip flag clear",
                 hidden * 8 * 6 * 128, torch.bfloat16, 0),
                ("wqkv [4096,8,6,128] bf16, skip flag set",
                 hidden * 8 * 6 * 128, torch.bfloat16, 1))]
    # what the card's memory gives a plain stream at w_gate_up's size:
    # PyTorch's copy (read one, write one) and add (read two, write one),
    # beside AdamW's seven streams
    n = hidden * 2 * inter
    a, b, c = (torch.empty(n, device="cuda") for _ in range(3))
    for label, fn, nbytes in (("copy", lambda: c.copy_(a), 8 * n),
                              ("add", lambda: torch.add(a, b, out=c),
                               12 * n)):
        ms = device_ms(fn, inner=10)
        print(f"memory {label} [{n}] fp32: {ms:.5f} ms, "
              f"{nbytes / ms / 1e9:.4f} TB/s, "
              f"{ms / bound(nbytes, 0)[0]:.3f} x its bound")
    del a, b, c
    return {"residual_rmsnorm_fwd": norm_fwd,
            "residual_rmsnorm_bwd": norm_bwd, "fused_swiglu": swiglu,
            "swiglu_bwd": swiglu_bwd, "fused_rotary_qk": rotary,
            "rotary_qk_bwd": rotary_bwd, "adam_update": adam,
            **flash_kernel_phase(seed)}


def adam_case(label, numels, dtype, g, *, views=(), inner=20, skip=None):
    """AdamW over leaves of `numels` elements (p of `dtype`; g, m, v
    fp32), in place, through `adam_update_multi`: one launch a list.  The
    p, m and v of the kernel, of the plain version and of the library
    call (`torch._fused_adamw_` over the same lists, where it takes p's
    dtype with fp32 g, m and v; its decay is decoupled, a yardstick of
    the same traffic) each start from the same values and stay their
    own.  Leaves in `views` are views one element into a larger buffer:
    off a 16-byte boundary, the kernel's scalar path.  Tolerances: one
    fp32 ulp (rtol 3e-7); a bf16 p one bf16 ulp.  `skip` (0 or 1): the
    kernel and the plain version take the device-side skip flag with
    that value; with 1 every launch must leave p, m and v byte for byte
    as they were, with 0 a launch must write the bits of a launch
    without the flag (checked on copies first)."""
    from hetu_tpu_torch.ops.cuda import adam as ad
    kw = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
    step, lr = 10, 3e-4
    c1 = float(np.float32(1) - np.float32(0.9) ** np.float32(step))
    c2 = float(np.float32(1) - np.float32(0.95) ** np.float32(step))

    def randn(n, dt, std, i):
        off = 1 if i in views else 0
        return (std * torch.randn(n + off, generator=g, device="cuda")).to(
            dt)[off:]
    p0 = [randn(n, dtype, 0.02, i) for i, n in enumerate(numels)]
    grad = [randn(n, torch.float32, 1e-3, i) for i, n in enumerate(numels)]
    m0 = [randn(n, torch.float32, 1e-4, i) for i, n in enumerate(numels)]
    v0 = [randn(n, torch.float32, 1e-6, i).abs_()
          for i, n in enumerate(numels)]

    def copies():
        out = []
        for ts in (p0, m0, v0):
            out.append([])
            for i, t in enumerate(ts):
                c = torch.empty(t.numel() + (i in views), dtype=t.dtype,
                                device="cuda")[int(i in views):]
                out[-1].append(c.copy_(t))
        return out
    mine, ref, lib = copies(), copies(), copies()
    flag = None
    if skip is not None:
        flag = torch.full((), skip, dtype=torch.int32, device="cuda")
        with_flag, without = copies(), copies()
        ad.adam_update_multi(*with_flag[:1], grad, *with_flag[1:], lr, c1, c2,
                             skip=flag, **kw)
        ad.adam_update_multi(*without[:1], grad, *without[1:], lr, c1, c2,
                             **kw)
        expect = (p0, m0, v0) if skip else without
        check(all(torch.equal(a, b) for xs, ys in zip(with_flag, expect)
                  for a, b in zip(xs, ys)),
              f"{label}: the skip flag {skip} launch wrote other bytes")
        del with_flag, without
        kept = copies() if skip else None
    del p0, m0, v0
    library = None
    steps = [torch.full((), float(step), device="cuda") for _ in numels]

    def library_call(i):
        torch._fused_adamw_(lib[0], grad, lib[1], lib[2], [], steps, lr=lr,
                            beta1=0.9, beta2=0.95, weight_decay=0.1,
                            eps=1e-8, amsgrad=False, maximize=False)
    try:
        library_call(0)
        library = library_call
    except RuntimeError as e:       # a yardstick only: the port never calls it
        print(f"{label}: torch._fused_adamw_ does not take this list "
              f"({str(e).splitlines()[0]}); library_ms stays null")

    def run(i):
        ad.adam_update_multi(*mine[:1], grad, *mine[1:], lr, c1, c2,
                             skip=flag, **kw)
        return tuple(t for ts in mine for t in ts)

    def plain(i):
        for p, gr, m, v in zip(ref[0], grad, ref[1], ref[2]):
            ad.adam_plain(p, gr, m, v, lr, c1, c2, skip=flag, **kw)
        return tuple(t for ts in ref for t in ts)
    n, esize = sum(numels), torch.finfo(dtype).bits // 8
    p_tol = ulps(1) if dtype == torch.bfloat16 else rel(3e-7)
    tols = (p_tol,) * len(numels) + (rel(3e-7),) * (2 * len(numels))
    res = case(label, tols, run, plain, n * (2 * esize + 4 + 4 * 4),
               15 * n, library=library, inner=inner)
    if skip:
        check(all(torch.equal(a, b) for xs, ys in zip(mine, kept)
                  for a, b in zip(xs, ys)),
              f"{label}: launches with the skip flag set wrote p, m or v")
        print(f"kernel {label}: p, m and v byte for byte as before")
        del kept
    del mine, ref, lib, grad
    return res


# the GPT serving path's slots: 8 prompts of 64-768 tokens and 32 new
GPT_DEPTHS = [790, 768, 700, 520, 300, 128, 64, 40]


def leaf_numels(cls, cfg, block: str):
    """The element counts of a `cls` model's parameter leaves, in the
    model's order: a one-layer model's, its layer (names holding
    `block`) repeated `cfg.num_hidden_layers` times."""
    one = cls(dataclasses.replace(cfg, num_hidden_layers=1), device="cuda",
              seed=0)
    leaves = [(name, p.numel()) for name, p in one.named_parameters()]
    del one
    layer = [n for name, n in leaves if block in name]
    rest = [n for name, n in leaves if block not in name]
    first = next(i for i, (name, _) in enumerate(leaves) if block in name)
    return rest[:first] + layer * cfg.num_hidden_layers + rest[first:]


def gpt_leaf_numels():
    """GPT-2-large's leaves (`leaf_numels`): its block 36 times."""
    from hetu_tpu_torch.models.gpt import GPTConfig, GPTLMHeadModel
    return leaf_numels(GPTLMHeadModel, GPTConfig.gpt2_large(), ".blocks.")


def gpt_kernel_phase(seed: int):
    """Every kernel of the GPT paths at their shapes (module docstring,
    phase 9).  First the fused norm's LayerNorm arm at GPT-2-large's
    training shape,
    [8192, 1280] (a micro-batch of 8 x 1024 tokens), with a bias: the
    forward and the backward in bf16 and fp32, each timed beside its
    plain version, its bound and the composition it replaces (forward:
    `x + h` then `F.layer_norm`; backward: aten's
    `native_layer_norm_backward` from the saved mean and rstd, then
    `+ dr`; each in one CUDA graph).  Then correctness only: scale-only
    (no bias, no db), hidden 1000 (the masked tail), one row.
    Tolerances: y, s and dx one bf16 ulp (+1e-6: dx can cancel far below
    its terms) in bf16, 1e-5 relative (+1e-5) in fp32; dw and db 1e-5 of
    their largest entry (sums over 8192 rows in another order).  Then
    the fused sampler at the GPT serving path's shape, hidden [40, 1280]
    x the tied head wte.t() [1280, 50257] (a transposed view: the
    product's K-major tensor-core arm).  Then flash, the paged kernels,
    the quantize and the page write (decode [8, 1, 20, 64] on exact and
    int8 pages, a 768-token prefill over 36 layers) at the GPT paths'
    shapes, at the tolerances of `flash_kernel_phase` and
    `serving2_kernel_phase`."""
    import torch.nn.functional as F
    from hetu_tpu_torch.ops.cuda import fused_norm as fn
    from hetu_tpu_torch.ops.cuda import quant as qu

    g = torch.Generator(device="cuda").manual_seed(seed + 6)
    eps = 1e-5
    out = {"residual_layernorm_fwd": [], "residual_layernorm_bwd": [],
           "fused_sample": []}

    def inputs(rows, hidden, dtype, bias):
        def randn(*shape, std=1.0):
            return std * torch.randn(shape, generator=g, device="cuda")
        x, h, dy, dr = (randn(rows, hidden).to(dtype) for _ in range(4))
        w = 1.0 + randn(hidden, std=0.1)
        b = randn(hidden, std=0.1) if bias else None
        return x, h, dy, dr, w, b

    for rows, hidden, dtype, bias, timed in (
            (8192, 1280, torch.bfloat16, True, True),
            (8192, 1280, torch.float32, True, True),
            (8192, 1280, torch.bfloat16, False, False),
            (8192, 1000, torch.bfloat16, True, False),
            (1, 1280, torch.bfloat16, True, False),
            (1, 1280, torch.float32, False, False)):
        x, h, dy, dr, w, b = inputs(rows, hidden, dtype, bias)
        _, s = fn.residual_layernorm_fwd(x, h, w, b, eps)
        bf16 = dtype == torch.bfloat16
        tol = ulps(1, 1e-6) if bf16 else rel(1e-5, 1e-5)
        sums = rel(1e-5, of_max=True)
        text = (f"[{rows},{hidden}] {'bf16' if bf16 else 'fp32'}, "
                f"{'w, b' if bias else 'w (no bias)'} fp32")

        def fwd(i, x=x, h=h, w=w, b=b):
            return fn.residual_layernorm_fwd(x, h, w, b, eps)

        def fwd_plain(i, x=x, h=h, w=w, b=b):
            return fn.residual_layernorm_plain(x, h, w, b, eps)

        def bwd(i, s=s, w=w, dy=dy, dr=dr, bias=bias):
            return tuple(t for t in fn.residual_layernorm_bwd(
                s, w, dy, dr, eps, has_bias=bias) if t is not None)

        def bwd_plain(i, s=s, w=w, dy=dy, dr=dr, bias=bias):
            return tuple(t for t in fn.residual_layernorm_bwd_plain(
                s, w, dy, dr, eps, bias) if t is not None)
        bwd_tols = (tol, sums) + ((sums,) if bias else ())
        if not timed:
            out["residual_layernorm_fwd"].append(checked(
                f"residual_layernorm_fwd {text}", tol, fwd(0),
                fwd_plain(0)))
            out["residual_layernorm_bwd"].append(checked(
                f"residual_layernorm_bwd {text}", bwd_tols, bwd(0),
                bwd_plain(0)))
            continue
        n, esize = rows * hidden, torch.finfo(dtype).bits // 8
        wd, bd = w.to(dtype), b.to(dtype)
        _, mean, rstd = torch.ops.aten.native_layer_norm(s, (hidden,), wd,
                                                         bd, eps)

        def bwd_composition(i, s=s, dy=dy, dr=dr, wd=wd, bd=bd, mean=mean,
                            rstd=rstd):
            dx, dw, db = torch.ops.aten.native_layer_norm_backward(
                dy, s, (hidden,), mean, rstd, wd, bd, [True, True, True])
            return dx + dr, dw, db
        out["residual_layernorm_fwd"].append(case(
            f"residual_layernorm_fwd {text}", tol, fwd, fwd_plain,
            4 * n * esize + 2 * hidden * 4, 8 * n,
            composition=lambda i, x=x, h=h, wd=wd, bd=bd: _add_then(
                F.layer_norm, x, h, (hidden,), wd, bd, eps)))
        out["residual_layernorm_bwd"].append(case(
            f"residual_layernorm_bwd {text}", bwd_tols, bwd, bwd_plain,
            4 * n * esize + 3 * hidden * 4, 18 * n,
            composition=bwd_composition))
        del x, h, dy, dr, s, mean, rstd
    for dtype, odd in ((torch.bfloat16, 1004), (torch.float32, 1002)):
        for name, more in norm_scalar_cases("ln", dtype, 8192, 1280, odd,
                                            g).items():
            out[name] += more
    wte = (0.02 * torch.randn((50257, 1280), generator=g,
                              device="cuda")).bfloat16()
    out["fused_sample"].extend(sampler_cases(
        g, seed, wte.t(), "wte.t() [1280,50257] (tied, transposed)"))
    del wte
    # flash at GPT-2-large's micro-batch: 8 x 1024 tokens, 20 heads of 64
    out.update(flash_timed(g, 8, 1024, 20, 20, 64))
    # AdamW over GPT-2-large's 436 leaves (fp32, as the Trainer keeps
    # them), a leaf of 1,001 elements (a scalar tail) and a view off a
    # 16-byte boundary, in one launch
    numels = gpt_leaf_numels() + [1001, 4096]
    out["adam_update"] = [adam_case(
        f"adam_update GPT-2-large's {len(numels) - 2} leaves + a 1001-element"
        f" leaf + an unaligned view, fp32", numels, torch.float32, g,
        views=(len(numels) - 1,), inner=5)]
    # the same leaves in bf16 with the skip flag clear: phase 14's launch
    numels = gpt_leaf_numels()
    out["adam_update"].append(adam_case(
        f"adam_update GPT-2-large's {len(numels)} leaves, bf16, skip flag "
        "clear", numels, torch.bfloat16, g, inner=5, skip=0))
    # serving: decode on exact and int8 pages, verify on int8 pages
    shape = dict(nq=20, n_kv=20, hd=64, mp=64)
    for name, res in paged_cases(seed + 7, (("none", 1), ("int8", 1),
                                            ("int8", 5)), GPT_DEPTHS,
                                 **shape):
        out.setdefault(name, []).append(res)
    # the quantize at block = head dim 64
    L = 36
    for rows, inner in ((8 * 20, 20), (L * 768 * 20, 2)):
        x = torch.randn((rows, 64), generator=g, device="cuda").bfloat16()
        n = x.numel()
        out.setdefault("quantize_blockwise", []).append(case(
            f"quantize_blockwise [{rows},64] bf16 -> int8", (same(),
                                                             fp32_ulps(1)),
            lambda i, x=x: qu.quantize_blockwise(x, 64),
            lambda i, x=x: qu.quantize_blockwise_plain(x, 64),
            n * 2 + n + rows * 4, 4 * n, inner=inner))
        del x
    # the page write at GPT's serving shapes: a decode step's layer on
    # exact and int8 pages, a 768-token prefill over 36 layers
    out.setdefault("kv_write_tokens", []).extend(kv_token_cases(
        seed + 32, (("none", 1), ("int8", 1)), GPT_DEPTHS, n_kv=20, hd=64,
        mp=64, layout="gpt"))
    out.setdefault("kv_write_pages", []).extend(kv_pages_cases(
        seed + 33, ("none", "int8"), layers=L, tokens=768, max_len=1024,
        n_kv=20, hd=64))
    return out


def _flash_setup(fa, b, sq, sk, hq, hkv, d, dtype, g, *, block=128,
                 causal=True, segments=False, block_mask=None,
                 k_offset=None):
    """Inputs of one flash case on the card, [b, h, s, d] views of
    [b, s, h, d] tensors as the model hands them over, and the static
    arguments every entry takes.  `k_offset`: explicit positions, q at
    0 .. sq - 1 and k from `k_offset` on (a future chunk), over a full
    block mask."""
    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)
    q, do = randn(b, sq, hq, d), randn(b, sq, hq, d)
    k, v = randn(b, sk, hkv, d), randn(b, sk, hkv, d)
    q_pos = (torch.arange(sq, dtype=torch.int32, device="cuda")
             + (sk - sq if k_offset is None else 0)).expand(b, sq)
    k_pos = (torch.arange(sk, dtype=torch.int32, device="cuda")
             + (k_offset or 0)).expand(b, sk)
    q_seg = k_seg = None
    if torch.is_tensor(segments):   # a packed batch's [b, s] segment ids
        q_seg = k_seg = segments.int().contiguous()
    elif segments:          # two packed sequences, cut at a third
        q_seg = (q_pos >= sk // 3).int().contiguous()
        k_seg = (k_pos >= sk // 3).int().contiguous()
    bq, bk = fa.fit_block(block, sq), fa.fit_block(block, sk)
    if block_mask is None:
        block_mask = (fa.causal_block_mask(sq, sk, bq, bk)
                      if causal and k_offset is None
                      else fa.full_block_mask(sq, sk, bq, bk))
    kw = dict(scale=d ** -0.5, causal=causal, block_q=bq, block_k=bk)
    live = torch.tensor(block_mask, dtype=torch.uint8, device="cuda")
    tensors = tuple(t.transpose(1, 2) for t in (q, k, v, do))
    return tensors, (q_pos, k_pos, q_seg, k_seg), kw, block_mask, live


def flash_tolerances(dtype, v):
    """(o, lse), then one for the gradients (`flash_kernel_phase`; the
    fp16 arm: `training4_kernel_phase`)."""
    if dtype == torch.float32:
        of_max = rel(1e-5, 1e-6, of_max=True)
        return (of_max, rel(1e-5, 1e-5)), of_max
    if dtype == torch.float16:
        o_tol = ulps(0.5, 1e-5 + 2.0 ** -10 * v.abs().max().item(), dtype)
        return (o_tol, rel(1e-5, 1e-5)), rel(2.0 ** -10, 1e-6, of_max=True)
    o_tol = ulps(0.5, 1e-5 + 2.0 ** -9 * v.abs().max().item())
    return (o_tol, rel(1e-5, 1e-5)), rel(2.0 ** -8, 1e-6, of_max=True)


def flash_timed(g, b, s, hq, hkv, d, dtype=torch.bfloat16, segments=None,
                layout=""):
    """The three flash kernels at q [b, s, hq, d] over k/v [b, s, hkv, d],
    causal, `dtype` (bf16 or fp16), and with `segments` ([b, s] segment
    ids of a packed batch) the segment mask, held against the plain
    version on the same values in fp32 (`flash_tolerances`) and timed
    beside it, their bounds (two, three and four products of 2 x d
    operations a live element — causal and, with segments, inside one
    segment: what this data needs — over the 16-bit tensor-core peak)
    and `scaled_dot_product_attention` (forward, with segments on an
    explicit boolean mask made before the timing; for the two backward
    kernels its whole backward, forward + backward less forward — one
    call computes dq, dk and dv there).  Returns {kernel: [case]}."""
    import torch.nn.functional as F
    from hetu_tpu_torch.ops.cuda import flash_attention as fa

    tensors, masks, kw, block_mask, live = _flash_setup(
        fa, b, s, s, hq, hkv, d, dtype, g,
        segments=False if segments is None else segments)
    q, k, v, do = tensors
    o, lse = fa._fwd(q, k, v, *masks, block_mask=block_mask, **kw)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, lse, do, delta, *masks)
    if segments is None:
        live_elems = s * (s + 1) // 2 * b * hq
        sdpa_kw = dict(is_causal=True)
    else:
        runs = [torch.unique_consecutive(row, return_counts=True)[1]
                for row in segments.cpu()]
        live_elems = hq * sum(int((n * (n + 1) // 2).sum()) for n in runs)
        same = segments[:, :, None] == segments[:, None, :]
        sdpa_kw = dict(attn_mask=(same & torch.ones(
            s, s, dtype=torch.bool, device="cuda").tril())[:, None])
    qo, kv = q.numel() * 2, k.numel() * 2          # bytes, 16-bit
    stats = lse.numel() * 4

    def sdpa():
        return F.scaled_dot_product_attention(
            q, k, v, enable_gqa=hq != hkv, **sdpa_kw)
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]

    def sdpa_fwd_bwd():     # no .grad to accumulate into: the call alone
        torch.autograd.grad(F.scaled_dot_product_attention(
            *leaves, enable_gqa=hq != hkv, **sdpa_kw), leaves, do)
    with torch.no_grad():
        lib_f = device_ms(sdpa)
    # in a CUDA graph, like the kernels: timed through autograd on the
    # host's clock, a call this short follows the host's load instead
    lib_fb = device_ms(sdpa_fwd_bwd)
    del leaves
    shape = (f"q=[{b},{s},{hq},{d}] kv=[{b},{s},{hkv},{d}] "
             f"{_DTYPE_NAMES[dtype]} causal{layout}")
    f32 = [t.float() for t in (q, k, v)]
    fwd_tols, grad_tol = flash_tolerances(dtype, v)
    fwd = case(
        f"flash_fwd {shape}", fwd_tols,
        lambda i: fa._fwd(q, k, v, *masks, block_mask=block_mask, **kw),
        lambda i: fa.flash_fwd_plain(q, k, v, *masks, live=live, **kw),
        2 * qo + 2 * kv + stats, 4 * d * live_elems,
        exact=lambda i: fa.flash_fwd_plain(*f32, *masks, live=live, **kw),
        library_ms=lib_f, op_dtype=dtype)

    def plain_bwd(i):
        return fa.flash_bwd_plain(*args, live=live, **kw)
    ref = fa.flash_bwd_plain(*f32, lse, do.float(), delta, *masks,
                             live=live, **kw)
    dq = case(
        f"flash_bwd_dq {shape}", grad_tol,
        lambda i: fa.flash_bwd_dq(*args, block_mask=block_mask, **kw),
        lambda i: plain_bwd(i)[0], 2 * qo + 2 * kv + 2 * stats + 2 * qo,
        6 * d * live_elems, exact=lambda i: ref[0],
        library_ms=lib_fb - lib_f, op_dtype=dtype)
    dkv = case(
        f"flash_bwd_dkv {shape}", grad_tol,
        lambda i: fa.flash_bwd_dkv(*args, block_mask=block_mask, **kw),
        lambda i: plain_bwd(i)[1:], 2 * qo + 2 * kv + 2 * stats + 4 * kv,
        8 * d * live_elems, exact=lambda i: ref[1:],
        library_ms=lib_fb - lib_f, op_dtype=dtype)
    for name, fn in (("dq", fa.flash_bwd_dq), ("dkv", fa.flash_bwd_dkv)):
        runs = [fn(*args, block_mask=block_mask, **kw) for _ in range(2)]
        runs = [r if isinstance(r, tuple) else (r,) for r in runs]
        check(all(torch.equal(x, y) for x, y in zip(*runs)),
              f"flash_bwd_{name} {shape}: two runs differ")
    print(f"flash library {shape}: scaled_dot_product_attention forward "
          f"{lib_f:.5f} ms, forward + backward {lib_fb:.5f} ms")
    print(f"flash ratio {shape}: forward kernel / library "
          f"{fwd['ms'] / lib_f:.3f}; dk/dv kernel / library backward "
          f"{dkv['ms'] / (lib_fb - lib_f):.3f}; dq kernel / library "
          f"backward {dq['ms'] / (lib_fb - lib_f):.3f}; dq + dk/dv / "
          f"library backward {(dq['ms'] + dkv['ms']) / (lib_fb - lib_f):.3f}"
          f"; dq and dk/dv two runs identical")
    return {"flash_fwd": [fwd], "flash_bwd_dq": [dq], "flash_bwd_dkv": [dkv]}


def flash_kernel_phase(seed: int):
    """The three flash kernels.  Timed at the training shape, q [2, 2048,
    32, 128] over k/v [2, 2048, 8, 128], bf16, causal (2,098,176 live
    elements a head; `flash_timed`), and at the serving3 draft's q [1,
    256, 32, 64] over 8 kv heads.  Then correctness only at smaller
    shapes: bf16 with segments and GQA, ragged blocks of 96 and a future
    chunk, causal blocks of 512 and a block mask whose first row skips 7
    k blocks that its neighbours see (more tiles stream past a warpgroup
    than the ring has slots); fp32, segments, sq != sk, a block mask
    with a dead row.

    Tolerances, against the plain version on the same values in fp32.
    The fp32 arm runs every product in fp32: 1e-5 of the largest entry
    for o and the gradients, lse 1e-5.  The bf16 arm keeps the softmax,
    lse and every accumulator in fp32 but rounds P and dS to bf16 for
    the tensor cores, as FlashAttention-2 does: each term of an output's
    sum then carries a relative error of at most 2^-9.  For o = sum_j
    p_j v_j / l that is at most 2^-9 max|v| (the p_j / l sum to 1), on
    top of the half bf16 ulp of o's own rounding.  A gradient's terms
    (ds_j k_j, ds_i q_i, p_i do_i) have no such normalisation; their
    errors do not align, and the bound used is 2^-8 of the tensor's
    largest entry (the measured error is printed beside it)."""
    from hetu_tpu_torch.ops.cuda import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(seed + 3)
    out = flash_timed(g, 2, 2048, 32, 8, 128)
    # the serving3 draft's forward (Llama-3.2-1B widths, a 256-token
    # window): one warpgroup a block
    for name, more in flash_timed(g, 1, 256, 32, 8, 64).items():
        out[name].extend(more)

    def run_all(tensors, masks, kw, block_mask, live):
        """(kernel outputs, plain outputs) of forward, dq and dk/dv; the
        plain versions on the same values in fp32, the backward from
        the kernel's own o and lse."""
        q, k, v, do = tensors
        o, lse = fa._fwd(q, k, v, *masks, block_mask=block_mask, **kw)
        delta = (do.float() * o.float()).sum(-1)
        args = (q, k, v, lse, do, delta, *masks)
        dq = fa.flash_bwd_dq(*args, block_mask=block_mask, **kw)
        dkv = fa.flash_bwd_dkv(*args, block_mask=block_mask, **kw)
        f32 = [t.float() for t in (q, k, v)]
        ref_fwd = fa.flash_fwd_plain(*f32, *masks, live=live, **kw)
        ref_bwd = fa.flash_bwd_plain(*f32, lse, do.float(), delta, *masks,
                                     live=live, **kw)
        return ((o, lse), (dq,), dkv), (ref_fwd, ref_bwd[:1], ref_bwd[1:])

    # ---- correctness only
    dead_row = ((True, False, True, False), (False, False, False, False))
    gap = ((True,) + (False,) * 7 + (True,), (True,) * 9, (True,) * 9)
    # the bf16 arm's blocks: wide enough (b x hq) for blocks of two or
    # three warpgroups, a ragged block of 96 (tiles of 64 + 32), a chunk
    # whose keys all lie in the future (every row sees nothing)
    small = (
        ("bf16 segments, GQA, blocks of several warpgroups d=128",
         (2, 256, 256, 72, 36, 128, torch.bfloat16), {"segments": True}),
        ("bf16 ragged blocks of 96 d=64",
         (2, 192, 192, 72, 36, 64, torch.bfloat16), {"block": 96}),
        ("bf16 future chunk d=128", (2, 128, 128, 8, 2, 128, torch.bfloat16),
         {"block": 64, "k_offset": 1000}),
        ("bf16 causal blocks of 512 d=64",
         (2, 1024, 1024, 16, 4, 64, torch.bfloat16), {"block": 512}),
        ("bf16 causal blocks of 512 d=128",
         (2, 1024, 1024, 16, 4, 128, torch.bfloat16), {"block": 512}),
        ("bf16 block mask with a gap of 7 d=64",
         (2, 192, 576, 72, 36, 64, torch.bfloat16),
         {"causal": False, "block": 64, "block_mask": gap}),
        ("bf16 block mask with a gap of 7 d=128",
         (2, 192, 576, 72, 36, 128, torch.bfloat16),
         {"causal": False, "block": 64, "block_mask": gap}),
        ("fp32 causal GQA d=128", (2, 256, 256, 8, 2, 128, torch.float32),
         {}),
        ("fp32 segments d=64", (2, 256, 256, 4, 4, 64, torch.float32),
         {"segments": True}),
        ("bf16 sq != sk d=128", (2, 128, 384, 8, 2, 128, torch.bfloat16),
         {}),
        ("bf16 dead row of the block mask d=64",
         (2, 128, 256, 4, 1, 64, torch.bfloat16),
         {"causal": False, "block": 64, "block_mask": dead_row}),
    )
    for label, dims, opts in small:
        setup = _flash_setup(fa, *dims, g, **opts)
        got, want = run_all(*setup)
        fwd_tols, grad_tol = flash_tolerances(dims[-1], setup[0][2])
        for name, tols, mine, theirs in zip(
                out, (fwd_tols, grad_tol, grad_tol), got, want):
            out[name].append(checked(f"{name} {label}", tols, mine, theirs))
        if opts.get("block_mask") is dead_row or "k_offset" in opts:
            # the dead row, the future chunk: o = 0, lse = -1e30, dq = 0
            rows = slice(64, None) if "block_mask" in opts else slice(None)
            o, lse = got[0]
            check(bool((o[:, :, rows] == 0).all())
                  and bool((lse[:, :, rows] == fa.NEG_INF).all())
                  and bool((got[1][0][:, :, rows] == 0).all()),
                  f"flash {label}: rows that see nothing are not o = 0, "
                  f"lse = -1e30, dq = 0")
    return out


def kernel_table():
    """{kernel: (wrapper module, its launch counter, source, the TPU
    kernel it replaces)} for every ported kernel; a counter (name, arm)
    is that arm's share of the module's `arm_launches[name]`."""
    from hetu_tpu_torch.ops.cuda import adam as ad
    from hetu_tpu_torch.ops.cuda import flash_attention as fa
    from hetu_tpu_torch.ops.cuda import fused_norm as fn
    from hetu_tpu_torch.ops.cuda import kv_write as kw
    from hetu_tpu_torch.ops.cuda import paged_attention as pa
    from hetu_tpu_torch.ops.cuda import quant as qu
    from hetu_tpu_torch.ops.cuda import rotary as ro
    from hetu_tpu_torch.ops.cuda import sample as sa
    from hetu_tpu_torch.ops.cuda import swiglu as sw
    src, tpu = "hetu_tpu_torch/csrc/", "hetu_tpu/ops/pallas/"
    return {
        "paged_attention": (pa, "launches", src + "paged_attention.cuh",
                            tpu + "paged_attention.py:285"),
        "fused_rotary_qk": (ro, "launches", src + "rotary.cu",
                            tpu + "rotary.py:82"),
        "fused_swiglu": (sw, "launches", src + "swiglu.cu",
                         tpu + "swiglu.py:74"),
        "residual_rmsnorm_fwd": (fn, "launches", src + "fused_norm.cu",
                                 tpu + "fused_norm.py:138"),
        "residual_rmsnorm_bwd": (fn, "bwd_launches", src + "fused_norm.cu",
                                 tpu + "fused_norm.py:157"),
        "swiglu_bwd": (sw, "bwd_launches", src + "swiglu.cu",
                       tpu + "swiglu.py:103"),
        "rotary_qk_bwd": (ro, "bwd_launches", src + "rotary.cu",
                          tpu + "rotary.py:112"),
        "adam_update": (ad, "launches", src + "adam.cu", tpu + "adam.py:87"),
        # AdamW's fp16 parameter arm (phase 20)
        "adam_update_f16": (ad, ("launches", "f16"), src + "adam.cu",
                            tpu + "adam.py:87"),
        "flash_fwd": (fa, "launches", src + "flash_attention.cu",
                      tpu + "flash_attention.py:246"),
        "flash_bwd_dq": (fa, "dq_launches", src + "flash_attention.cu",
                         tpu + "flash_attention.py:328"),
        "flash_bwd_dkv": (fa, "dkv_launches", src + "flash_attention.cu",
                          tpu + "flash_attention.py:368"),
        "paged_attention_int8": (pa, "int8_launches",
                                 src + "paged_attention.cuh",
                                 tpu + "paged_attention.py:137"),
        "paged_attention_int4": (pa, "int4_launches",
                                 src + "paged_attention.cuh",
                                 tpu + "paged_attention.py:137"),
        "paged_verify": (pa, "verify_launches", src + "paged_attention.cuh",
                         tpu + "paged_attention.py:345"),
        "quantize_blockwise": (qu, "launches", src + "quant.cu",
                               tpu + "quant.py:78"),
        "kv_write_tokens": (kw, "launches", src + "kv_write.cu",
                            tpu + "quant.py:78"),
        "kv_write_pages": (kw, "pages_launches", src + "kv_write.cu",
                           tpu + "quant.py:78"),
        "fused_sample": (sa, "launches", src + "sample.cu",
                         tpu + "sample.py:188"),
        "sample_logits": (sa, "logits_launches", src + "sample.cu",
                          tpu + "sample.py:156"),
        "dequantize_blockwise": (qu, "dequant_launches", src + "quant.cu",
                                 tpu + "quant.py:103"),
        "residual_layernorm_fwd": (fn, "ln_launches", src + "fused_norm.cu",
                                   tpu + "fused_norm.py:235"),
        "residual_layernorm_bwd": (fn, "ln_bwd_launches",
                                   src + "fused_norm.cu",
                                   tpu + "fused_norm.py:208"),
        # the fp16 arms, each read from its counter's launches by arm
        # (`arm_launches`; the launches are in the totals above too)
        "flash_fwd_f16": (fa, ("launches", "f16"), src + "flash_attention.cu",
                          tpu + "flash_attention.py:246"),
        "flash_bwd_dq_f16": (fa, ("dq_launches", "f16"),
                             src + "flash_attention.cu",
                             tpu + "flash_attention.py:328"),
        "flash_bwd_dkv_f16": (fa, ("dkv_launches", "f16"),
                              src + "flash_attention.cu",
                              tpu + "flash_attention.py:368"),
        "residual_rmsnorm_fwd_f16": (fn, ("launches", "f16"),
                                     src + "fused_norm.cu",
                                     tpu + "fused_norm.py:138"),
        "residual_rmsnorm_bwd_f16": (fn, ("bwd_launches", "f16"),
                                     src + "fused_norm.cu",
                                     tpu + "fused_norm.py:157"),
        "residual_layernorm_fwd_f16": (fn, ("ln_launches", "f16"),
                                       src + "fused_norm.cu",
                                       tpu + "fused_norm.py:235"),
        "residual_layernorm_bwd_f16": (fn, ("ln_bwd_launches", "f16"),
                                       src + "fused_norm.cu",
                                       tpu + "fused_norm.py:208"),
        "fused_swiglu_f16": (sw, ("launches", "f16"), src + "swiglu.cu",
                             tpu + "swiglu.py:74"),
        "swiglu_bwd_f16": (sw, ("bwd_launches", "f16"), src + "swiglu.cu",
                           tpu + "swiglu.py:103"),
        "fused_rotary_qk_f16": (ro, ("launches", "f16"), src + "rotary.cu",
                                tpu + "rotary.py:82"),
        "rotary_qk_bwd_f16": (ro, ("bwd_launches", "f16"), src + "rotary.cu",
                              tpu + "rotary.py:112"),
        # the serving kernels' fp16 arms (phase 19), the same way
        "paged_attention_f16": (pa, ("launches", "f16"),
                                src + "paged_attention_f16.cu",
                                tpu + "paged_attention.py:285"),
        "paged_attention_int8_f16": (pa, ("int8_launches", "f16"),
                                     src + "paged_attention_f16.cu",
                                     tpu + "paged_attention.py:137"),
        "paged_attention_int4_f16": (pa, ("int4_launches", "f16"),
                                     src + "paged_attention_f16.cu",
                                     tpu + "paged_attention.py:137"),
        "paged_verify_f16": (pa, ("verify_launches", "f16"),
                             src + "paged_attention_f16.cu",
                             tpu + "paged_attention.py:345"),
        "quantize_blockwise_f16": (qu, ("launches", "f16"), src + "quant.cu",
                                   tpu + "quant.py:78"),
        "kv_write_tokens_f16": (kw, ("launches", "f16"), src + "kv_write.cu",
                                tpu + "quant.py:78"),
        "kv_write_pages_f16": (kw, ("pages_launches", "f16"),
                               src + "kv_write.cu", tpu + "quant.py:78"),
        "fused_sample_f16": (sa, ("launches", "f16"), src + "sample.cu",
                             tpu + "sample.py:188"),
        "sample_logits_f16": (sa, ("logits_launches", "f16"),
                              src + "sample.cu", tpu + "sample.py:156"),
        "dequantize_blockwise_f16": (qu, ("dequant_launches", "f16"),
                                     src + "quant.cu", tpu + "quant.py:103"),
    }


#: AdamW's launches by arm over the paths' runs (the `kernels` line)
ADAM_ARMS = {"f32": 0, "bf16": 0, "f16": 0}


def zero_counts(kernels):
    from hetu_tpu_torch.ops.cuda import sample as sa
    for mod, attr, *_ in kernels.values():
        if isinstance(attr, str):
            setattr(mod, attr, 0)
        for arms in getattr(mod, "arm_launches", {}).values():
            arms.update(dict.fromkeys(arms, 0))
    for arm in sa.lm_head_routes:
        sa.lm_head_routes[arm] = 0


def check_adam_arm(label, per_step: int, arm: str):
    """Since `zero_counts`, AdamW launched `per_step` times, all on
    `arm`; adds them to ADAM_ARMS."""
    from hetu_tpu_torch.ops.cuda import adam as ad
    arms = ad.arm_launches["launches"]
    expect = dict.fromkeys(arms, 0)
    expect[arm] = per_step
    check(arms == expect, f"{label}: AdamW arms {arms}, expected {expect}")
    for a, n in arms.items():
        ADAM_ARMS[a] += n


def check_product_arm(path, launches, arm):
    """Every `fused_sample` launch of the run since `zero_counts` took
    the product's `arm` (`sample.lm_head_routes`)."""
    from hetu_tpu_torch.ops.cuda import sample as sa
    expect = dict.fromkeys(sa.lm_head_routes, 0)
    expect[arm] = launches["fused_sample"]
    check(sa.lm_head_routes == expect, f"{path}: product arms "
          f"{sa.lm_head_routes}, expected {expect}")
    print(f"{path}: product arms {sa.lm_head_routes}")


def launch_count(mod, attr) -> int:
    """A kernel table counter's launches: the module's total `attr`, or
    for (name, arm) that arm's launches of `name`."""
    if isinstance(attr, str):
        return getattr(mod, attr)
    name, arm = attr
    return mod.arm_launches[name][arm]


def read_counts(kernels):
    return {name: launch_count(mod, attr)
            for name, (mod, attr, *_) in kernels.items()}


# ---------------------------------------------------------- reference
def reference_phase(seed: int, kernels):
    """Llama-3-8B widths at 1 layer, fp32: engine on the card vs the
    same engine on the CPU, greedy on exact pages, then the second
    serving slice (`reference_spec_phase`) and the third
    (`reference_serving3_phase`)."""
    from hetu_tpu_torch.models.generation import extend_cache
    from hetu_tpu_torch.models.llama import LlamaConfig, LlamaLMHeadModel
    from hetu_tpu_torch.serving import (ServeConfig, ServingEngine,
                                        poisson_arrivals, synthetic_requests)

    cfg = LlamaConfig.llama3_8b(num_hidden_layers=1,
                                compute_dtype=torch.float32)
    t0 = time.perf_counter()
    card = LlamaLMHeadModel(cfg, device="cuda", seed=seed)
    cpu = LlamaLMHeadModel(cfg, device="cpu", seed=seed)
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    serve = ServeConfig(num_slots=2, page_size=16, max_len=256,
                        prefill_chunk=64)
    ids = np.random.default_rng(seed).integers(0, cfg.vocab_size, (1, 64))
    logits = []
    tokens = []
    for model, dev in ((card, "cuda"), (cpu, "cpu")):
        shape = (2, 1, 256, cfg.num_key_value_heads, cfg.head_dim)
        scratch = (torch.zeros(shape, device=dev), torch.zeros(shape,
                                                               device=dev))
        lg, _ = extend_cache(model, torch.as_tensor(ids, device=dev),
                             scratch, 0)
        logits.append(lg.cpu())
        reqs = synthetic_requests(
            2, vocab_size=cfg.vocab_size, prompt_lens=(70, 120),
            max_new=(4, 4), arrivals=poisson_arrivals(2, 100.0, seed=seed),
            seed=seed)
        eng = ServingEngine(model, serve, device=dev).warmup()
        tokens.append([r.tokens for r in eng.run(reqs)])
    err = (logits[0] - logits[1]).abs().max().item()
    check(bool(torch.isfinite(logits[0]).all()), "non-finite logits")
    check(tuple(logits[0].shape) == (1, 64, cfg.vocab_size),
          f"logits shape {tuple(logits[0].shape)}")
    check(err <= 1e-3, f"card vs CPU prefill logits differ by {err}")
    check(tokens[0] == tokens[1], f"card vs CPU tokens differ: {tokens}")
    print(f"reference: Llama-3-8B widths, {cfg.num_hidden_layers} layer, "
          f"fp32: card vs CPU "
          f"prefill logits max_abs_err={err:.3g} (tol 1e-3); greedy tokens "
          f"identical {tokens[0]} ({time.perf_counter() - t0:.1f}s)")
    launches = reference_spec_phase(seed, card, cpu, kernels)
    reference_serving3_phase(seed, card, cpu)
    return launches


class EngineProbe:
    """Replaces the engine module's functions named in `names` by those
    of `wrappers(saved)` for a `with` block and puts the saved ones back
    on exit; `eng` is the engine the probe reads slots from."""
    names = ()

    def __init__(self, engine_mod):
        self.mod, self.eng = engine_mod, None
        self.saved = {n: getattr(engine_mod, n) for n in self.names}

    def wrappers(self, saved):
        raise NotImplementedError

    def __enter__(self):
        for name, fn in self.wrappers(self.saved).items():
            setattr(self.mod, name, fn)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.mod, name, fn)


class GapProbe(EngineProbe):
    """On the CPU engine, the gap between the two best entries of what
    each token's argmax ran over — the raw logits for a greedy token,
    filtered logits + Gumbel noise for a sampled one — keyed by (request,
    position): the engine module's samplers are wrapped for the run."""
    names = ("sample_tokens", "sample_hidden_grid", "first_token_from_logits")

    def __init__(self, engine_mod):
        super().__init__(engine_mod)
        self.gaps = {}

    @staticmethod
    def _gap(logits, seeds, positions, temps, top_ks, top_ps):
        from hetu_tpu_torch.ops.cuda import sample as sa
        from hetu_tpu_torch.serving.sampling import key_words
        w = key_words(seeds, positions)
        temps, top_ks, top_ps = (torch.as_tensor(np.asarray(t))
                                 for t in (temps, top_ks, top_ps))
        idx = torch.arange(logits.shape[-1])[None]
        noisy = sa.filtered_logits(logits, temps, top_ks, top_ps) \
            + sa.gumbel(w[:, :1], w[:, 1:], idx)
        v = torch.where(temps[:, None] > 0, noisy, logits.float())
        top = v.topk(2, dim=-1).values
        return (top[:, 0] - top[:, 1]).tolist()

    def _note(self, slots, positions, gaps):
        for s, p, g in zip(slots, positions, gaps):
            st = self.eng.scheduler.slots[s]
            if st is not None:
                self.gaps[(st.request.rid, int(p))] = g

    def wrappers(self, saved):
        def sample_tokens(logits, seeds, positions, *rest, device):
            if logits.shape[0] == self.eng.config.num_slots:
                self._note(range(logits.shape[0]), positions,
                           self._gap(logits, seeds, positions, *rest))
            return saved["sample_tokens"](logits, seeds, positions, *rest,
                                          device=device)

        def sample_hidden_grid(hidden, w, seeds, pos_grid, *rest, device):
            S, C, _ = hidden.shape
            logits = (hidden.float() @ w.float()).reshape(S * C, -1)
            rep = [np.repeat(t, C) for t in (seeds, *rest)]
            gaps = self._gap(logits, rep[0], pos_grid.reshape(-1), *rep[1:])
            self._note([s for s in range(S) for _ in range(C)],
                       pos_grid.reshape(-1), gaps)
            return saved["sample_hidden_grid"](hidden, w, seeds, pos_grid,
                                               *rest, device=device)

        def first_token_from_logits(req, row, position, *, sampling):
            sp = req.sampling
            on = sampling and sp.temperature > 0
            self.gaps[(req.rid, position)] = self._gap(
                row[None], [sp.seed & 0xFFFFFFFF], [position],
                [sp.temperature if on else 0.0], [sp.top_k],
                [sp.top_p])[0]
            return saved["first_token_from_logits"](req, row, position,
                                                    sampling=sampling)
        return {"sample_tokens": sample_tokens,
                "sample_hidden_grid": sample_hidden_grid,
                "first_token_from_logits": first_token_from_logits}


def oracle_drafter(reqs, results):
    """A drafter that proposes, for each request (found by its prompt),
    the continuation a run without speculation emitted: drafts are
    accepted until the run under test departs from that run, so the
    verify step emits several tokens a slot, writes drafts' K/V into
    the lookahead pages and drops surplus drafts at the length limit."""
    from hetu_tpu_torch.serving.spec_decode import CallableDrafter
    prompts = {r.rid: r.prompt.tolist() for r in reqs}
    conts = [(prompts[res.rid], res.tokens) for res in results]

    def propose(tokens, k):
        tokens = list(tokens)
        for prompt, cont in conts:
            if tokens[:len(prompt)] == prompt:
                done = len(tokens) - len(prompt)
                out = list(cont[done:done + k])
                return out + [0] * (k - len(out))
        raise ValueError("oracle drafter: a prompt no run produced")
    return CallableDrafter(propose)


def reference_spec_phase(seed: int, card, cpu, kernels):
    """The second serving slice against the CPU on the same 2-layer
    fp32 models, half the requests seeded-sampled (temperature 0.8,
    top-k 50, top-p 0.95): (i) n-gram speculation on exact pages, tokens
    identical; (ii) the same on int8 pages and (iii) int4 pages without
    speculation, tokens identical or the first divergence at a token
    whose CPU top-two gap after noise is under 1e-3 (quantization
    rounds a card/CPU difference of 1e-6 in K/V to a whole step now and
    then).  (i) and (ii) run again with `oracle_drafter` over the CPU's
    run of the trace without speculation: the CPU's tokens must equal
    that run's, the card's the CPU's (as above), and the card must
    accept drafts.  Returns path (iii)'s launch counts (the int4 arm's
    path)."""
    import hetu_tpu_torch.serving.engine as engine_mod
    from hetu_tpu_torch.serving import (SamplingParams, ServeConfig,
                                        ServingEngine, poisson_arrivals,
                                        synthetic_requests)
    cfg = card.config

    def trace():
        # two requests: one greedy, one sampled
        reqs = synthetic_requests(
            2, vocab_size=cfg.vocab_size, prompt_lens=(20, 60),
            max_new=(8, 8), arrivals=poisson_arrivals(2, 100.0, seed=seed),
            seed=seed + 1)
        for r in reqs[1::2]:
            r.sampling = SamplingParams(temperature=0.8, top_k=50,
                                        top_p=0.95, seed=seed + r.rid)
        return reqs

    def serve(**opts):
        return ServeConfig(num_slots=2, page_size=16, max_len=256,
                           prefill_chunk=64, sampling=True, **opts)

    def run_pair(config, drafter=None):
        """(card results, CPU results, the CPU run's gaps, card
        launches)."""
        runs, launches = [], None
        for model in (card, cpu):
            eng = ServingEngine(model, config, device=model.device,
                                drafter=drafter).warmup()
            zero_counts(kernels)
            if model is cpu:
                with GapProbe(engine_mod) as probe:
                    probe.eng = eng
                    res = eng.run(trace())
            else:
                res = eng.run(trace())
                launches = read_counts(kernels)
            eng.scheduler.check_invariants()
            runs.append(res)
        return runs[0], runs[1], probe.gaps, launches

    def compare(label, a_runs, b_runs, gaps, exact):
        firsts = []
        for a, b in zip(a_runs, b_runs):
            check(len(a.tokens) == len(b.tokens) == 8,
                  f"{label}: request {a.rid} emitted {len(a.tokens)} / "
                  f"{len(b.tokens)} tokens")
            t = next((i for i, (x, y) in enumerate(zip(a.tokens, b.tokens))
                      if x != y), None)
            if t is None:
                continue
            plen = next(r.prompt_len for r in trace() if r.rid == a.rid)
            gap = gaps.get((a.rid, plen + t), float("inf"))
            firsts.append((a.rid, t, gap))
            check(not exact and gap < 1e-3,
                  f"{label}: request {a.rid} diverges at token {t} where "
                  f"the CPU top-two gap after noise is {gap}")
        return firsts

    launches = None
    for label, opts in (("(i) sampled + ngram spec, exact pages",
                         dict(spec_decode="ngram", spec_k=4)),
                        ("(ii) sampled + ngram spec, int8 pages",
                         dict(spec_decode="ngram", spec_k=4,
                              kv_quant="int8")),
                        ("(iii) sampled, int4 pages",
                         dict(kv_quant="int4"))):
        t0 = time.perf_counter()
        passes = [(label, None)]
        if "spec" in label:
            # the trace without speculation, on the CPU: the oracle's
            # continuation and the tokens speculation must reproduce
            base_opts = {k: v for k, v in opts.items()
                         if k not in ("spec_decode", "spec_k")}
            eng = ServingEngine(cpu, serve(**base_opts), device="cpu")
            base = eng.warmup().run(trace())
            passes.append((label.replace("ngram", "oracle-drafted"),
                           oracle_drafter(trace(), base)))
        for name, drafter in passes:
            card_res, cpu_res, gaps, counts = run_pair(serve(**opts),
                                                       drafter)
            if "int4" in name:
                launches = counts
            firsts = compare(name, card_res, cpu_res, gaps,
                             exact="exact" in name)
            tokens = [r.tokens for r in card_res]
            acc = sum(r.stats.spec_accepted for r in card_res)
            prop = sum(r.stats.spec_proposed for r in card_res)
            if drafter is not None:
                compare(name + " (CPU, with and without speculation)",
                        cpu_res, base, gaps, exact=True)
                check(acc > 0, f"{name}: the card accepted no draft")
            print(f"reference {name}: card vs CPU tokens "
                  + (f"identical {tokens}" if not firsts else
                     f"{tokens}; first divergences (request, token, CPU "
                     f"gap) {firsts}")
                  + f"; spec accepted {acc} of {prop} "
                  f"({time.perf_counter() - t0:.1f}s)")
    return launches


# ------------------------------------------------------------ serving
def serving_phase(seed: int, kernels):
    from hetu_tpu_torch.models.llama import LlamaConfig, LlamaLMHeadModel
    from hetu_tpu_torch.serving import (ServeConfig, ServingEngine,
                                        poisson_arrivals, synthetic_requests)

    # depth cut to 8 for the smoke's time (phase 19 serves Llama-2-7B
    # at its full 32 layers)
    cfg = LlamaConfig.llama3_8b(num_hidden_layers=8,
                                param_dtype=torch.bfloat16)
    t0 = time.perf_counter()
    model = LlamaLMHeadModel(cfg, device="cuda", seed=seed)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == cfg.num_params(), "parameter count")
    print(f"serving: Llama-3-8B {cfg.num_hidden_layers} layers, "
          f"{n_params / 1e9:.3f}B params bf16, drawn on the card in "
          f"{time.perf_counter() - t0:.1f}s")
    serve = ServeConfig(num_slots=8, page_size=16, max_len=2048,
                        prefill_chunk=256)
    eng = ServingEngine(model, serve, device="cuda")
    t0 = time.perf_counter()
    eng.warmup()
    print(f"serving: warmup {time.perf_counter() - t0:.2f}s")
    reqs = synthetic_requests(
        8, vocab_size=cfg.vocab_size, prompt_lens=(64, 1024),
        max_new=(32, 32), arrivals=poisson_arrivals(8, 10.0, seed=seed),
        seed=seed)
    check(sum(r.prompt_len > serve.prefill_chunk for r in reqs) >= 2,
          "the trace has too few multi-chunk prompts")
    torch.cuda.reset_peak_memory_stats()
    start_gb = torch.cuda.memory_allocated() / 2 ** 30
    zero_counts(kernels)
    t0 = time.perf_counter()
    results = eng.run(reqs)
    wall = time.perf_counter() - t0
    launches = read_counts(kernels)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30

    check(len(results) == len(reqs), f"{len(results)} of {len(reqs)} done")
    for r in results:
        check(r.finished_reason == "length" and len(r.tokens) == 32,
              f"request {r.rid}: {r.finished_reason}, {len(r.tokens)} "
              "tokens")
        check(all(0 <= t < cfg.vocab_size for t in r.tokens),
              f"request {r.rid}: token out of the vocabulary")
    eng.scheduler.check_invariants()
    check(eng.pool.free_count == eng.pool.num_pages, "pages leaked")
    reg = eng.registry
    steps = int(reg.counter_value("serve.decode_steps"))
    chunks = int(reg.counter_value("serve.prefill_chunks"))
    L = cfg.num_hidden_layers
    check(launches["paged_attention"] == steps * L,
          "paged_attention launches != decode steps x layers")
    check(launches["fused_rotary_qk"] == (steps + chunks) * L
          and launches["fused_swiglu"] == (steps + chunks) * L,
          "rotary/swiglu launches != (decode steps + chunks) x layers")
    check(launches["kv_write_tokens"] == steps * L
          and launches["kv_write_pages"] == len(reqs),
          "page writes != decode steps x layers, and one a prefill")
    check(all(n == 0 for name, n in launches.items()
              if name not in ("paged_attention", "fused_rotary_qk",
                              "fused_swiglu", "kv_write_tokens",
                              "kv_write_pages")),
          f"a training kernel launched while serving: {launches}")
    ttft = sorted(r.stats.ttft_s for r in results)
    e2e = sorted(r.stats.e2e_s for r in results)
    decode = reg.histogram("serve.token_latency_s")
    tokens_out = sum(len(r.tokens) for r in results)
    decode_tokens = sum(len(r.tokens) - 1 for r in results)
    out = {
        "requests": len(results), "prompt_tokens":
            sum(r.prompt_len for r in reqs),
        "tokens_out": tokens_out,
        "decode_steps": steps, "prefill_chunks": chunks,
        "ttft_s_p50": ttft[len(ttft) // 2], "ttft_s_max": ttft[-1],
        "e2e_s_p50": e2e[len(e2e) // 2], "e2e_s_max": e2e[-1],
        "decode_step_s_p50": decode.percentile(50),
        "decode_step_s_max": decode.vmax,
        # end to end: every token out over the whole run's wall time
        "tokens_per_s": tokens_out / wall,
        # the decode layer alone: decode tokens over decode calls' wall
        "decode_only_tokens_per_s": decode_tokens / decode.total,
        "run_wall_s": wall, "peak_memory_gib": peak_gb,
        "memory_at_start_gib": start_gb,
        "launches": launches,
    }
    print("serving " + json.dumps(out))
    serving_time_phase(eng, reqs)
    del eng
    return {"serving": launches, **serving2_phase(model, seed, kernels),
            **serving3_phase(model, seed, kernels)}


def serving2_phase(model, seed: int, kernels):
    """The second serving slice on phase 5's model and trace, half the
    requests at SamplingParams(temperature=0.8, top_k=50, top_p=0.95):
    (b) int8 pages + seeded sampling (the int8 decode arm), then (a) the
    same + n-gram speculation (ServeConfig(spec_decode="ngram",
    spec_k=4)), then (a) again with `oracle_drafter` over (a)'s tokens
    in the n-gram drafter's place: random weights give prompt lookup
    nothing to find, so only drafts that can match make the verify step
    emit several tokens a slot, and its tokens must equal (a)'s (a
    token's sampling never depends on the drafts).  Every launch count
    is exact per run; the requests whose tokens equal (b)'s are counted
    (the bf16 verify and decode steps may part at a near-tie); TTFT,
    the decode gap, tokens/s, acceptance, tokens a verify step and peak
    memory are printed, and (b) and (a) profile one step each (a
    sampled int8 decode step; a verify step with its sampling
    epilogue)."""
    from hetu_tpu_torch.serving import (SamplingParams, ServeConfig,
                                        ServingEngine, poisson_arrivals,
                                        synthetic_requests)
    cfg = model.config
    L = cfg.num_hidden_layers
    by_path = {}

    def trace():
        reqs = synthetic_requests(
            8, vocab_size=cfg.vocab_size, prompt_lens=(64, 1024),
            max_new=(32, 32), arrivals=poisson_arrivals(8, 10.0, seed=seed),
            seed=seed)
        for r in reqs[1::2]:
            r.sampling = SamplingParams(temperature=0.8, top_k=50,
                                        top_p=0.95, seed=seed + 100 + r.rid)
        return reqs

    spec = dict(spec_decode="ngram", spec_k=4)
    tokens = {}
    for path, opts, oracle_of in (
            ("serving_int8", {}, None),
            ("serving_spec_int8", spec, None),
            ("serving_spec_int8_oracle", spec, "serving_spec_int8")):
        gc.collect()
        torch.cuda.empty_cache()
        serve = ServeConfig(num_slots=8, page_size=16, max_len=2048,
                            prefill_chunk=256, kv_quant="int8",
                            sampling=True, **opts)
        drafter = (oracle_drafter(trace(), tokens[oracle_of]) if oracle_of
                   else None)
        eng = ServingEngine(model, serve, device="cuda",
                            drafter=drafter).warmup()
        reqs = trace()
        torch.cuda.reset_peak_memory_stats()
        start_gb = torch.cuda.memory_allocated() / 2 ** 30
        zero_counts(kernels)
        t0 = time.perf_counter()
        results = eng.run(reqs)
        wall = time.perf_counter() - t0
        launches = read_counts(kernels)
        check_product_arm(path, launches, "n_major")
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        check(len(results) == len(reqs), f"{path}: {len(results)} done")
        for r in results:
            check(r.finished_reason == "length" and len(r.tokens) == 32,
                  f"{path}: request {r.rid}: {r.finished_reason}, "
                  f"{len(r.tokens)} tokens")
            check(all(0 <= t < cfg.vocab_size for t in r.tokens),
                  f"{path}: request {r.rid}: token out of the vocabulary")
        eng.scheduler.check_invariants()
        check(eng.pool.free_count == eng.pool.num_pages,
              f"{path}: pages leaked")
        reg = eng.registry
        steps = int(reg.counter_value("serve.decode_steps"))
        chunks = int(reg.counter_value("serve.prefill_chunks"))
        sampled = sum(not r.sampling.greedy for r in reqs)
        # each layer of a step writes its K and V in one launch, each
        # prefill its pages in one; the quantize launches no more
        expect = {name: 0 for name in kernels}
        expect.update(fused_rotary_qk=(steps + chunks) * L,
                      fused_swiglu=(steps + chunks) * L,
                      kv_write_tokens=L * steps, kv_write_pages=len(reqs))
        if eng.spec:
            expect.update(paged_verify=steps * L, fused_sample=steps,
                          sample_logits=sampled)
        else:
            expect.update(paged_attention_int8=steps * L,
                          sample_logits=steps + sampled)
        check(launches == expect, f"{path}: launches {launches}, "
                                  f"expected {expect}")
        ttft = sorted(r.stats.ttft_s for r in results)
        gap = reg.histogram("serve.token_latency_s")
        tokens_out = sum(len(r.tokens) for r in results)
        decode_tokens = tokens_out - len(results)
        prop = int(reg.counter_value("serve.spec_proposed"))
        acc = int(reg.counter_value("serve.spec_accepted"))
        out = {
            "config": {k: getattr(serve, k) for k in (
                "num_slots", "page_size", "max_len", "prefill_chunk",
                "kv_quant", "sampling", "spec_decode", "spec_k")},
            "requests": len(results), "sampled_requests": sampled,
            "tokens_out": tokens_out, "decode_steps": steps,
            "prefill_chunks": chunks,
            "ttft_s_p50": ttft[len(ttft) // 2], "ttft_s_max": ttft[-1],
            "decode_step_s_p50": gap.percentile(50),
            "decode_step_s_max": gap.vmax,
            "tokens_per_s": tokens_out / wall,
            "decode_only_tokens_per_s": decode_tokens / gap.total,
            "decode_tokens_per_step": decode_tokens / steps,
            "run_wall_s": wall, "peak_memory_gib": peak_gb,
            "memory_at_start_gib": start_gb,
            "launches": launches,
        }
        tokens[path] = results
        if eng.spec:
            emitted = reg.histogram("serve.spec_emitted")
            out.update(spec_proposed=prop, spec_accepted=acc,
                       acceptance=acc / prop,
                       tokens_per_verify_step_per_slot=(
                           emitted.total / emitted.count),
                       requests_equal_to_serving_int8=sum(
                           a.tokens == b.tokens for a, b in
                           zip(results, tokens["serving_int8"])))
        if oracle_of:
            # the verify step's tokens do not depend on the drafts
            check(acc > 0, f"{path}: no draft accepted")
            check([r.tokens for r in results]
                  == [r.tokens for r in tokens[oracle_of]],
                  f"{path}: tokens differ from {oracle_of}'s")
        print(f"{path} " + json.dumps(out))
        if not oracle_of:
            serving_time_phase(eng, reqs)
        by_path[path] = launches
        del eng
    return by_path


def draft_config():
    """The draft model: Llama-3.2-1B's published widths (hidden 2048, 16
    layers, 32 q / 8 kv heads of 64, SwiGLU 8192, vocab 128256, rope
    theta 500000, tied embeddings), bf16.  Cut: no llama3 RoPE scaling
    (the reference's config has no field for it), 8,192 positions,
    random weights."""
    from hetu_tpu_torch.models.llama import LlamaConfig
    return LlamaConfig(vocab_size=128256, hidden_size=2048,
                       intermediate_size=8192, num_hidden_layers=16,
                       num_attention_heads=32, num_key_value_heads=8,
                       max_position_embeddings=8192, rope_theta=500000.0,
                       tie_word_embeddings=True,
                       param_dtype=torch.bfloat16)


def serving3_kernel_phase(seed: int):
    """The blockwise dequantize at the third serving slice's shapes: the
    draft model's largest leaf, the tied embedding [128256 x 2048] as
    [nb, 128] (the path's block) and [nb, 64], and payloads [4096, 64]
    and [4096, 128]; each in the bf16 arm (the draft's working copy) and
    the fp32 arm, bit for bit against the plain version (the bf16 arm
    against it cast once).  `library_ms` is PyTorch's per-channel
    quantized tensor over the same payload and scales (a qint8 tensor
    with one scale a row, built before the timing): `.dequantize()`,
    float(q) * scale[row] in fp32, and for the bf16 arm that and a cast.
    It cannot be captured in a CUDA graph, so it is timed between CUDA
    events; the port never calls it."""
    from hetu_tpu_torch.ops.cuda import quant as qu
    g = torch.Generator(device="cuda").manual_seed(seed + 30)
    emb = 128256 * 2048
    out = []
    for nb, bs, inner in ((emb // 128, 128, 2), (emb // 64, 64, 2),
                          (4096, 64, 20), (4096, 128, 20)):
        x = (0.02 * torch.randn((nb, bs), generator=g,
                                device="cuda")).bfloat16()
        q, s = qu.quantize_blockwise(x, bs)
        del x
        n = nb * bs
        qt = torch._make_per_channel_quantized_tensor(
            q, s.double(), torch.zeros(nb, dtype=torch.long,
                                       device="cuda"), 0)
        for dt in (torch.bfloat16, torch.float32):
            esize = torch.finfo(dt).bits // 8
            library = (lambda qt=qt, dt=dt: qt.dequantize().to(dt))
            lib_same = torch.equal(
                library(), qu.dequantize_blockwise_plain(q, s).to(dt)
                .view(nb, bs))
            out.append(case(
                f"dequantize_blockwise q [{nb},{bs}] int8 -> "
                f"{str(dt)[6:]}", same(),
                lambda i, q=q, s=s, dt=dt:
                    qu.dequantize_blockwise(q, s, out_dtype=dt),
                lambda i, q=q, s=s, dt=dt:
                    qu.dequantize_blockwise_plain(q, s).to(dt),
                n + 4 * nb + esize * n, n, inner=inner,
                library_ms=event_ms(library, reps=20)))
            print(f"  library (per-channel qint8 dequantize) equal to the "
                  f"plain version: {lib_same}")
        del q, s, qt
    return {"dequantize_blockwise": out}


def draft_kernel_phase(seed: int):
    """RoPE, SwiGLU and the RMS forward at the draft forward's shapes
    (serving3: a 256-token window at Llama-3.2-1B's widths, `draft_config`)
    — q [1,256,32,64] / k [1,256,8,64], [256, 8192] and [256, 2048],
    bf16 — timed as phase 3 times them, at phase 3's tolerances; the
    RMS forward beside `x + h` then `F.rms_norm`, one CUDA graph."""
    import torch.nn.functional as F
    from hetu_tpu_torch.ops.cuda import fused_norm as fn
    from hetu_tpu_torch.ops.cuda import rotary as ro
    from hetu_tpu_torch.ops.cuda import swiglu as sw
    from hetu_tpu_torch.ops.rotary import build_rope_cache
    d = draft_config()
    hd = d.hidden_size // d.num_attention_heads
    T, hidden, inter = 256, d.hidden_size, d.intermediate_size
    g = torch.Generator(device="cuda").manual_seed(seed + 3)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)
    cos, sin = build_rope_cache(d.max_position_embeddings, hd,
                                d.rope_theta, device="cuda")
    pos = torch.arange(T, device="cuda")[None]
    cos_t, sin_t = cos[pos].contiguous(), sin[pos].contiguous()
    q = randn(1, T, d.num_attention_heads, hd)
    k = randn(1, T, d.num_key_value_heads, hd)
    rotary = case(
        f"fused_rotary_qk q=[1,{T},{d.num_attention_heads},{hd}] "
        f"k=[1,{T},{d.num_key_value_heads},{hd}] bf16 (the draft)", ulps(1),
        lambda i: ro.fused_rotary_qk(q, k, cos_t, sin_t),
        lambda i: ro.rotary_qk_plain(q, k, cos_t, sin_t),
        2 * (q.numel() + k.numel()) * 2 + 2 * cos_t.numel() * 4,
        6 * (q.numel() + k.numel()) // 2,
        composition=rope_composition(q, k, cos_t, sin_t))
    n_kv = d.num_key_value_heads
    group = d.num_attention_heads // n_kv
    rotary_qkv = rope_qkv_case(
        f"fused_rotary_qk q,k views of qkv [1,{T},{n_kv},{group}+2,{hd}] "
        f"bf16 (the draft)", randn(1, T, n_kv, group + 2, hd), group, cos_t,
        sin_t)
    gu = randn(T, 2, inter)
    n = T * inter
    swiglu = case(
        f"fused_swiglu [{T},{inter}] bf16 (the draft)", ulps(1),
        lambda i: sw.fused_swiglu(gu),
        lambda i: sw.swiglu_plain(gu[:, 0], gu[:, 1]), 3 * n * 2, 5 * n,
        composition=swiglu_composition(gu))
    x, h = randn(T, hidden), randn(T, hidden)
    w = 1.0 + 0.1 * randn(hidden, dtype=torch.float32)
    wb = w.bfloat16()
    norm = case(
        f"residual_rmsnorm_fwd [{T},{hidden}] bf16, w fp32 (the draft)",
        ulps(1, 1e-6),
        lambda i: fn.residual_rmsnorm_fwd(x, h, w, d.rms_norm_eps),
        lambda i: fn.residual_rmsnorm_plain(x, h, w, d.rms_norm_eps),
        4 * T * hidden * 2 + hidden * 4, 6 * T * hidden,
        composition=lambda i: _add_then(F.rms_norm, x, h, (hidden,), wb,
                                        d.rms_norm_eps))
    return {"fused_rotary_qk": [rotary, rotary_qkv],
            "fused_swiglu": [swiglu], "residual_rmsnorm_fwd": [norm]}


def shared_prompt_trace(vocab: int, seed: int, *, n: int = 16,
                        sampled: bool = True):
    """n Poisson requests at 10/s sharing one 512-token system prompt
    (32 pages of 16), each with its own tail of 64-512 tokens and 32 new
    tokens; with `sampled` the odd ones at SamplingParams(temperature=
    0.8, top_k=50, top_p=0.95)."""
    from hetu_tpu_torch.serving import (GREEDY, Request, SamplingParams,
                                        poisson_arrivals)
    rng = np.random.default_rng(seed + 300)
    system = rng.integers(0, vocab, 512)
    arrivals = poisson_arrivals(n, 10.0, seed=seed + 3)
    reqs = []
    for i in range(n):
        tail = rng.integers(0, vocab, int(rng.integers(64, 513)))
        sp = GREEDY
        if sampled and i % 2:
            sp = SamplingParams(temperature=0.8, top_k=50, top_p=0.95,
                                seed=seed + 200 + i)
        reqs.append(Request(rid=i, prompt=np.concatenate([system, tail]),
                            max_new_tokens=32, sampling=sp,
                            arrival_t=float(arrivals[i])))
    return reqs


def _timed(fn, times):
    """fn, its wall time to a synchronize appended to `times` a call."""
    def go(*a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        return out
    return go


def serving3_phase(model, seed: int, kernels):
    """The third serving slice at full width: phase 5's Llama-3-8B as
    the target, a draft model of Llama-3.2-1B's widths (`draft_config`)
    resident in int8 (`ModelDrafter(quantize_bits=8,
    quantize_block=128)`), `ServeConfig(num_slots=8, page_size=16,
    max_len=2048, prefill_chunk=256, kv_quant="int8", sampling=True,
    spec_decode="model", spec_k=4, prefix_cache=True)`, and
    `shared_prompt_trace`.  Every launch count is exact: each draft
    forward dequantizes its 65 matrices and runs 16 layers (flash, the
    fused norm, RoPE, SwiGLU), each verify step a `paged_verify` launch
    and a page write a target layer and one draw (the bonus token), each prefix
    hit's prime 2 dequantize launches (K and V of all layers), each
    prefill one page write (the quantize launches only at the drafter's
    load, before the run).  Then one propose and one verify step are
    profiled (where serving3's time goes, and the dequantize's share),
    and the same trace runs greedy on exact pages without speculation,
    with the prefix cache and without it (TTFT; tokens identical)."""
    from hetu_tpu_torch.models.generation import verify_step_paged
    from hetu_tpu_torch.models.llama import LlamaLMHeadModel
    from hetu_tpu_torch.serving import ServeConfig, ServingEngine
    from hetu_tpu_torch.serving.spec_decode import (ModelDrafter,
                                                    stochastic_verify)
    cfg = model.config
    L = cfg.num_hidden_layers
    gc.collect()
    torch.cuda.empty_cache()
    dcfg = draft_config()
    t0 = time.perf_counter()
    draft = LlamaLMHeadModel(dcfg, device="cuda", seed=seed + 1)
    check(sum(p.numel() for p in draft.parameters()) == dcfg.num_params(),
          "draft parameter count")
    drafter = ModelDrafter(draft, quantize_bits=8, quantize_block=128)
    del draft               # the drafter holds its own int8 copy
    gc.collect()
    torch.cuda.empty_cache()
    n_mats = len(drafter._spec)
    resident = sum(v["q"].numel() + 4 * v["s"].numel()
                   for v in drafter.params_q.values() if isinstance(v, dict))
    print(f"serving3: draft {dcfg.num_params() / 1e9:.3f}B params, "
          f"{n_mats} matrices resident in int8 ({resident / 2 ** 30:.3f} "
          f"GiB with scales), built in {time.perf_counter() - t0:.1f}s")
    serve = ServeConfig(num_slots=8, page_size=16, max_len=2048,
                        prefill_chunk=256, kv_quant="int8", sampling=True,
                        spec_decode="model", spec_k=4, prefix_cache=True)
    eng = ServingEngine(model, serve, device="cuda",
                        drafter=drafter).warmup()
    propose_s = []
    drafter.propose_with_probs = _timed(drafter.propose_with_probs,
                                        propose_s)
    reqs = shared_prompt_trace(cfg.vocab_size, seed)
    torch.cuda.reset_peak_memory_stats()
    zero_counts(kernels)
    drafter.forwards = 0
    t0 = time.perf_counter()
    results = eng.run(reqs)
    wall = time.perf_counter() - t0
    launches = read_counts(kernels)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    check(len(results) == len(reqs), f"serving3: {len(results)} done")
    for r in results:
        check(r.finished_reason == "length" and len(r.tokens) == 32,
              f"serving3: request {r.rid}: {r.finished_reason}, "
              f"{len(r.tokens)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in r.tokens),
              f"serving3: request {r.rid}: token out of the vocabulary")
    eng.scheduler.check_invariants()
    pc = eng.prefix_cache.stats()
    check(eng.pool.used_count == pc["pages"],
          "serving3: pages leaked past the prefix cache's")
    reg = eng.registry
    steps = int(reg.counter_value("serve.decode_steps"))
    chunks = int(reg.counter_value("serve.prefill_chunks"))
    hits = int(reg.counter_value("serve.prefix_hits"))
    fwd = drafter.forwards
    D = dcfg.num_hidden_layers
    sampled = sum(not r.sampling.greedy for r in reqs)
    check(hits >= len(reqs) // 2, f"serving3: only {hits} prefix hits")
    expect = {name: 0 for name in kernels}
    expect.update(
        paged_verify=steps * L, sample_logits=steps + sampled,
        kv_write_tokens=L * steps, kv_write_pages=len(reqs),
        dequantize_blockwise=n_mats * fwd + 2 * hits,
        flash_fwd=D * fwd, residual_rmsnorm_fwd=D * fwd,
        fused_rotary_qk=(steps + chunks) * L + D * fwd,
        fused_swiglu=(steps + chunks) * L + D * fwd)
    check(launches == expect, f"serving3: launches {launches}, expected "
                              f"{expect}")
    ttft = sorted(r.stats.ttft_s for r in results)
    gap = reg.histogram("serve.token_latency_s")
    emitted = reg.histogram("serve.spec_emitted")
    tokens_out = sum(len(r.tokens) for r in results)
    prop = int(reg.counter_value("serve.spec_proposed"))
    acc = int(reg.counter_value("serve.spec_accepted"))
    prompt_tokens = sum(r.prompt_len for r in reqs)
    out = {
        "config": {k: getattr(serve, k) for k in (
            "num_slots", "page_size", "max_len", "prefill_chunk",
            "kv_quant", "sampling", "spec_decode", "spec_k",
            "prefix_cache")},
        "draft": {"layers": D, "hidden": dcfg.hidden_size,
                  "quantize_bits": 8, "quantize_block": 128,
                  "window": drafter.window},
        "requests": len(results), "sampled_requests": sampled,
        "prompt_tokens": prompt_tokens, "tokens_out": tokens_out,
        "decode_steps": steps, "prefill_chunks": chunks,
        "prefix_hits": hits,
        "prefix_misses": int(reg.counter_value("serve.prefix_misses")),
        "prefix_shared_tokens": int(reg.counter_value(
            "serve.prefix_shared_tokens")),
        "prefix_cache_pages": pc["pages"],
        "ttft_s_p50": ttft[len(ttft) // 2], "ttft_s_max": ttft[-1],
        "decode_step_s_p50": gap.percentile(50),
        "decode_step_s_max": gap.vmax,
        "tokens_per_s": tokens_out / wall,
        "spec_proposed": prop, "spec_accepted": acc,
        "acceptance": acc / prop,
        "tokens_per_verify_step_per_slot": emitted.total / emitted.count,
        "draft_forwards": fwd,
        "draft_ms_per_propose_p50": 1e3 * sorted(propose_s)[
            len(propose_s) // 2],
        "draft_ms_per_propose_mean": 1e3 * sum(propose_s) / len(propose_s),
        "draft_s_total": sum(propose_s),
        "run_wall_s": wall, "peak_memory_gib": peak_gb,
        "launches": launches,
    }
    print("serving3 " + json.dumps(out))
    by_path = {"serving3": launches}

    # where the time goes: one propose (4 draft forwards over the
    # 256-token window) and one verify step with its rejection rule
    k, S = serve.spec_k, serve.num_slots
    ctx = reqs[0].prompt.tolist()
    mp = eng.scheduler.max_pages
    depths = [r.prompt_len + 16 for r in reqs][:S]
    table = torch.zeros((S, mp), dtype=torch.int32, device="cuda")
    for s_, d in enumerate(depths):
        n = (d + k) // serve.page_size + 1
        table[s_, :n] = torch.arange(1 + s_ * mp, 1 + s_ * mp + n)
    pos = np.asarray(depths, np.int32)
    tok = np.zeros((S, k + 1), np.int32)
    q_probs = torch.full((S, k, cfg.vocab_size), 1.0 / cfg.vocab_size,
                         device="cuda")
    seeds, temps, top_ks, top_ps = eng._sample_args([])
    temps[1::2], top_ks[1::2], top_ps[1::2] = 0.8, 50, 0.95
    grid = pos[:, None] + np.arange(1, k + 2)

    def verify():
        logits = verify_step_paged(model, torch.as_tensor(tok).cuda(),
                                   eng.pool.k, eng.pool.v, table, pos,
                                   **eng._pools())[0]
        return stochastic_verify(logits, q_probs, tok[:, 1:], seeds, grid,
                                 temps, top_ks, top_ps)
    prof = {}
    for name, fn in (("propose_k4", lambda: drafter.propose_with_probs(
                          ctx, k, seed=1, start_pos=len(ctx))),
                     ("draft_forward", lambda: drafter._logits(ctx)),
                     ("verify_step", verify)):
        fn()
        counts = {}
        busy, wall_ms, by_name, top = _profile(fn, 3, counts=counts)
        dq = sum(t for n_, t in by_name.items() if "dequantize" in n_)
        paged = paged_ms(by_name)
        prof[name] = {"wall_ms": wall_ms, "device_busy_ms": busy,
                      "device_idle_share": 1.0 - busy / wall_ms,
                      "dequantize_ms": dq,
                      "dequantize_share_of_busy": dq / busy,
                      "paged_attention_ms": paged,
                      "paged_attention_share_of_busy": paged / busy,
                      "device_ops_per_call": round(sum(counts.values())),
                      "top_kernels_ms": top}
    # what reading q and k in place removed: two copies a draft layer
    prof["draft_forward"]["device_ops_one_call_and_with_copies"] = \
        rope_copy_drop("draft_forward", lambda: drafter._logits(ctx), D)
    print("serving3 time " + json.dumps(prof))
    del eng, drafter
    gc.collect()
    torch.cuda.empty_cache()

    # the prefix cache alone: greedy, exact pages, no speculation
    runs = {}
    for path, on in (("serving3_prefix", True),
                     ("serving3_no_prefix", False)):
        eng = ServingEngine(model, ServeConfig(
            num_slots=8, page_size=16, max_len=2048, prefill_chunk=256,
            prefix_cache=on), device="cuda").warmup()
        reqs = shared_prompt_trace(cfg.vocab_size, seed, sampled=False)
        zero_counts(kernels)
        t0 = time.perf_counter()
        res = eng.run(reqs)
        wall = time.perf_counter() - t0
        by_path[path] = read_counts(kernels)
        eng.scheduler.check_invariants()
        check(all(len(r.tokens) == 32 for r in res),
              f"{path}: a request stopped short")
        reg = eng.registry
        ttft = sorted(r.stats.ttft_s for r in res)
        runs[path] = res
        print(f"{path} " + json.dumps({
            "ttft_s_p50": ttft[len(ttft) // 2], "ttft_s_max": ttft[-1],
            "prefill_chunks": int(reg.counter_value("serve.prefill_chunks")),
            "prefix_hits": int(reg.counter_value("serve.prefix_hits")),
            "prefix_shared_tokens": int(reg.counter_value(
                "serve.prefix_shared_tokens")),
            "decode_step_s_p50": reg.histogram(
                "serve.token_latency_s").percentile(50),
            "tokens_per_s": sum(len(r.tokens) for r in res) / wall}))
        del eng
    same_tokens = [a.tokens == b.tokens for a, b in
                   zip(runs["serving3_prefix"], runs["serving3_no_prefix"])]
    check(all(same_tokens), f"prefix cache changed greedy tokens: "
                            f"{same_tokens}")
    print(f"serving3 prefix cache: greedy tokens identical with and "
          f"without it ({len(same_tokens)} requests)")
    return by_path


def reference_serving3_phase(seed: int, card, cpu):
    """The third serving slice against the CPU on the 2-layer fp32
    models, the prefix cache on exact pages, greedy, two requests
    sharing a 32-token prompt, each way of drafting on the card and on
    the CPU: (a) the engine's own `draft_model=` wiring (its defaults:
    temperature 1, window 256, block 64) with a narrow draft model of
    the target's vocabulary; (b) `drafter=ModelDrafter` over a copy of
    the target at temperature 0 with a window longer than any context,
    so greedy drafts are accepted.  The card's tokens equal the CPU
    engine's and those of the CPU run without speculation or cache."""
    from hetu_tpu_torch.models.llama import LlamaConfig, LlamaLMHeadModel
    from hetu_tpu_torch.serving import Request, ServeConfig, ServingEngine
    from hetu_tpu_torch.serving.spec_decode import ModelDrafter
    cfg = card.config
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed + 7)
    system = rng.integers(0, cfg.vocab_size, 32)

    def trace():
        r = np.random.default_rng(seed + 8)
        return [Request(rid=i, prompt=np.concatenate(
                    [system, r.integers(0, cfg.vocab_size, 20 + 7 * i)]),
                    max_new_tokens=6, arrival_t=30.0 * i) for i in range(2)]
    serve = dict(num_slots=2, page_size=16, max_len=256, prefill_chunk=64)
    narrow = LlamaConfig(vocab_size=cfg.vocab_size, hidden_size=512,
                         intermediate_size=1024, num_hidden_layers=2,
                         num_attention_heads=8, num_key_value_heads=2,
                         max_position_embeddings=cfg.max_position_embeddings,
                         rope_theta=cfg.rope_theta, tie_word_embeddings=True,
                         compute_dtype=torch.float32)
    drafts = {}
    for name, dcfg, src in (("narrow", narrow, None), ("copy", cfg, card)):
        on_card = LlamaLMHeadModel(dcfg, device="cuda", seed=seed + 5)
        if src is not None:
            on_card.load_state_dict(src.state_dict())
        on_cpu = LlamaLMHeadModel(dcfg, device="cpu", seed=seed + 5)
        on_cpu.load_state_dict({k: v.cpu() for k, v in
                                on_card.state_dict().items()})
        drafts[name] = {"card": on_card, "cpu": on_cpu}
    base = ServingEngine(cpu, ServeConfig(**serve), device="cpu").run(trace())
    for way in ("draft_model", "drafter"):
        runs = {}
        for name, model in (("card", card), ("cpu", cpu)):
            cfg_s = ServeConfig(**serve, prefix_cache=True,
                                spec_decode="model", spec_k=4)
            if way == "draft_model":
                eng = ServingEngine(model, cfg_s, device=model.device,
                                    draft_model=drafts["narrow"][name])
            else:
                eng = ServingEngine(model, cfg_s, device=model.device,
                                    drafter=ModelDrafter(
                                        drafts["copy"][name],
                                        temperature=0.0, window=128))
            res = eng.warmup().run(trace())
            eng.scheduler.check_invariants()
            runs[name] = res
            check(eng.registry.counter_value("serve.prefix_hits") == 1,
                  f"reference serving3 {way} ({name}): prefix hits "
                  f"{eng.registry.counter_value('serve.prefix_hits')} != 1")
            check(eng.drafter.forwards > 0,
                  f"reference serving3 {way} ({name}): no draft forward")
        tokens = [r.tokens for r in runs["card"]]
        check(tokens == [r.tokens for r in runs["cpu"]],
              f"reference serving3 {way}: card vs CPU tokens differ")
        check(tokens == [r.tokens for r in base],
              f"reference serving3 {way}: tokens differ from the run "
              f"without speculation")
        acc = sum(r.stats.spec_accepted for r in runs["card"])
        prop = sum(r.stats.spec_proposed for r in runs["card"])
        if way == "drafter":
            check(acc > 0, "reference serving3: the card accepted no "
                  "draft of the target's copy")
        print(f"reference serving3 ({way}=): model drafter + prefix cache, "
              f"card vs CPU greedy tokens identical {tokens}, equal to the "
              f"run without speculation; accepted {acc} of {prop} drafts "
              f"({time.perf_counter() - t0:.1f}s)")


#: the kernel `torch.cuda._sleep` launches: a marker that opens a
#: profile's window ahead of a counted call (`device_ops`)
MARKER = "spin_kernel"


def _profile(fn, steps: int, top: int = 5, counts=None, lead: int = 0):
    """Summed device time (ms) per call of the kernels torch.profiler
    sees while `fn` runs `steps` times, the host wall per call around a
    synchronize, and the `top` heaviest kernels by name; `counts`, a
    dict, gets the device operations (kernels, copies, memsets) per call
    by name.  `lead` marker launches, synchronized, open the window
    before the first call; their records stay out of the sums, and
    `counts[MARKER]` gets how many of them the profiler kept."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(lead):
            torch.cuda._sleep(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and MARKER in e.name:
            if counts is not None:
                counts[MARKER] = counts.get(MARKER, 0) + 1
        elif e.device_type == DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3 / steps)
            if counts is not None:
                counts[e.name] = counts.get(e.name, 0) + 1 / steps
    heavy = sorted(by_name.items(), key=lambda kv: -kv[1])
    return sum(by_name.values()), wall_ms, by_name, \
        [(n[:60], t) for n, t in heavy[:top]]


#: device operations a step by name, per profiled serving step
STEP_OPS = {}


def paged_ms(by_name):
    """The paged kernels' device time (split kernel and merge) in a
    profile's per-kernel sums."""
    return sum(t for n, t in by_name.items() if "paged_" in n)


def serving_time_phase(eng, reqs):
    """One decode step and one prefill chunk at the serving shapes —
    for a speculative engine one verify step with its sampling epilogue
    instead, for a sampling engine one decode step with its draw: host
    enqueue, wall, device busy time, the card's idle share, the device
    operations a step and the heaviest kernels."""
    from hetu_tpu_torch.models.generation import (decode_step_paged,
                                                  extend_cache,
                                                  verify_step_paged)
    from hetu_tpu_torch.serving.sampling import (sample_hidden_grid,
                                                 sample_tokens)
    model, S = eng.model, eng.config.num_slots
    mp = eng.scheduler.max_pages
    C = eng.config.spec_k + 1 if eng.spec else 1
    depths = [r.prompt_len + 16 for r in reqs][:S]
    table = torch.zeros((S, mp), dtype=torch.int32, device="cuda")
    for s, d in enumerate(depths):
        n = (d + C - 1) // eng.config.page_size + 1
        table[s, :n] = torch.arange(1 + s * mp, 1 + s * mp + n)
    # positions on the host, as the engine hands them over
    pos = np.asarray(depths, np.int32)
    # the sampled runs' rows: the odd ones at the trace's parameters
    seeds, temps, top_ks, top_ps = eng._sample_args([])
    temps[1::2], top_ks[1::2], top_ps[1::2] = 0.8, 50, 0.95
    if eng.spec:
        tok = torch.zeros((S, C), dtype=torch.int32, device="cuda")
        grid = np.asarray(depths)[:, None] + np.arange(1, C + 1)

        def verify():
            hidden = verify_step_paged(model, tok, eng.pool.k, eng.pool.v,
                                       table, pos, return_hidden=True,
                                       **eng._pools())[0]
            return sample_hidden_grid(hidden, model.lm_head_weight(), seeds,
                                      grid, temps, top_ks, top_ps)
        calls = {"verify_step": verify}
    elif eng.config.sampling:
        tok = torch.zeros(S, dtype=torch.int32, device="cuda")
        nxt = np.asarray(depths) + 1

        def forward():
            return decode_step_paged(model, tok, eng.pool.k, eng.pool.v,
                                     table, pos, **eng._pools())[0]
        # the step, and its forward alone: against the greedy engine's
        # decode step (exact pages) they part the step's host and device
        # cost into the page mode's and the draw's
        calls = {"decode_step_sampled": lambda: sample_tokens(
                     forward(), seeds, nxt, temps, top_ks, top_ps),
                 "decode_forward": forward}
    else:
        tok = torch.zeros(S, dtype=torch.int32, device="cuda")
        scratch = eng._new_scratch()
        ids = torch.zeros((1, eng.config.prefill_chunk), dtype=torch.long,
                          device="cuda")
        calls = {
            "decode_step": lambda: decode_step_paged(model, tok, eng.pool.k,
                                                     eng.pool.v, table, pos),
            "prefill_chunk": lambda: extend_cache(model, ids, scratch, 256),
        }
    out = {}
    for name, fn in calls.items():
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        reps = 5
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        enqueue = (time.perf_counter() - t0) / reps
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / reps
        counts = STEP_OPS[name] = {}
        busy, _, by_name, top = _profile(fn, 3, counts=counts)
        paged = paged_ms(by_name)
        out[name] = {"host_enqueue_ms": enqueue * 1e3, "wall_ms": wall * 1e3,
                     "device_busy_ms": busy,
                     "device_idle_share": 1.0 - busy / (wall * 1e3),
                     "paged_attention_ms": paged,
                     "paged_attention_share_of_busy": paged / busy,
                     "device_ops_per_step": round(sum(counts.values())),
                     "top_kernels_ms": top,
                     "most_launched": sorted(
                         ((n[:60], round(c)) for n, c in counts.items()),
                         key=lambda nc: -nc[1])[:8]}
        greedy = STEP_OPS.get("decode_step")
        if greedy is not None and name != "decode_step":
            # what this step runs on the card beyond a greedy decode step
            more = {n: round(c - greedy.get(n, 0)) for n, c in counts.items()}
            out[name]["ops_beyond_greedy_decode"] = sorted(
                ((n[:60], c) for n, c in more.items() if c > 0),
                key=lambda nc: -nc[1])
    L = model.config.num_hidden_layers
    if "decode_step" in calls:
        # what reading q and k in place removed: two copies a layer
        for name in ("decode_step", "prefill_chunk"):
            out[name]["device_ops_one_call_and_with_copies"] = \
                rope_copy_drop(name, calls[name], L)
    # what the fused page write removed: the exact decode step, the int8
    # decode forward, the int8 verify step
    for name in ("decode_step", "decode_forward", "verify_step"):
        if name in calls:
            out[name]["device_ops_now_and_parent_page_write"] = \
                page_write_drop(name, calls[name], L)
    tag = eng.config.kv_quant + (", spec" if eng.spec else "")
    print(f"serving time ({tag}) " + json.dumps(out))


# ----------------------------------------------------------- training
def _train_batch(vocab: int, batch: int, seq: int, seed: int):
    ids = np.random.default_rng(seed).integers(0, vocab, (batch, seq))
    ids = ids.astype(np.int32)
    return {"input_ids": ids, "labels": ids}


def training_reference_phase(seed: int):
    """A narrow Llama with flash attention, 3 Trainer steps on the card
    (the flash kernels' fp32 arm) and on the CPU (flash's plain version,
    forced: the CPU's own route is the dense attention)."""
    from hetu_tpu_torch.models.llama import LlamaConfig, LlamaLMHeadModel

    cfg = LlamaConfig.tiny(hidden_size=512, num_attention_heads=4,
                           num_key_value_heads=2, intermediate_size=1536,
                           vocab_size=4096, num_hidden_layers=2,
                           compute_dtype=torch.float32,
                           use_flash_attention=True,
                           remat_policy="dots_attn")
    t0 = time.perf_counter()
    cpu = LlamaLMHeadModel(cfg, device="cpu", seed=seed)
    card = LlamaLMHeadModel(cfg, device="cuda", seed=seed)
    card.load_state_dict(cpu.state_dict())
    for layer in cpu.model.layers:
        layer.attn.use_pallas = True
    _card_vs_cpu_training(seed, card, cpu, "hidden 512, 2 layers, fp32, "
                          "flash + dots_attn", t0)


def _card_vs_cpu_training(seed, card, cpu, label, t0):
    """3 Trainer steps of `card` and `cpu` (one set of weights) on the
    same seeded batches of 4 x 64 tokens, two micro-batches: losses and
    grad norms within 1e-5 relative; parameters within 2 x the summed
    lr everywhere and within 1e-5 on all but 0.1% of elements (AdamW
    divides by sqrt(v), so a gradient within rounding of zero moves its
    element by up to lr in one run and not the other)."""
    from hetu_tpu_torch.engine import Trainer, TrainingConfig
    tc = TrainingConfig(global_batch_size=4, micro_batch_size=2, seq_len=64,
                        warmup_steps=1, total_steps=10, log_every=100)
    batch = _train_batch(card.config.vocab_size, 4, 64, seed)
    batch["labels"][1, :5] = -100
    runs = []
    for model, dev in ((card, "cuda"), (cpu, "cpu")):
        tr = Trainer(model, tc, device=dev)
        metrics = [tr.train_step(batch) for _ in range(3)]
        runs.append(([{k: float(v) for k, v in m.items()} for m in metrics],
                     [p.detach().cpu() for p in model.parameters()]))
    (on_card, card_p), (on_cpu, cpu_p) = runs
    worst = {k: max(abs(g[k] - c[k]) / abs(c[k])
                    for g, c in zip(on_card, on_cpu))
             for k in ("loss", "grad_norm", "lr")}
    bound_p = 2 * sum(m["lr"] for m in on_cpu)
    d = torch.cat([(a - b).abs().flatten() for a, b in zip(card_p, cpu_p)])
    p_err, p_frac = d.max().item(), (d > 1e-5).float().mean().item()
    check(all(math.isfinite(m["loss"]) for m in on_card), "non-finite loss")
    check(all(v <= 1e-5 for v in worst.values()),
          f"card vs CPU training metrics differ: {worst}")
    check(p_err <= bound_p and p_frac <= 1e-3,
          f"card vs CPU parameters differ: max {p_err} (bound {bound_p}), "
          f"{p_frac} of elements past 1e-5")
    print(f"training reference: {label}, 3 steps: card "
          f"vs CPU loss/grad_norm/lr worst relative diff {worst} (tol "
          f"1e-5); parameters max abs diff {p_err:.3g} (bound "
          f"{bound_p:.3g}), {p_frac:.3g} of elements past 1e-5 (tol "
          f"1e-3); losses {[m['loss'] for m in on_card]} "
          f"({time.perf_counter() - t0:.1f}s)")


def training_phase(seed: int, kernels, card: str, cfg, *, name: str,
                   gbs: int, mbs: int, seq: int, steps: int, time_it: bool):
    """`cfg`'s model (a LlamaConfig or a GPTConfig; `name` for the
    printout) through the Trainer on the card, `gbs` x `seq` tokens a
    step in micro-batches of `mbs`; the launch counts of every step are
    checked.  Returns the run's launches."""
    from hetu_tpu_torch.engine import Trainer, TrainingConfig
    from hetu_tpu_torch.models.gpt import GPTConfig, GPTLMHeadModel
    from hetu_tpu_torch.models.llama import LlamaLMHeadModel
    from hetu_tpu_torch.ops.cuda import adam as ad

    gpt = isinstance(cfg, GPTConfig)
    model_cls = GPTLMHeadModel if gpt else LlamaLMHeadModel
    use_flash, policy = cfg.use_flash_attention, cfg.remat_policy
    attn = "flash attention" if use_flash else "the dense attention"
    L = cfg.num_hidden_layers
    batch = _train_batch(cfg.vocab_size, gbs, seq, seed)
    sigma = cfg.initializer_range * math.sqrt(cfg.hidden_size)
    expect_first = math.log(cfg.vocab_size) + sigma ** 2 / 2
    for mbs in (mbs, mbs // 2):
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        model = model_cls(cfg, device="cuda", seed=seed)
        tr = Trainer(model, TrainingConfig(
            global_batch_size=gbs, micro_batch_size=mbs, seq_len=seq,
            lr=1e-3, warmup_steps=2, total_steps=1000, log_every=1),
            device="cuda").build()
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in tr.params)
        print(f"training: {name}, {L} layers, {n_params / 1e9:.3f}B"
              f" params fp32 + fp32 grads and AdamW moments, bf16 compute, "
              f"{attn}, remat policy {policy!r}, micro-batch {mbs} x {seq}; "
              f"built in "
              f"{time.perf_counter() - t0:.1f}s")
        n_micro = gbs // mbs
        # every policy recomputes the norm (and RoPE, SwiGLU) forwards
        fwd, bwd = 2 * L * n_micro, L * n_micro
        per_step = {name: 0 for name in kernels}
        if gpt:
            per_step.update(residual_layernorm_fwd=fwd,
                            residual_layernorm_bwd=bwd)
        else:
            per_step.update(fused_rotary_qk=fwd, fused_swiglu=fwd,
                            residual_rmsnorm_fwd=fwd,
                            residual_rmsnorm_bwd=bwd, swiglu_bwd=bwd,
                            rotary_qk_bwd=bwd)
        # one launch over every leaf (a table holds MAX_LEAVES)
        per_step["adam_update"] = -(-len(tr.params) // ad.MAX_LEAVES)
        if use_flash:   # "dots_attn" keeps o and lse: no second forward
            per_step.update(
                flash_fwd=bwd if policy == "dots_attn" else fwd,
                flash_bwd_dq=bwd, flash_bwd_dkv=bwd)
        torch.cuda.reset_peak_memory_stats()
        zero_counts(kernels)
        losses, step_s, launches = [], [], {name: 0 for name in kernels}
        cut = False
        for i in range(steps):
            t0 = time.perf_counter()
            # log_every=1: train() reads the loss, a wait for the card
            metrics = tr.train([batch], num_steps=1)
            step_s.append(time.perf_counter() - t0)
            losses.append(float(metrics["loss"]))
            counts = read_counts(kernels)
            check(counts == per_step, f"step {i + 1} launches {counts}, "
                                      f"expected {per_step}")
            check_adam_arm(f"step {i + 1}", per_step["adam_update"], "f32")
            for name_, n in counts.items():
                launches[name_] += n
            zero_counts(kernels)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            if i == 0 and peak > TRAIN_PEAK_GIB and mbs > 1:
                print(f"training: CUT micro-batch {mbs} -> {mbs // 2}: peak "
                      f"{peak:.1f} GiB > {TRAIN_PEAK_GIB} GiB")
                cut = True
                break
        if not cut:
            break
        del tr, model
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    check(abs(losses[0] - expect_first) <= 0.5,
          f"first loss {losses[0]} is not within 0.5 of {expect_first}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    tokens = gbs * seq
    p50 = float(np.median(step_s))
    flops = cfg.flops_per_token(seq) * tokens
    reg = tr.registry
    out = {
        "model": name, "layers": L,
        "attention": "flash" if use_flash else "dense",
        "remat_policy": policy, "micro_batch": mbs, "micro_batches": n_micro,
        "seq_len": seq, "tokens_per_step": tokens, "losses": losses,
        "expected_first_loss": expect_first,
        "step_s": step_s, "step_s_p50": p50, "tokens_per_s": tokens / p50,
        "mfu": flops / p50 / PEAK_OPS_PER_S[torch.bfloat16],
        "model_tflop_per_step": flops / 1e12,
        "peak_memory_gib": peak,
        "trainer.steps": reg.counter_value("trainer.steps"),
        "trainer.step_time_s_p50": reg.histogram(
            "trainer.step_time_s").percentile(50),
        "launches_per_step": per_step, "launches": launches, "card": card,
    }
    print("training " + json.dumps(out))
    if name.startswith("Llama") and policy == "dots_attn":
        print(f"training: remat policy 'dots_attn' keeps the reference's "
              f"set: peak {peak:.2f} GiB; with the projections' inputs "
              f"kept too (PERF.md) 60.84 GiB; {card}")
    if time_it:
        training_time_phase(tr, batch, p50 * 1e3, card)
    return launches


def training_time_phase(tr, batch, step_ms: float, card: str):
    """Where a flash training step's time goes: one step under
    torch.profiler (device busy, heaviest kernels, each ported kernel's
    summed time — the attention's share is its three kernels'; the idle
    share against `step_ms`, the unprofiled step's synchronised p50);
    then flash attention (forward, forward + backward), the dense
    attention it replaced and the LM head + loss timed apart at the
    step's shapes."""
    from hetu_tpu_torch.ops.attention import attention, flash_attention
    from hetu_tpu_torch.ops.losses import softmax_cross_entropy_sparse

    busy, wall, by_name, top = _profile(lambda: tr.train_step(batch), 1,
                                        top=10)
    ours = {key: sum(t for n, t in by_name.items() if key in n)
            for key in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                        "rmsnorm_fwd", "rmsnorm_bwd", "layernorm_fwd",
                        "layernorm_bwd", "swiglu_fwd", "swiglu_bwd",
                        "rotary_qk", "adam_multi_kernel")}
    # the bf16 dq launches are the Hopper kernel's
    dq_names = {n for n in by_name if "flash_bwd_dq" in n}
    check(bool(dq_names) and all("flash_bwd_dq_wgmma_kernel" in n
                                 for n in dq_names),
          f"the step's dq kernels are {dq_names}")
    cfg, c = tr.model.config, tr.config
    n_micro, L = tr.n_micro, cfg.num_hidden_layers
    mbs, seq = c.micro_batch_size, c.seq_len
    # apart: free the trainer's step memory first
    tr.model.zero_grad(set_to_none=True)
    g = torch.Generator(device="cuda").manual_seed(7)

    def leaf(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device="cuda").to(
            dtype).requires_grad_(True)
    n_kv = getattr(cfg, "num_key_value_heads", cfg.num_attention_heads)
    q = leaf(mbs, seq, cfg.num_attention_heads, cfg.head_dim)
    k, v = (leaf(mbs, seq, n_kv, cfg.head_dim) for _ in range(2))
    do = torch.randn_like(q)
    apart = {}
    for name, fn in (("flash", flash_attention), ("dense", attention)):
        def fwd():
            with torch.no_grad():
                fn(q, k, v, causal=True)

        def fwd_bwd():
            fn(q, k, v, causal=True).backward(do)
        apart[f"{name}_attention_fwd_ms"] = event_ms(fwd)
        apart[f"{name}_attention_fwd_bwd_ms"] = event_ms(fwd_bwd)
    del q, k, v, do
    hidden = leaf(mbs, seq, cfg.hidden_size)
    labels = torch.randint(0, cfg.vocab_size, (mbs, seq), device="cuda")
    head = tr.model.lm_head_weight()

    def head_loss():
        lg = hidden @ head.to(hidden.dtype)
        softmax_cross_entropy_sparse(lg[:, :-1], labels[:, 1:],
                                     reduction="sum").backward()
    h_fb = event_ms(head_loss)
    tr.model.zero_grad(set_to_none=True)
    del hidden
    attention_ms = sum(ours[key] for key in ("flash_fwd", "flash_bwd_dq",
                                             "flash_bwd_dkv"))
    head_ms = n_micro * h_fb
    out = {"step_ms_p50": step_ms, "profiled_wall_ms": wall,
           "device_busy_ms": busy, "device_idle_share": 1.0 - busy / step_ms,
           "top_kernels_ms": top, "ported_kernels_ms": ours, **apart,
           "flash_attention_ms_per_step": attention_ms,
           # what the dense attention would take in this step's place:
           # a forward and a forward + backward a layer and micro-batch
           "dense_attention_ms_per_step": L * n_micro * (
               apart["dense_attention_fwd_ms"]
               + apart["dense_attention_fwd_bwd_ms"]),
           "lm_head_loss_fwd_bwd_ms": h_fb, "lm_head_loss_ms_per_step": head_ms,
           "adamw_ms_per_step": ours["adam_multi_kernel"],
           "other_device_ms": busy - head_ms - sum(ours.values()),
           "card": card}
    print("training time " + json.dumps(out))


# ---------------------------------------------------------------- GPT
def gpt_reference_phase(seed: int):
    """GPT-2-large widths cut to 2 layers, fp32, one set of weights on
    the card and on the CPU: the engine (greedy, exact pages) emits
    identical tokens on both; then 3 Trainer steps (flash's fp32 arm at
    head dim 64 and the LayerNorm arm on the card; the plain versions,
    flash's forced, on the CPU) to phase 7's tolerances."""
    from hetu_tpu_torch.models.gpt import GPTConfig, GPTLMHeadModel
    from hetu_tpu_torch.serving import (ServeConfig, ServingEngine,
                                        synthetic_requests)

    cfg = GPTConfig.gpt2_large(num_hidden_layers=2,
                               compute_dtype=torch.float32)
    t0 = time.perf_counter()
    cpu = GPTLMHeadModel(cfg, device="cpu", seed=seed)
    card = GPTLMHeadModel(cfg, device="cuda", seed=seed)
    card.load_state_dict(cpu.state_dict())
    serve = ServeConfig(num_slots=2, page_size=16, max_len=256,
                        prefill_chunk=64)
    tokens = []
    for model, dev in ((card, "cuda"), (cpu, "cpu")):
        reqs = synthetic_requests(
            2, vocab_size=cfg.vocab_size, prompt_lens=(70, 120),
            max_new=(4, 4), arrivals=100.0 * np.arange(2), seed=seed)
        eng = ServingEngine(model, serve, device=dev).warmup()
        tokens.append([r.tokens for r in eng.run(reqs)])
    check(tokens[0] == tokens[1], f"GPT card vs CPU tokens differ: {tokens}")
    print(f"reference: GPT-2-large widths, 2 layers, fp32: card vs CPU "
          f"greedy tokens identical {tokens[0]} "
          f"({time.perf_counter() - t0:.1f}s)")
    for block in cpu.model.blocks:
        block.attn.use_pallas = True
    _card_vs_cpu_training(seed, card, cpu, "GPT-2-large widths, 2 layers, "
                          "fp32, flash + nothing", time.perf_counter())


def gpt_serving_phase(seed: int, kernels):
    """GPT-2-large at full width and depth, bf16 weights drawn on the
    card, behind ServeConfig(num_slots=8, page_size=16, max_len=1024,
    prefill_chunk=256): 8 Poisson requests at 10/s, prompts of 64-768
    tokens, 32 new tokens each; greedy on exact pages, then the odd
    requests at SamplingParams(temperature=0.8, top_k=50, top_p=0.95) on
    int8 pages, without speculation and with n-gram speculation (whose
    verify step samples through `fused_sample` over the tied head at
    V = 50257).  Every launch count exact; TTFT, gap, tokens/s and peak
    memory printed.  Returns {path: launches}."""
    from hetu_tpu_torch.models.gpt import GPTConfig, GPTLMHeadModel
    from hetu_tpu_torch.serving import (SamplingParams, ServeConfig,
                                        ServingEngine, poisson_arrivals,
                                        synthetic_requests)

    cfg = GPTConfig.gpt2_large(param_dtype=torch.bfloat16)
    L = cfg.num_hidden_layers
    t0 = time.perf_counter()
    model = GPTLMHeadModel(cfg, device="cuda", seed=seed)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == cfg.num_params(), "GPT parameter count")
    print(f"gpt serving: GPT-2-large {L} layers, {n_params / 1e6:.1f}M "
          f"params bf16, drawn on the card in "
          f"{time.perf_counter() - t0:.1f}s")

    def trace(sampled):
        reqs = synthetic_requests(
            8, vocab_size=cfg.vocab_size, prompt_lens=(64, 768),
            max_new=(32, 32), arrivals=poisson_arrivals(8, 10.0, seed=seed),
            seed=seed)
        if sampled:
            for r in reqs[1::2]:
                r.sampling = SamplingParams(temperature=0.8, top_k=50,
                                            top_p=0.95,
                                            seed=seed + 100 + r.rid)
        return reqs

    by_path = {}
    for path, opts in (
            ("gpt_serving", {}),
            ("gpt_serving_int8", dict(kv_quant="int8", sampling=True)),
            ("gpt_serving_spec_int8", dict(kv_quant="int8", sampling=True,
                                           spec_decode="ngram", spec_k=4))):
        gc.collect()
        torch.cuda.empty_cache()
        serve = ServeConfig(num_slots=8, page_size=16, max_len=1024,
                            prefill_chunk=256, **opts)
        eng = ServingEngine(model, serve, device="cuda").warmup()
        reqs = trace(serve.sampling)
        if path == "gpt_serving":
            check(sum(r.prompt_len > serve.prefill_chunk for r in reqs) >= 2,
                  "the GPT trace has too few multi-chunk prompts")
        torch.cuda.reset_peak_memory_stats()
        zero_counts(kernels)
        t0 = time.perf_counter()
        results = eng.run(reqs)
        wall = time.perf_counter() - t0
        launches = read_counts(kernels)
        # the tied head wte.t(): the tensor cores' K-major arm, no FMAs
        check_product_arm(path, launches, "k_major")
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        check(len(results) == len(reqs), f"{path}: {len(results)} done")
        for r in results:
            check(r.finished_reason == "length" and len(r.tokens) == 32,
                  f"{path}: request {r.rid}: {r.finished_reason}, "
                  f"{len(r.tokens)} tokens")
            check(all(0 <= t < cfg.vocab_size for t in r.tokens),
                  f"{path}: request {r.rid}: token out of the vocabulary")
        eng.scheduler.check_invariants()
        check(eng.pool.free_count == eng.pool.num_pages,
              f"{path}: pages leaked")
        reg = eng.registry
        steps = int(reg.counter_value("serve.decode_steps"))
        chunks = int(reg.counter_value("serve.prefill_chunks"))
        sampled = sum(not r.sampling.greedy for r in reqs)
        # GPT applies no RoPE, its MLP is GELU and its serving forwards
        # apply ln2 unfused: the page kernels and the sampler only
        expect = {name: 0 for name in kernels}
        expect.update(kv_write_tokens=L * steps, kv_write_pages=len(reqs))
        if not serve.sampling:
            expect.update(paged_attention=steps * L)
        else:
            if eng.spec:
                expect.update(paged_verify=steps * L, fused_sample=steps,
                              sample_logits=sampled)
            else:
                expect.update(paged_attention_int8=steps * L,
                              sample_logits=steps + sampled)
        check(launches == expect, f"{path}: launches {launches}, "
                                  f"expected {expect}")
        ttft = sorted(r.stats.ttft_s for r in results)
        gap = reg.histogram("serve.token_latency_s")
        tokens_out = sum(len(r.tokens) for r in results)
        out = {
            "config": {k: getattr(serve, k) for k in (
                "num_slots", "page_size", "max_len", "prefill_chunk",
                "kv_quant", "sampling", "spec_decode", "spec_k")},
            "requests": len(results), "sampled_requests": sampled,
            "prompt_tokens": sum(r.prompt_len for r in reqs),
            "tokens_out": tokens_out, "decode_steps": steps,
            "prefill_chunks": chunks,
            "ttft_s_p50": ttft[len(ttft) // 2], "ttft_s_max": ttft[-1],
            "decode_step_s_p50": gap.percentile(50),
            "decode_step_s_max": gap.vmax,
            "tokens_per_s": tokens_out / wall, "run_wall_s": wall,
            "peak_memory_gib": peak_gb, "launches": launches,
        }
        if eng.spec:
            prop = int(reg.counter_value("serve.spec_proposed"))
            out.update(spec_proposed=prop, spec_accepted=int(
                reg.counter_value("serve.spec_accepted")))
        print(f"{path} " + json.dumps(out))
        by_path[path] = launches
        del eng
    prefill_chunk_times(model, seed)
    del model
    return by_path


def prefill_chunk_times(model, seed: int, C: int = 256, start: int = 512,
                        reps: int = 7):
    """One prefill chunk through `extend_cache` at the engine's shape (one
    request, a max_len 1,024 scratch cache, C tokens at `start`): the
    int start (one slice write a layer, a [C, M] mask: the engine's
    form) against a [1] start of the same value (the per-row scatter, a
    [b, C, M] mask), wall time to a synchronize, p50 of `reps` calls
    taken in turn after a warm call each; logits and caches identical."""
    from hetu_tpu_torch.models.generation import extend_cache

    c = model.config
    shape = (c.num_hidden_layers, 1, 1024, c.num_attention_heads, c.head_dim)
    g = torch.Generator(device="cuda").manual_seed(seed + 9)
    ids = torch.randint(0, c.vocab_size, (1, C), generator=g, device="cuda")
    starts = {"int": start, "per_row": np.array([start])}
    caches = {name: tuple(torch.zeros(shape, dtype=c.compute_dtype,
                                      device="cuda") for _ in range(2))
              for name in starts}
    walls = {name: [] for name in starts}
    out = {}
    for _ in range(reps + 1):
        for name, s in starts.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _ = extend_cache(model, ids, caches[name], s)
            torch.cuda.synchronize()
            walls[name].append(time.perf_counter() - t0)
            out[name] = (logits, caches[name])
    times = {name: sorted(w[1:])[reps // 2] * 1e3
             for name, w in walls.items()}
    check(torch.equal(out["int"][0], out["per_row"][0])
          and all(torch.equal(a, b) for a, b in zip(out["int"][1],
                                                    out["per_row"][1])),
          "extend_cache: an int start and a [1] start disagree")
    print(f"gpt prefill chunk C={C} at {start}: int start "
          f"{times['int']:.3f} ms, [1] start {times['per_row']:.3f} ms "
          f"(wall p50 of {reps})")


# ------------------------------------------------------------ training3
def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each element of x (at zero, the smallest
    normal's)."""
    e = torch.floor(torch.log2(x.abs().float().clamp(min=2.0 ** -126)))
    return torch.exp2(e - 7)


def _adam_direction(m, v, step: int, opt) -> torch.Tensor:
    """AdamW's direction m^ / (sqrt(v^) + eps) from the moments after
    `step`."""
    c1, c2 = 1.0 - opt.b1 ** step, 1.0 - opt.b2 ** step
    return (m / c1) / (torch.sqrt(v / c2) + opt.eps)


def _t3_masks_equal(keys_shapes):
    """The counter-based dropout masks of `keys_shapes` [(key, shape)]
    drawn on the card and on the CPU: equal element for element."""
    from hetu_tpu_torch.ops import activations as act
    for key, shape in keys_shapes:
        n = int(np.prod(shape))
        check(torch.equal(act.dropout_bits(n, key, "cuda").cpu(),
                          act.dropout_bits(n, key, "cpu")),
              f"dropout bits of {key} {shape} differ on the card")
    return len(keys_shapes)


def training3_reference_phase(seed: int, card: str):
    """Phase 14 (a): GPT-2-large widths cut to 2 layers, bf16 parameters,
    fp32 compute, the dynamic loss scale, dropout 0.1 / 0.1 keyed by the
    step: 3 Trainer steps on the card and on the CPU, taken in turn, to
    phase 7's tolerances, each parameter within one bf16 ulp a step plus
    lr x the gap between the two sides' AdamW directions, the masks of
    every (step, micro-batch, layer, site) equal on both; then a step at
    the largest fp32 scale on a batch of one token (its row of the tied
    head overflows): AdamW writes nothing, the step count stays, the
    scale halves."""
    from hetu_tpu_torch.engine import Trainer, TrainingConfig
    from hetu_tpu_torch.models.gpt import GPTConfig, GPTLMHeadModel
    from hetu_tpu_torch.ops.activations import DropoutKey

    cfg = GPTConfig.gpt2_large(num_hidden_layers=2,
                               compute_dtype=torch.float32,
                               param_dtype=torch.bfloat16,
                               attention_dropout=0.1, hidden_dropout=0.1)
    t0 = time.perf_counter()
    cpu = GPTLMHeadModel(cfg, device="cpu", seed=seed)
    gpu = GPTLMHeadModel(cfg, device="cuda", seed=seed)
    gpu.load_state_dict(cpu.state_dict())
    tc = TrainingConfig(global_batch_size=4, micro_batch_size=2, seq_len=64,
                        warmup_steps=1, total_steps=10, log_every=100,
                        seed=seed + 3, dropout_deterministic=False,
                        loss_scale="dynamic")
    batch = _train_batch(cfg.vocab_size, 4, 64, seed)
    batch["labels"][1, :5] = -100
    trainers = [Trainer(gpu, tc, device="cuda"),
                Trainer(cpu, tc, device="cpu")]
    on_card, on_cpu = [], []
    opt = trainers[1].optimizer
    # in the trainers' order (`Trainer.params` is `model.parameters()`)
    bound = [torch.zeros(p.shape, device="cuda") for p in gpu.parameters()]
    for step in range(1, 4):
        for tr, out in zip(trainers, (on_card, on_cpu)):
            out.append({k: float(v) for k, v in tr.train_step(batch).items()})
        # each parameter within one bf16 ulp a step (at the larger value
        # of the two after the step) plus lr x what the two AdamW
        # directions differ by (computed on the card)
        card_t, cpu_t = trainers
        for i, (pg, pc, mg, vg, mc, vc) in enumerate(zip(
                card_t.params, cpu_t.params, card_t.opt_state["m"],
                card_t.opt_state["v"], cpu_t.opt_state["m"],
                cpu_t.opt_state["v"])):
            gap = (_adam_direction(mg, vg, step, opt) - _adam_direction(
                mc.to("cuda"), vc.to("cuda"), step, opt)).abs()
            bound[i] += opt._lr(step) * gap + _bf16_ulp(torch.maximum(
                pg.detach().float().abs(),
                pc.detach().to("cuda").float().abs()))
    bound = [b.cpu() for b in bound]
    card_p = [p.detach().cpu() for p in trainers[0].params]
    cpu_p = [p.detach() for p in trainers[1].params]
    masks = _t3_masks_equal([
        (DropoutKey((tc.seed + 1, step, micro, layer, site)), shape)
        for step in range(3) for micro in range(2) for layer in range(2)
        for site, shape in ((1, (2, 20, 64, 64)), (2, (2, 64, 1280)),
                            (3, (2, 64, 1280)))])
    worst = {k: max(abs(g[k] - c[k]) / abs(c[k])
                    for g, c in zip(on_card, on_cpu))
             for k in ("loss", "grad_norm", "lr", "loss_scale")}
    d = [(a.float() - b.float()).abs() for a, b in zip(card_p, cpu_p)]
    over_bound = max((x / b).max().item() for x, b in zip(d, bound))
    d = torch.cat([x.flatten() for x in d])
    p_err, p_frac = d.max().item(), (d > 1e-5).float().mean().item()
    check(all(m["amp_skipped"] == 0.0 for m in on_card + on_cpu),
          "a finite step was skipped")
    check(all(v <= 1e-5 for v in worst.values()),
          f"card vs CPU training3 metrics differ: {worst}")
    check(over_bound <= 1.0 and p_frac <= 1e-3,
          f"card vs CPU bf16 parameters differ: max {p_err}, "
          f"{over_bound} of the per-element bound, {p_frac} of elements "
          f"past 1e-5")
    # the forced overflow, on the card
    tr = trainers[0]
    big = float(np.finfo(np.float32).max)
    tr.scaler_state["scale"].fill_(big)
    before = tr.state()
    saved = [t.clone() for t in tr.params + tr.opt_state["m"]
             + tr.opt_state["v"]]
    step = before["opt_state"]["step"]
    ids = np.full((4, 64), 464, np.int32)
    m = tr.train_step({"input_ids": ids, "labels": ids.copy()})
    after = tr.state()
    unchanged = all(torch.equal(a, b) for a, b in zip(
        saved, tr.params + tr.opt_state["m"] + tr.opt_state["v"]))
    check(float(m["amp_skipped"]) == 1.0, "the forced overflow did not "
          "overflow")
    check(unchanged, "the skipped step wrote p, m or v")
    check(after["opt_state"]["step"] == step, "the skipped step counted")
    check(float(tr.scaler_state["scale"]) == big * 0.5,
          f"scale {float(tr.scaler_state['scale'])} is not {big} / 2")
    print(f"training3 reference: GPT-2-large widths, 2 layers, bf16 params, "
          f"fp32 compute, dynamic scale, dropout 0.1/0.1, 3 steps: card vs "
          f"CPU worst relative diff {worst} (tol 1e-5); parameters max abs "
          f"diff {p_err:.3g}, at most {over_bound:.3g} of the per-element "
          f"bound (sum over steps of one bf16 ulp + lr x the AdamW "
          f"directions' gap; tol 1), {p_frac:.3g} of elements "
          f"past 1e-5 (tol 1e-3); {masks} dropout masks equal on card and "
          f"CPU; losses {[x['loss'] for x in on_card]}; forced overflow at "
          f"scale {big:.4g}: skipped, p/m/v byte for byte, AdamW step "
          f"{step} kept, scale -> {float(tr.scaler_state['scale']):.4g} "
          f"({time.perf_counter() - t0:.1f}s); {card}")
    del trainers, tr, gpu, cpu


def _t3_step_launches(kernels, per_step, label):
    counts = read_counts(kernels)
    check(counts == per_step, f"{label} launches {counts}, expected "
                              f"{per_step}")
    check_adam_arm(label, per_step["adam_update"], "bf16")
    zero_counts(kernels)
    return counts


def _t3_run(kernels, per_step, tr, batch, steps, label, losses, times,
            launches):
    """`steps` Trainer steps through `train` (log_every=1: each reads its
    loss), launch counts checked per step."""
    for i in range(steps):
        t0 = time.perf_counter()
        metrics = tr.train([batch], num_steps=1)
        times.append(time.perf_counter() - t0)
        losses.append((float(metrics["loss"]), float(metrics["grad_norm"]),
                       float(metrics["loss_scale"])))
        for k, n in _t3_step_launches(kernels, per_step,
                                      f"{label} step {tr.global_step}"
                                      ).items():
            launches[k] += n


def _t3_dropout_ms(cfg, mbs, seq, calls_per_layer):
    """The dropout's device time a step, timed apart: a mask and its
    scaling at the probabilities' and the hidden state's shapes, times
    the calls a step makes (forward, recompute, backward: 3 a site a
    layer a micro-batch)."""
    from hetu_tpu_torch.ops.activations import DropoutKey, dropout
    key = DropoutKey((1, 2, 3))
    out = {}
    for name, shape, dtype in (
            ("probs", (mbs, cfg.num_attention_heads, seq, seq),
             torch.float32),
            ("hidden", (mbs, seq, cfg.hidden_size), cfg.compute_dtype)):
        x = torch.randn(shape, device="cuda").to(dtype)
        out[name] = event_ms(lambda: dropout(x, 0.1, key,
                                             deterministic=False))
        del x
    per_layer = calls_per_layer * (out["probs"] + 2 * out["hidden"])
    return out, per_layer


def training3_gpt_phase(seed: int, kernels, card: str):
    """Phase 14 (b): GPT-2-large's widths, depth cut 36 -> 12 for the
    smoke's time (phase 15 (e) trains all 36), attention and
    hidden dropout 0.1, bf16 parameters, the dynamic loss scale — policy
    "nothing", `TrainingConfig(16, 8, 1024, seed=1, ...)`, checkpoints
    every 3 steps, 1 kept.  Run A takes 6 steps; once its step-3
    checkpoint is committed, the step's files are hard-linked aside (the
    directory a crash after step 3 leaves); a fresh model and trainer
    `restore_latest_valid` from there (step 3) and take steps 4-6
    (checkpointing every 1,000 steps, so it writes none): their
    losses, grad norms, scales and every parameter equal run A's bit for
    bit.  Launch counts exact each step; phase 8's loss checks; step
    p50, tokens/s, mfu, peak memory; one step profiled (the sum of its
    kernels on int64 data: the dropout hash's and any index or arange
    work) and the dropout timed apart; checkpoint
    bytes, the host's time blocked in `save`, the write (in the
    background: steps 4-5 run beside step 3's, the profiled step beside
    step 6's) and the restore."""
    import shutil
    import tempfile

    from hetu_tpu_torch.engine import Trainer, TrainingConfig
    from hetu_tpu_torch.models.gpt import GPTConfig, GPTLMHeadModel
    from hetu_tpu_torch.utils.checkpoint import manifest_path

    t_phase = time.perf_counter()
    cfg = GPTConfig.gpt2_large(num_hidden_layers=12, attention_dropout=0.1,
                               hidden_dropout=0.1, param_dtype=torch.bfloat16)
    L, gbs, mbs, seq = cfg.num_hidden_layers, 16, 8, 1024
    root = tempfile.mkdtemp(prefix="training3-")
    run_dir, crash_dir = os.path.join(root, "a"), os.path.join(root, "b")

    def trainer(ckpt_dir, ckpt_every=3):
        model = GPTLMHeadModel(cfg, device="cuda", seed=seed)
        return Trainer(model, TrainingConfig(
            global_batch_size=gbs, micro_batch_size=mbs, seq_len=seq,
            lr=1e-3, warmup_steps=2, total_steps=1000, log_every=1, seed=1,
            dropout_deterministic=False, loss_scale="dynamic",
            ckpt_dir=ckpt_dir, ckpt_every=ckpt_every, ckpt_keep=1),
            device="cuda").build()
    batch = _train_batch(cfg.vocab_size, gbs, seq, seed)
    sigma = cfg.initializer_range * math.sqrt(cfg.hidden_size)
    expect_first = math.log(cfg.vocab_size) + sigma ** 2 / 2
    per_step = {name: 0 for name in kernels}
    per_step.update(residual_layernorm_fwd=2 * L * (gbs // mbs),
                    residual_layernorm_bwd=L * (gbs // mbs), adam_update=1)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tr = trainer(run_dir)
    mgr = tr._manager()
    n_params = sum(p.numel() for p in tr.params)
    zero_counts(kernels)
    losses, times, launches = [], [], {name: 0 for name in kernels}
    # steps 4 and 5 run while step 3's checkpoint is written
    _t3_run(kernels, per_step, tr, batch, 5, "training3 A", losses, times,
            launches)
    t0 = time.perf_counter()
    mgr.wait()
    wait_s = time.perf_counter() - t0
    os.makedirs(crash_dir)
    for name in (str(3), os.path.basename(manifest_path(run_dir, 3))):
        src = os.path.join(run_dir, name)
        if os.path.isdir(src):
            shutil.copytree(src, os.path.join(crash_dir, name),
                            copy_function=os.link)
        else:
            os.link(src, os.path.join(crash_dir, name))
    _t3_run(kernels, per_step, tr, batch, 1, "training3 A", losses, times,
            launches)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    final = [p.detach().clone() for p in tr.params]
    # where the time goes: one step profiled, the dropout timed apart
    busy, wall, by_name, top = _profile(lambda: tr.train_step(batch), 1,
                                        top=8)
    int64_ms = sum(t for n, t in by_name.items() if "long" in n)
    drop_apart, drop_layer = _t3_dropout_ms(cfg, mbs, seq, 3)
    drop_step = drop_layer * L * (gbs // mbs)
    zero_counts(kernels)
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    # run A's step-6 checkpoint, written beside the profiled step
    t0 = time.perf_counter()
    mgr.wait()
    wait6_s = time.perf_counter() - t0
    check(mgr.all_steps() == [6], f"ckpt_keep=1 kept {mgr.all_steps()}")
    # the resume
    t0 = time.perf_counter()
    # (it saves no checkpoint of its own in its 3 steps)
    re = trainer(crash_dir, ckpt_every=1000)
    re.restore_latest_valid()
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    check(re.global_step == 3, f"restored step {re.global_step}, not 3")
    resumed = []
    _t3_run(kernels, per_step, re, batch, 3, "training3 resumed", resumed,
            [], launches)
    check(resumed == losses[3:], f"resumed steps 4-6 {resumed} differ from "
          f"the uninterrupted run's {losses[3:]}")
    differ = [n for n, a, b in zip(re.names, final, re.params)
              if not torch.equal(a, b.detach())]
    check(not differ, f"resumed parameters differ: {differ[:5]}")
    restore_ms = re.registry.histogram("ckpt.restore_s").summary()
    reg = mgr.registry
    ckpt = {"bytes": reg.gauge_value("ckpt.bytes"),
            "save_blocked_s": reg.histogram("ckpt.save_blocked_s").summary(),
            "write_s": reg.histogram("ckpt.write_s").summary(),
            "wait_for_step_3_write_after_step_5_s": wait_s,
            "wait_for_step_6_write_after_profiled_step_s": wait6_s}
    del re, final, mgr
    shutil.rmtree(root)
    loss = [x[0] for x in losses]
    check(all(math.isfinite(x) for x in loss), f"losses {loss}")
    check(abs(loss[0] - expect_first) <= 0.5,
          f"first loss {loss[0]} is not within 0.5 of {expect_first}")
    check(loss[-1] < loss[0], f"loss did not fall: {loss}")
    tokens = gbs * seq
    p50 = float(np.median(times))
    flops = cfg.flops_per_token(seq) * tokens
    out = {
        "model": "GPT-2-large", "layers": L, "params": n_params,
        "param_dtype": "bf16", "dropout": [0.1, 0.1],
        "attention": "dense (attention dropout)", "remat_policy": "nothing",
        "micro_batch": mbs, "seq_len": seq, "tokens_per_step": tokens,
        "losses_grad_norms_scales": losses, "step_s": times,
        "step_s_p50": p50, "tokens_per_s": tokens / p50,
        "mfu": flops / p50 / PEAK_OPS_PER_S[torch.bfloat16],
        "peak_memory_gib": peak, "launches_per_step": per_step,
        "resumed_from_step": 3, "resume_bit_identical": True,
        "checkpoint": dict(ckpt, restore_s=restore_s,
                           restore_copy_s=restore_ms),
        "profiled_step": {"device_busy_ms": busy, "wall_ms": wall,
                          "device_idle_share": 1.0 - busy / (p50 * 1e3),
                          "int64_kernels_ms": int64_ms,
                          "top_kernels_ms": top},
        "dropout_apart_ms": drop_apart, "dropout_ms_per_step": drop_step,
        "dropout_share_of_step": drop_step / (p50 * 1e3),
        "phase_s": time.perf_counter() - t_phase, "card": card}
    print("training3 gpt " + json.dumps(out))
    return launches


def training3_llama_phase(seed: int, kernels, card: str):
    """Phase 14 (c): Llama-3-8B widths cut to 8 layers, bf16 parameters,
    flash, `TrainingConfig(4, 2, 2048)`, 3 steps under "dots_attn" and
    under "offload": exact launch counts per policy (the norm, RoPE and
    SwiGLU forwards twice a layer and micro-batch under both; the flash
    forward once under "dots_attn", twice under "offload", which keeps
    the "dots" set), step p50, tokens/s, mfu, peak memory and the bytes
    "offload" stages to the host a step.  Returns {path: launches}."""
    from hetu_tpu_torch.engine import Trainer, TrainingConfig
    from hetu_tpu_torch.models.llama import LlamaConfig, LlamaLMHeadModel
    from hetu_tpu_torch.nn import remat

    out = {}
    gbs, mbs, seq = 4, 2, 2048
    for policy in ("dots_attn", "offload"):
        t_phase = time.perf_counter()
        cfg = LlamaConfig.llama3_8b(num_hidden_layers=8,
                                    param_dtype=torch.bfloat16,
                                    remat_policy=policy)
        L, n_micro = cfg.num_hidden_layers, gbs // mbs
        fwd, bwd = 2 * L * n_micro, L * n_micro
        per_step = {name: 0 for name in kernels}
        per_step.update(fused_rotary_qk=fwd, fused_swiglu=fwd,
                        residual_rmsnorm_fwd=fwd, residual_rmsnorm_bwd=bwd,
                        swiglu_bwd=bwd, rotary_qk_bwd=bwd, adam_update=1,
                        flash_fwd=bwd if policy == "dots_attn" else fwd,
                        flash_bwd_dq=bwd, flash_bwd_dkv=bwd)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = LlamaLMHeadModel(cfg, device="cuda", seed=seed)
        tr = Trainer(model, TrainingConfig(
            global_batch_size=gbs, micro_batch_size=mbs, seq_len=seq,
            lr=1e-3, warmup_steps=2, total_steps=1000, log_every=1),
            device="cuda").build()
        batch = _train_batch(cfg.vocab_size, gbs, seq, seed)
        zero_counts(kernels)
        launches = {name: 0 for name in kernels}
        losses, times, staged = [], [], []
        for i in range(3):
            host0 = remat.offloaded_bytes
            t0 = time.perf_counter()
            metrics = tr.train([batch], num_steps=1)
            times.append(time.perf_counter() - t0)
            staged.append(remat.offloaded_bytes - host0)
            losses.append(float(metrics["loss"]))
            for k, n in _t3_step_launches(kernels, per_step,
                                          f"training3 {policy} step {i + 1}"
                                          ).items():
                launches[k] += n
        check(all(math.isfinite(x) for x in losses), f"losses {losses}")
        check((policy == "offload") == (staged[0] > 0),
              f"{policy} staged {staged} bytes")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        tokens = gbs * seq
        p50 = float(np.median(times))
        flops = cfg.flops_per_token(seq) * tokens
        print("training3 llama " + json.dumps({
            "model": "Llama-3-8B widths", "layers": L,
            "params": sum(p.numel() for p in tr.params),
            "param_dtype": "bf16", "remat_policy": policy,
            "micro_batch": mbs, "seq_len": seq, "losses": losses,
            "step_s": times, "step_s_p50": p50,
            "tokens_per_s": tokens / p50,
            "mfu": flops / p50 / PEAK_OPS_PER_S[torch.bfloat16],
            "peak_memory_gib": peak, "host_staged_bytes_per_step": staged,
            "launches_per_step": per_step,
            "phase_s": time.perf_counter() - t_phase, "card": card}))
        out[f"training3_{policy}"] = launches
        del tr, model
    return out


# ------------------------------------------------------------ training4
def packed_rows(dataset, rows: int, seq: int, start: int = 0, fill=0.95):
    """A packed batch of `rows` rows of `seq` slots from `dataset`, taken
    in order from index `start`: each next sequence joins if
    `pack_sequences(..., num_packed=rows, on_overflow="error")` still
    packs it (one that does not waits for the next batch), until `fill`
    of the slots hold tokens or 64 sequences in a row do not fit; then
    the collator `DataCollatorForLanguageModel(seq, packing=True)` makes
    the batch with `num_rows=rows`, which must equal that packing.
    Returns (batch, the index after the last sequence looked at)."""
    from hetu_tpu_torch.data import DataCollatorForLanguageModel
    from hetu_tpu_torch.data.bucket import pack_sequences
    chosen, used, misses, i = [], 0, 0, start
    while i < len(dataset) and used < fill * rows * seq and misses < 64:
        s = dataset[i]
        i += 1
        try:
            pack_sequences(chosen + [s], seq, num_packed=rows,
                           on_overflow="error")
        except ValueError:
            misses += 1
            continue
        chosen.append(s)
        used += len(s)
        misses = 0
    batch = DataCollatorForLanguageModel(seq, packing=True)(chosen,
                                                            num_rows=rows)
    ref = pack_sequences(chosen, seq, num_packed=rows, on_overflow="error")
    check(all(np.array_equal(batch[k], ref[k]) for k in ref),
          "the collator's packing differs from pack_sequences'")
    return batch, i


def f16_rms_cases(randn, rows, hidden, note=""):
    """The fused RMS norm's fp16 arm at [rows, hidden] (x, h fp16; w
    fp32), forward and backward, against the plain versions (one fp16
    ulp + 1e-6; dw 1e-5 of its largest entry) and timed beside the
    composition `x + h`, `F.rms_norm` (the backward's: forward +
    backward less forward, one CUDA graph each).  `randn(*shape, std=,
    dtype=)` draws the inputs."""
    import torch.nn.functional as F
    from hetu_tpu_torch.ops.cuda import fused_norm as fn
    f16, eps = torch.float16, 1e-5
    tol, sums = ulps(1, 1e-6, f16), rel(1e-5, of_max=True)
    x, h, dy, dr = (randn(rows, hidden) for _ in range(4))
    w = 1.0 + randn(hidden, std=0.1, dtype=torch.float32)
    wh = w.to(f16)
    n = rows * hidden
    out = {"residual_rmsnorm_fwd_f16": [case(
        f"residual_rmsnorm_fwd [{rows},{hidden}] fp16, w fp32{note}", tol,
        lambda i: fn.residual_rmsnorm_fwd(x, h, w, eps),
        lambda i: fn.residual_rmsnorm_plain(x, h, w, eps),
        4 * n * 2 + hidden * 4, 6 * n,
        composition=lambda i: _add_then(F.rms_norm, x, h, (hidden,), wh,
                                        eps))]}
    _, s = fn.residual_rmsnorm_fwd(x, h, w, eps)
    leaves = [t.detach().clone().requires_grad_(True) for t in (s, wh)]

    def rms_fwd_bwd():
        ds_, dw_ = torch.autograd.grad(
            F.rms_norm(leaves[0], (hidden,), leaves[1], eps), leaves, dy)
        return ds_ + dr, dw_
    with torch.no_grad():
        rms_f = device_ms(lambda: F.rms_norm(s, (hidden,), wh, eps))
    rms_fb = device_ms(rms_fwd_bwd)
    del leaves
    out["residual_rmsnorm_bwd_f16"] = [case(
        f"residual_rmsnorm_bwd [{rows},{hidden}] fp16, dw fp32{note}",
        (tol, sums), lambda i: fn.residual_rmsnorm_bwd(s, w, dy, dr, eps),
        lambda i: fn.residual_rmsnorm_bwd_plain(s, w, dy, dr, eps),
        4 * n * 2 + 2 * hidden * 4, 11 * n, composition_ms=rms_fb - rms_f)]
    return out


def f16_swiglu_cases(randn, tokens, inter, note=""):
    """SwiGLU's fp16 arm at [tokens, inter], forward from the strided
    halves of the fused projection and backward, one fp16 ulp from the
    plain versions, timed beside the compositions."""
    from hetu_tpu_torch.ops.cuda import swiglu as sw
    f16 = torch.float16
    gu, dy = randn(tokens, 2, inter), randn(tokens, inter)
    n = tokens * inter
    return {"fused_swiglu_f16": [case(
        f"fused_swiglu [{tokens},{inter}] fp16{note}", ulps(1, dtype=f16),
        lambda i: sw.fused_swiglu(gu),
        lambda i: sw.swiglu_plain(gu[:, 0], gu[:, 1]), 3 * n * 2, 5 * n,
        composition=swiglu_composition(gu))],
        "swiglu_bwd_f16": [case(
            f"swiglu_bwd [{tokens},{inter}] fp16{note}", ulps(1, dtype=f16),
            lambda i: sw.swiglu_bwd(gu, dy),
            lambda i: torch.stack(sw.swiglu_bwd_plain(gu[:, 0], gu[:, 1],
                                                      dy), dim=-2),
            5 * n * 2, 12 * n,
            composition_ms=swiglu_bwd_composition_ms(gu, dy))]}


def f16_rope_cases(randn, b, s, n_kv, group, theta, note=""):
    """RoPE's fp16 arm read in place from the fused projection [b, s,
    n_kv, group+2, 128] and its backward over q [b, s, n_kv x group,
    128], k [b, s, n_kv, 128], one fp16 ulp from the plain versions,
    timed beside the compositions (tables of base `theta`)."""
    from hetu_tpu_torch.ops.cuda import rotary as ro
    from hetu_tpu_torch.ops.rotary import build_rope_cache, rope_tables
    f16 = torch.float16
    cos, sin = build_rope_cache(max(s, 4096) * 2, 128, theta, device="cuda")
    cos_t, sin_t = rope_tables(cos, sin, b, s)
    out = {"fused_rotary_qk_f16": [rope_qkv_case(
        f"fused_rotary_qk q,k views of qkv [{b},{s},{n_kv},{group}+2,128] "
        f"fp16{note}", randn(b, s, n_kv, group + 2, 128), group, cos_t,
        sin_t, tol=ulps(1, dtype=f16))]}
    dq, dk = randn(b, s, n_kv * group, 128), randn(b, s, n_kv, 128)
    pairs = (dq.numel() + dk.numel()) // 2
    out["rotary_qk_bwd_f16"] = [case(
        f"rotary_qk_bwd q=[{b},{s},{n_kv * group},128] k=[{b},{s},{n_kv},"
        f"128] fp16{note}", ulps(1, dtype=f16),
        lambda i: ro.rotary_qk_bwd(dq, dk, cos_t, sin_t),
        lambda i: ro.rotary_qk_plain(dq, dk, cos_t, -sin_t),
        2 * (dq.numel() + dk.numel()) * 2 + 2 * cos_t.numel() * 4,
        6 * pairs, composition=rope_composition(dq, dk, cos_t, sin_t, -1.0))]
    return out


def training4_kernel_phase(seed: int):
    """Phase 15 (a): every fp16 arm against its plain version at the
    training shapes of the bf16 rows, timed beside its bound, its plain
    version and its yardstick: flash at q [2, 2048, 32, 128] over 8 kv
    heads, causal, without segments and with a packed batch's (the data
    stack's packing of 128-1,024-token sequences), and GPT's [8, 1024,
    20, 64] (`scaled_dot_product_attention` in fp16); the RMS norm at
    [4096, 4096], the LayerNorm (with a bias) at [8192, 1280], SwiGLU at
    [4096, 14336] and RoPE from the fused projection [2, 2048, 8, 4+2,
    128] and its backward at [2, 2048, 32+8, 128], forward and backward
    (the compositions of the bf16 rows, in fp16, one CUDA graph each).
    Tolerances: each output a kernel and its plain version round once to
    fp16 from fp32 values within one fp16 ulp (+1e-6 where the norms'
    centred sums cancel); dw and db 1e-5 of their largest entry; flash:
    o half an fp16 ulp + 1e-5 + 2^-10 max|v| (P rounded to fp16 for the
    product, 2^-11 relative, or 2^-25 absolute below fp16's normal
    range), lse 1e-5, the fp32 gradients 2^-10 of their largest entry
    (the bf16 arm's 2^-8, three bits finer)."""
    import torch.nn.functional as F
    from hetu_tpu_torch.data import TokenizedDataset
    from hetu_tpu_torch.ops.cuda import fused_norm as fn

    g = torch.Generator(device="cuda").manual_seed(seed + 40)
    f16, eps = torch.float16, 1e-5
    tol = ulps(1, 1e-6, f16)
    sums = rel(1e-5, of_max=True)
    out = {}

    def randn(*shape, std=1.0, dtype=f16):
        return (std * torch.randn(shape, generator=g, device="cuda")).to(
            dtype)

    # flash: causal, then the packed layout's segments, then GPT's shape
    for name, more in flash_timed(g, 2, 2048, 32, 8, 128, f16).items():
        out[f"{name}_f16"] = more
    ds = TokenizedDataset.synthetic(64, 128256, 128, 1024, seed=seed)
    packed, _ = packed_rows(ds, 2, 2048)
    segments = torch.from_numpy(packed["segment_ids"]).cuda()
    for name, more in flash_timed(g, 2, 2048, 32, 8, 128, f16, segments,
                                  " packed").items():
        out[f"{name}_f16"] += more
    for name, more in flash_timed(g, 8, 1024, 20, 20, 64, f16).items():
        out[f"{name}_f16"] += more
    out.update(f16_rms_cases(randn, 4096, 4096))
    # the fused LayerNorm with a bias [8192, 1280]
    rows, hidden = 8192, 1280
    x, h, dy, dr = (randn(rows, hidden) for _ in range(4))
    w = 1.0 + randn(hidden, std=0.1, dtype=torch.float32)
    b = randn(hidden, std=0.1, dtype=torch.float32)
    wh, bh = w.to(f16), b.to(f16)
    n = rows * hidden
    out["residual_layernorm_fwd_f16"] = [case(
        f"residual_layernorm_fwd [{rows},{hidden}] fp16, w, b fp32", tol,
        lambda i: fn.residual_layernorm_fwd(x, h, w, b, eps),
        lambda i: fn.residual_layernorm_plain(x, h, w, b, eps),
        4 * n * 2 + 2 * hidden * 4, 8 * n,
        composition=lambda i: _add_then(F.layer_norm, x, h, (hidden,), wh,
                                        bh, eps))]
    _, s = fn.residual_layernorm_fwd(x, h, w, b, eps)
    _, mean, rstd = torch.ops.aten.native_layer_norm(s, (hidden,), wh, bh,
                                                     eps)

    def ln_bwd_composition(i):
        dx, dw_, db_ = torch.ops.aten.native_layer_norm_backward(
            dy, s, (hidden,), mean, rstd, wh, bh, [True, True, True])
        return dx + dr, dw_, db_
    out["residual_layernorm_bwd_f16"] = [case(
        f"residual_layernorm_bwd [{rows},{hidden}] fp16, dw, db fp32",
        (tol, sums, sums),
        lambda i: fn.residual_layernorm_bwd(s, w, dy, dr, eps),
        lambda i: fn.residual_layernorm_bwd_plain(s, w, dy, dr, eps),
        4 * n * 2 + 3 * hidden * 4, 18 * n, composition=ln_bwd_composition)]
    del x, h, dy, dr, s, mean, rstd
    out.update(f16_swiglu_cases(randn, 4096, 14336))
    out.update(f16_rope_cases(randn, 2, 2048, 8, 4, 500000.0))
    return out


def _t4_narrow_config():
    """Phase 7's narrow Llama (hidden 512, 4 q / 2 kv heads of 128,
    SwiGLU 1536, vocab 4096, 2 layers; positions to 2,048) computing in
    fp16 over fp32 parameters, flash, "dots_attn"."""
    from hetu_tpu_torch.models.llama import LlamaConfig
    return LlamaConfig.tiny(hidden_size=512, num_attention_heads=4,
                            num_key_value_heads=2, intermediate_size=1536,
                            vocab_size=4096, num_hidden_layers=2,
                            max_position_embeddings=2048,
                            compute_dtype=torch.float16,
                            use_flash_attention=True,
                            remat_policy="dots_attn")


def _t4_pair(seed):
    """The narrow model on the CPU and on the card, one set of weights
    (the CPU's draw), the CPU forced onto flash's plain version."""
    from hetu_tpu_torch.models.llama import LlamaLMHeadModel
    cfg = _t4_narrow_config()
    cpu = LlamaLMHeadModel(cfg, device="cpu", seed=seed)
    gpu = LlamaLMHeadModel(cfg, device="cuda", seed=seed)
    gpu.load_state_dict(cpu.state_dict())
    for layer in cpu.model.layers:
        layer.attn.use_pallas = True
    return gpu, cpu


def _t4_bound(bound, trainers, step, opt):
    """Add step `step`'s share to each parameter's card-vs-CPU bound:
    lr x what the two sides' AdamW directions differ by, each recomputed
    in fp32 (2^-21 |u| for its own rounding), + 2^-21 |p| for each
    side's fp32 update (phase 14 (a)'s bound, with fp32 parameters)."""
    card_t, cpu_t = trainers
    for i, (pg, pc, mg, vg, mc, vc) in enumerate(zip(
            card_t.params, cpu_t.params, card_t.opt_state["m"],
            card_t.opt_state["v"], cpu_t.opt_state["m"],
            cpu_t.opt_state["v"])):
        u = _adam_direction(mg, vg, step, opt)
        u_ref = _adam_direction(mc.to("cuda"), vc.to("cuda"), step, opt)
        bound[i] += opt._lr(step) * ((u - u_ref).abs() + 2.0 ** -21 * (
            u.abs() + u_ref.abs())) + 2.0 ** -21 * torch.maximum(
                pg.detach().abs(), pc.detach().to("cuda").abs())


#: phase 15 (b)'s limits, card against CPU: the loss and the global
#: grad norm relative, each moment leaf against its largest entry (set
#: about 10x above what the card measured; PERF.md §6)
T4_LOSS_TOL, T4_GRAD_NORM_TOL, T4_MOMENT_TOL = 1e-4, 3e-4, 2.0 ** -5


def training4_reference_phase(seed: int, card: str):
    """Phase 15 (b): the narrow Llama (`_t4_narrow_config`: fp32
    parameters, fp16 compute, flash, "dots_attn", `loss_scale="auto"`,
    `TrainingConfig(4, 2, 64, packing=True)`) on the card and on the
    CPU from one set of weights, 3 steps on packed batches taken in
    turn: the scaler on at both sides, loss_scale and amp_skipped equal
    each step, loss within T4_LOSS_TOL and grad norm within
    T4_GRAD_NORM_TOL relative (both sides round every activation to
    fp16, cuBLAS's products and the CPU's in their own orders), every
    leaf's m and v within T4_MOMENT_TOL of that leaf's largest entry on
    the CPU (a wrong gradient of any leaf, however small its share of
    the global norm, shows in its own moments), every parameter within
    phase 14 (a)'s bound (`_t4_bound`: AdamW applied the moments just
    held); then the scale set to 2^22 on both sides (this
    batch's fp16 cotangents overflow at 2^21 and above): each step
    overflows, is skipped and halves the scale until an update lands —
    the two sequences of (amp_skipped, loss_scale) equal, the parameters
    unchanged by the skipped steps."""
    from hetu_tpu_torch.data import pack_sequences
    from hetu_tpu_torch.engine import Trainer, TrainingConfig
    t0 = time.perf_counter()
    gpu, cpu = _t4_pair(seed)
    tc = TrainingConfig(global_batch_size=4, micro_batch_size=2, seq_len=64,
                        warmup_steps=1, total_steps=10, log_every=100,
                        packing=True)
    trainers = [Trainer(gpu, tc, device="cuda").build(),
                Trainer(cpu, tc, device="cpu").build()]
    check(all(t._scaler is not None for t in trainers),
          "fp16 compute under loss_scale='auto' has no scaler")
    rng = np.random.default_rng(seed + 41)
    batches = []
    for _ in range(3):
        seqs = [rng.integers(1, 4096, int(n)) for n in
                rng.integers(2, 64, 9)]
        batches.append({k: v[:4] for k, v in pack_sequences(
            seqs, 64, num_packed=6).items()})
    opt = trainers[1].optimizer
    bound = [torch.zeros(p.shape, device="cuda") for p in gpu.parameters()]
    on_card, on_cpu = [], []
    for step, batch in enumerate(batches, 1):
        for tr, out in zip(trainers, (on_card, on_cpu)):
            out.append({k: float(v) for k, v in tr.train_step(batch).items()})
        _t4_bound(bound, trainers, step, opt)
    for a, b in zip(on_card, on_cpu):
        check(a["loss_scale"] == b["loss_scale"] and
              a["amp_skipped"] == b["amp_skipped"] == 0.0,
              f"card vs CPU scale or skips differ: {a} / {b}")
    worst = {k: max(abs(a[k] - b[k]) / abs(b[k])
                    for a, b in zip(on_card, on_cpu))
             for k in ("loss", "grad_norm")}
    check(worst["loss"] <= T4_LOSS_TOL
          and worst["grad_norm"] <= T4_GRAD_NORM_TOL,
          f"card vs CPU fp16 training differs: {worst}")
    moments = {}
    for key in ("m", "v"):
        per_leaf = []
        for name, a, b in zip(trainers[1].names, trainers[0].opt_state[key],
                              trainers[1].opt_state[key]):
            b = b.to("cuda")
            scale = b.abs().max().item()
            per_leaf.append(((a - b).abs().max().item() / scale
                             if scale else (a - b).abs().max().item(), name))
        moments[key] = max(per_leaf)
        check(moments[key][0] <= T4_MOMENT_TOL,
              f"card vs CPU {key} of {moments[key][1]}: "
              f"{moments[key][0]:.3g} of its largest entry "
              f"(tol {T4_MOMENT_TOL})")
    over = max(((a.detach() - b.detach().to("cuda")).abs() / bnd).max().item()
               for a, b, bnd in zip(trainers[0].params, trainers[1].params,
                                    bound))
    check(over <= 1.0, f"card vs CPU parameters past their bound: {over}")
    # the forced overflow on both sides
    for tr in trainers:
        tr.settle()
        tr.scaler_state["scale"].fill_(2.0 ** 22)
    before = [p.detach().clone() for p in trainers[0].params]
    seqs = {"cuda": [], "cpu": []}
    batch = batches[0]
    for _ in range(20):
        for tr, dev in zip(trainers, ("cuda", "cpu")):
            m = tr.train_step(batch)
            seqs[dev].append((float(m["amp_skipped"]),
                              float(m["loss_scale"])))
        if seqs["cuda"][-1][0] == 0.0 or seqs["cpu"][-1][0] == 0.0:
            break
        check(all(torch.equal(a, b.detach()) for a, b in zip(
            before, trainers[0].params)), "a skipped step wrote p")
    check(seqs["cuda"] == seqs["cpu"],
          f"card and CPU skip or scale differently: {seqs}")
    check(seqs["cuda"][0][0] == 1.0 and seqs["cuda"][1][0] == 1.0
          and seqs["cuda"][-1][0] == 0.0,
          f"the overflow did not skip, or no update landed: {seqs['cuda']}")
    print(f"training4 reference: narrow Llama, 2 layers, fp32 params, fp16 "
          f"compute, flash + dots_attn, loss_scale auto, packed batches, 3 "
          f"steps: card vs CPU worst relative diff {worst} (tol "
          f"{T4_LOSS_TOL}, {T4_GRAD_NORM_TOL}); moments at most "
          f"{moments} of their leaf's largest entry (tol {T4_MOMENT_TOL}); "
          f"parameters at most {over:.6f} of their bound (tol 1); scales "
          f"{[x['loss_scale'] for x in on_card]}, skips 0; losses "
          f"{[x['loss'] for x in on_card]}; forced overflow from 2^22: "
          f"(skipped, scale) {seqs['cuda']} on both "
          f"({time.perf_counter() - t0:.1f}s); {card}")
    del trainers, gpu, cpu


def _t4_scores(lg, labels, keep):
    """(loss sum, count) of the next-token targets labels[1:] where
    `keep`, in fp64 from fp32 logits [s, V]."""
    lg, tgt = lg[:-1].double(), torch.as_tensor(labels[1:], device=lg.device)
    on = torch.as_tensor(keep[1:], device=lg.device) & (tgt != -100)
    nll = torch.logsumexp(lg, -1) - lg.gather(
        -1, torch.where(on, tgt, 0).long()[:, None])[:, 0]
    return float(nll[on].sum()), int(on.sum())


def training4_packed_phase(seed: int, card: str):
    """Phase 15 (c): packed against alone on the card — the narrow Llama
    (fp16, flash: the fp16 kernels with the segment mask) scores each of
    seven sequences (1-300 tokens) inside two packed rows of 512 slots
    and alone in a padded row of 512: the same token count, and the same
    loss within 2e-3 relative (the packed and the alone forwards round
    each fp16 product in their own tile order and GEMM shape)."""
    from hetu_tpu_torch.data import pack_sequences, pad_batch
    from hetu_tpu_torch.ops.cuda import flash_attention as fa
    t0 = time.perf_counter()
    gpu, _ = _t4_pair(seed)
    rng = np.random.default_rng(seed + 42)
    lengths = (300, 41, 129, 64, 1, 250, 190)
    seqs = [rng.integers(1, 4096, n) for n in lengths]
    packed = pack_sequences(seqs, 512, num_packed=2, on_overflow="error")
    alone = pad_batch(seqs, 512)
    before = fa.arm_launches["launches"]["f16"]
    logits = {}
    with torch.no_grad():
        for name, batch in (("packed", packed), ("alone", alone)):
            logits[name] = gpu(
                torch.from_numpy(batch["input_ids"]).cuda(),
                position_ids=torch.from_numpy(batch["position_ids"]).cuda(),
                segment_ids=torch.from_numpy(batch["segment_ids"]).cuda()
            ).float()
    check(fa.arm_launches["launches"]["f16"] - before == 2 * 2,
          "the forwards did not run the fp16 flash kernel a layer")
    check(all(bool(torch.isfinite(t).all()) for t in logits.values()),
          "non-finite logits")
    # where each sequence landed: (row, segment) of its tokens
    where = {}
    for r in range(2):
        for sg in range(1, int(packed["segment_ids"][r].max()) + 1):
            ids = packed["input_ids"][r][packed["segment_ids"][r] == sg]
            where[ids.tobytes()] = (r, sg)
    worst = 0.0
    for j, s in enumerate(seqs):
        r, sg = where[s.astype(np.int32).tobytes()]
        a = _t4_scores(logits["packed"][r], packed["labels"][r],
                       packed["segment_ids"][r] == sg)
        b = _t4_scores(logits["alone"][j], alone["labels"][j],
                       alone["segment_ids"][j] == 1)
        check(a[1] == b[1] == len(s) - 1, f"sequence {j}: counts {a[1]}, "
              f"{b[1]}, expected {len(s) - 1}")
        err = abs(a[0] - b[0]) / max(abs(b[0]), 1.0)
        worst = max(worst, err)
        check(err <= 2e-3, f"sequence {j}: packed {a[0]} vs alone {b[0]}")
    print(f"training4 packed: {len(seqs)} sequences ({lengths}) in 2 packed "
          f"rows of 512 vs alone, fp16, flash with segments: counts equal, "
          f"losses worst relative diff {worst:.3g} (tol 2e-3) "
          f"({time.perf_counter() - t0:.1f}s); {card}")
    del gpu


def _t4_per_step(kernels, cfg, n_micro, policy):
    """Exact launches a step of a training path (phase 8's counts) on
    the fp16 arms: each fp16 counter equal to its total's."""
    from hetu_tpu_torch.models.gpt import GPTConfig
    L = cfg.num_hidden_layers
    fwd, bwd = 2 * L * n_micro, L * n_micro
    per_step = {name: 0 for name in kernels}
    gpt = isinstance(cfg, GPTConfig)
    arms = ({"residual_layernorm_fwd": fwd, "residual_layernorm_bwd": bwd}
            if gpt else
            {"fused_rotary_qk": fwd, "fused_swiglu": fwd,
             "residual_rmsnorm_fwd": fwd, "residual_rmsnorm_bwd": bwd,
             "swiglu_bwd": bwd, "rotary_qk_bwd": bwd})
    arms.update(flash_fwd=bwd if policy == "dots_attn" else fwd,
                flash_bwd_dq=bwd, flash_bwd_dkv=bwd)
    for name, n in arms.items():
        per_step[name] = per_step[f"{name}_f16"] = n
    per_step["adam_update"] = 1
    return per_step


def training4_llama_phase(seed: int, kernels, card: str):
    """Phase 15 (d): Llama-3-8B widths cut to 8 layers, fp32 parameters,
    fp16 compute (`loss_scale="auto"`), flash, "dots_attn",
    `TrainingConfig(4, 2, 2048, packing=True)`, 6 steps on one packed
    batch (`packed_rows`: sequences of 128-1,024 tokens from
    `TokenizedDataset.synthetic`, `on_overflow="error"`, at least 85% of
    the 8,192 slots real tokens): exact launch counts each step (every
    fp16 arm its phase 8 count, AdamW's fp32 arm once), the losses
    finite and the last below the first, no skipped step; step p50,
    tokens/s over slots and over real tokens, mfu (over slots and over
    real tokens), peak memory, the scale's course and the skips, one
    step profiled (idle share, heaviest kernels).  Returns the run's
    launches."""
    from hetu_tpu_torch.data import TokenizedDataset
    from hetu_tpu_torch.engine import Trainer, TrainingConfig
    from hetu_tpu_torch.models.llama import LlamaConfig, LlamaLMHeadModel
    t_phase = time.perf_counter()
    cfg = LlamaConfig.llama3_8b(num_hidden_layers=8,
                                compute_dtype=torch.float16,
                                remat_policy="dots_attn")
    gbs, mbs, seq = 4, 2, 2048
    ds = TokenizedDataset.synthetic(256, cfg.vocab_size, 128, 1024,
                                    seed=seed)
    batch, _ = packed_rows(ds, gbs, seq)
    real = int((batch["segment_ids"] > 0).sum())
    check(real >= 0.85 * gbs * seq,
          f"packed rows hold {real} tokens of {gbs * seq} slots")
    per_step = _t4_per_step(kernels, cfg, gbs // mbs, "dots_attn")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = LlamaLMHeadModel(cfg, device="cuda", seed=seed)
    tr = Trainer(model, TrainingConfig(
        global_batch_size=gbs, micro_batch_size=mbs, seq_len=seq, lr=1e-3,
        warmup_steps=2, total_steps=1000, log_every=1, packing=True),
        device="cuda").build()
    check(tr._scaler is not None, "fp16 compute without the scaler")
    zero_counts(kernels)
    launches = {name: 0 for name in kernels}
    losses, times = [], []
    for i in range(6):
        t0 = time.perf_counter()
        metrics = tr.train([batch], num_steps=1)
        times.append(time.perf_counter() - t0)
        losses.append((float(metrics["loss"]), float(metrics["grad_norm"]),
                       float(metrics["loss_scale"]),
                       float(metrics["amp_skipped"])))
        counts = read_counts(kernels)
        check(counts == per_step, f"training4 llama step {i + 1} launches "
              f"{counts}, expected {per_step}")
        check_adam_arm(f"training4 llama step {i + 1}", 1, "f32")
        for k, n in counts.items():
            launches[k] += n
        zero_counts(kernels)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    applied = [x[0] for x in losses if x[3] == 0.0]
    check(all(math.isfinite(x[0]) for x in losses), f"losses {losses}")
    check(len(applied) >= 2 and applied[-1] < applied[0],
          f"the loss did not fall over the applied steps: {losses}")
    busy, wall, by_name, top = _profile(lambda: tr.train_step(batch), 1,
                                        top=8)
    zero_counts(kernels)
    p50 = float(np.median(times))
    slots = gbs * seq
    flops = cfg.flops_per_token(seq)
    print("training4 llama " + json.dumps({
        "model": "Llama-3-8B widths", "layers": cfg.num_hidden_layers,
        "params": sum(p.numel() for p in tr.params), "param_dtype": "fp32",
        "compute_dtype": "fp16", "remat_policy": "dots_attn",
        "micro_batch": mbs, "seq_len": seq, "packing": True,
        "slots_per_step": slots, "real_tokens_per_step": real,
        "real_share": real / slots,
        "loss_grad_norm_scale_skipped": losses, "step_s": times,
        "step_s_p50": p50, "tokens_per_s_slots": slots / p50,
        "tokens_per_s_real": real / p50,
        "mfu_slots": flops * slots / p50 / PEAK_OPS_PER_S[torch.float16],
        "mfu_real": flops * real / p50 / PEAK_OPS_PER_S[torch.float16],
        "skips": sum(x[3] for x in losses), "peak_memory_gib": peak,
        "launches_per_step": {k: v for k, v in per_step.items() if v},
        "profiled_step": {"device_busy_ms": busy, "wall_ms": wall,
                          "device_idle_share": 1.0 - busy / (p50 * 1e3),
                          "top_kernels_ms": top},
        "phase_s": time.perf_counter() - t_phase, "card": card}))
    del tr, model
    return launches


def training4_gpt_phase(seed: int, kernels, card: str):
    """Phase 15 (e): GPT-2-large as published in depth and width, fp16
    compute over fp32 parameters (`loss_scale="auto"`), flash at head dim
    64, "nothing", `TrainingConfig(16, 8, 1024)`, 3 steps through
    `Trainer.train` over `build_data_loader(TokenizedDataset.synthetic(
    ...), 16, 1024, packing=False, prefetch=2)` (padded rows of 256-1,024
    tokens, the prefetch thread): exact launch counts (the LayerNorm and
    flash fp16 arms), finite losses, no skipped step; step p50 (each
    step reads its loss), tokens/s over slots and real tokens, mfu, peak
    memory.  Returns the run's launches."""
    from hetu_tpu_torch.data import TokenizedDataset, build_data_loader
    from hetu_tpu_torch.engine import Trainer, TrainingConfig
    from hetu_tpu_torch.models.gpt import GPTConfig, GPTLMHeadModel
    t_phase = time.perf_counter()
    cfg = GPTConfig.gpt2_large(compute_dtype=torch.float16)
    gbs, mbs, seq, steps = 16, 8, 1024, 3
    loader = build_data_loader(
        TokenizedDataset.synthetic(gbs * (steps + 1), cfg.vocab_size, 256,
                                   seq, seed=seed), gbs, seq,
        packing=False, seed=seed, prefetch=2)
    per_step = _t4_per_step(kernels, cfg, gbs // mbs, "nothing")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = GPTLMHeadModel(cfg, device="cuda", seed=seed)
    tr = Trainer(model, TrainingConfig(
        global_batch_size=gbs, micro_batch_size=mbs, seq_len=seq, lr=1e-3,
        warmup_steps=2, total_steps=1000, log_every=1), device="cuda")
    real = []

    def batches():
        for b in loader:
            real.append(int((b["segment_ids"] > 0).sum()))
            yield b
    zero_counts(kernels)
    metrics = tr.train(batches(), num_steps=steps)
    counts = read_counts(kernels)
    expect = {k: steps * v for k, v in per_step.items()}
    check(counts == expect, f"training4 gpt launches {counts}, expected "
          f"{expect}")
    check_adam_arm("training4 gpt", steps, "f32")
    zero_counts(kernels)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    hist = tr.registry.histogram("trainer.step_time_s")
    loss = float(metrics["loss"])
    check(math.isfinite(loss) and float(metrics["amp_skipped"]) == 0.0,
          f"GPT fp16 step: {metrics}")
    p50 = hist.percentile(50)
    slots, real_mean = gbs * seq, float(np.mean(real[:steps]))
    print("training4 gpt " + json.dumps({
        "model": "GPT-2-large", "layers": cfg.num_hidden_layers,
        "params": sum(p.numel() for p in tr.params), "param_dtype": "fp32",
        "compute_dtype": "fp16", "remat_policy": "nothing",
        "micro_batch": mbs, "seq_len": seq, "packing": False,
        "steps": tr.registry.counter_value("trainer.steps"),
        "last_loss": loss, "loss_scale": float(metrics["loss_scale"]),
        "step_s_p50": p50, "tokens_per_s_slots": slots / p50,
        "real_tokens_per_step": real[:steps],
        "tokens_per_s_real": real_mean / p50,
        "mfu_slots": cfg.flops_per_token(seq) * slots / p50
        / PEAK_OPS_PER_S[torch.float16],
        "peak_memory_gib": peak,
        "launches_per_step": {k: v for k, v in per_step.items() if v},
        "phase_s": time.perf_counter() - t_phase, "card": card}))
    del tr, model
    return counts



# --------------------------------------------------------------- lora
#: phase 16 (a)'s limits on the last step's numerics record, card against
#: CPU, beyond phase 15's: an underflow or overflow fraction absolute
#: (one element in a thousand across a threshold; measured 0), an
#: element's value (absmax) relative (about 10x the 2.8e-4 the card
#: measured; PERF.md §6)
LORA_FRAC_TOL, LORA_ABSMAX_TOL = 1e-3, 2.0 ** -8


@contextlib.contextmanager
def hook_flags(on: bool, runlog=None):
    """The hooks' flags (HETU_TORCH_HEALTH, HETU_TORCH_NUMERICS and the
    run log at `runlog`) set, or all unset, for what runs within;
    restored after."""
    names = ("HETU_TORCH_HEALTH", "HETU_TORCH_NUMERICS", "HETU_TORCH_RUNLOG")
    saved = {k: os.environ.pop(k, None) for k in names}
    if on:
        os.environ.update(HETU_TORCH_HEALTH="1", HETU_TORCH_NUMERICS="1")
        if runlog:
            os.environ["HETU_TORCH_RUNLOG"] = runlog
    try:
        yield
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


@contextlib.contextmanager
def hooks_absent():
    """The training path as it ran before the hooks: every numerics
    call a no-op and no adapter lookup (`weight_of` the weight itself),
    to count on the card what the hooks add with their flags unset."""
    import types
    from unittest import mock
    from hetu_tpu_torch.models.gpt import model as gpt
    from hetu_tpu_torch.models.llama import model as llama
    from hetu_tpu_torch.nn import remat
    from hetu_tpu_torch.obs import numerics

    @contextlib.contextmanager
    def frame():
        yield types.SimpleNamespace(stats={})
    nothing = lambda *a, **k: None      # noqa: E731
    with contextlib.ExitStack() as stack:
        for mod, name, fn in (
                (numerics, "tap_tree", nothing),
                (numerics, "tap_stats", nothing),
                (numerics, "merge", nothing),
                (numerics, "frame", frame),
                (numerics, "stack", lambda frames: {}),
                (numerics, "reduce_stacked", lambda scopes: scopes),
                (remat, "adapter_of", nothing),
                (remat, "weight_of", lambda w: w),
                (llama, "weight_of", lambda w: w),
                (gpt, "weight_of", lambda w: w)):
            stack.enter_context(mock.patch.object(mod, name, fn))
        yield


def arm_table():
    """{counter: {arm: launches}} of every training wrapper with dtype
    arms, since the last `zero_counts`."""
    from hetu_tpu_torch.ops.cuda import adam as ad
    from hetu_tpu_torch.ops.cuda import flash_attention as fa
    from hetu_tpu_torch.ops.cuda import fused_norm as fn
    from hetu_tpu_torch.ops.cuda import rotary as ro
    from hetu_tpu_torch.ops.cuda import swiglu as sw
    out = {}
    for label, mod in (("flash", fa), ("norm", fn), ("swiglu", sw),
                       ("rotary", ro), ("adam", ad)):
        for counter, arms in mod.arm_launches.items():
            if any(arms.values()):
                out[f"{label}.{counter}"] = {a: n for a, n in arms.items()
                                             if n}
    return out


def param_digest(params, chunk: int = 1 << 26):
    """A fingerprint of the tensors' bits computed on the card: for each
    tensor the sum and an index-weighted sum of its 16- or 32-bit words
    (int64), a chunk at a time."""
    out = []
    for p in params:
        flat = p.detach().reshape(-1).view(
            torch.int16 if p.element_size() == 2 else torch.int32)
        s = w = 0
        for start in range(0, flat.numel(), chunk):
            c = flat[start:start + chunk].long()
            idx = torch.arange(start, start + c.numel(), device=c.device)
            s += int(c.sum())
            w += int((c * (idx % 1000003 + 1)).sum())
        out.append((s, w))
    return out


def _lora_narrow(family: str):
    """Phase 16 (a)'s narrow configs: Llama (phase 7's widths, flash,
    "dots_attn": segments that keep W, A and B) and GPT (hidden 512, 8
    heads of 64, flash, "nothing": whole blocks that rebind their
    adapters), 2 layers, vocab 4096, a bf16 base (merged as W + (A B
    scale) rounded to bf16) computing in fp32 (flash's fp32 arm)."""
    from hetu_tpu_torch.models.gpt import GPTConfig
    from hetu_tpu_torch.models.llama import LlamaConfig
    common = dict(vocab_size=4096, num_hidden_layers=2,
                  max_position_embeddings=2048, param_dtype=torch.bfloat16,
                  compute_dtype=torch.float32, use_flash_attention=True)
    if family == "llama":
        return LlamaConfig.tiny(hidden_size=512, num_attention_heads=4,
                                num_key_value_heads=2, intermediate_size=1536,
                                remat_policy="dots_attn", **common)
    return GPTConfig.tiny(hidden_size=512, num_attention_heads=8,
                          remat_policy="nothing", **common)


def _sft_rows(rng, vocab, rows, seq, prompt=(4, 24)):
    """Prompt-masked rows [rows, seq]: random ids, a padded tail on some
    rows, labels from `mask_prompt_labels` with each row's prompt
    length and true length."""
    from hetu_tpu_torch.engine import mask_prompt_labels
    ids = rng.integers(1, vocab, (rows, seq)).astype(np.int32)
    lens = rng.integers(seq // 2, seq + 1, rows)
    for i, n in enumerate(lens):
        ids[i, n:] = 0
    prompts = rng.integers(*prompt, rows)
    return {"input_ids": ids,
            "labels": mask_prompt_labels(ids, prompts, seq_lens=lens)}


def _numerics_gap(card_stats, cpu_stats):
    """The last step's numerics records, card against CPU, key for key:
    (worst relative gap of absmax, of the other stats; worst absolute
    gap of a fraction); counts and names must be equal."""
    check(list(card_stats) == list(cpu_stats),
          f"numerics scopes {list(card_stats)} vs {list(cpu_stats)}")
    gaps = {"absmax": 0.0, "other": 0.0, "frac": 0.0}
    for scope, stats in cpu_stats.items():
        check(list(card_stats[scope]) == list(stats),
              f"numerics {scope}: stats {list(card_stats[scope])} vs "
              f"{list(stats)}")
        for k, v in stats.items():
            a, b = float(card_stats[scope][k]), float(v)
            if k == "nonfinite":
                check(a == b, f"numerics {scope}.{k}: {a} vs {b}")
            elif k.endswith("_frac"):
                gaps["frac"] = max(gaps["frac"], abs(a - b))
            else:
                key = "absmax" if k == "absmax" else "other"
                gaps[key] = max(gaps[key], abs(a - b) / max(abs(b), 1e-30))
    return gaps


def lora_reference_phase(seed: int, card: str):
    """Phase 16 (a): LoRA SFT of a narrow Llama and a narrow GPT
    (`_lora_narrow`), rank 4 on every reference target, on the card and
    on the CPU from one base and one set of adapters (the CPU's draw),
    4 `SFTTrainer` steps of prompt-masked batches [4 x 64] in two
    micro-batches, HETU_TORCH_NUMERICS and HETU_TORCH_HEALTH on (fp32
    compute, so phase 15's limits hold the LoRA arithmetic, not bf16's
    rounding; the bf16 path is `tests/test_torch_cuda.py`'s): losses
    within T4_LOSS_TOL and grad norms within T4_GRAD_NORM_TOL relative;
    every adapter leaf's m and v within T4_MOMENT_TOL of its largest
    entry on the CPU; every adapter element within phase 15's
    AdamW-direction bound (`_t4_bound`); the last step's numerics
    record scope for scope and stat for stat (counts equal, fractions
    within LORA_FRAC_TOL, absmax within LORA_ABSMAX_TOL, the others
    within T4_GRAD_NORM_TOL relative); the base untouched."""
    from hetu_tpu_torch.engine import SFTTrainer, TrainingConfig
    from hetu_tpu_torch.models.gpt import GPTLMHeadModel
    from hetu_tpu_torch.models.llama import LlamaLMHeadModel
    from hetu_tpu_torch.peft import LoRAConfig
    t0 = time.perf_counter()
    tc = TrainingConfig(global_batch_size=4, micro_batch_size=2, seq_len=64,
                        warmup_steps=1, total_steps=10, log_every=100)
    out = {}
    for family in ("llama", "gpt"):
        cfg = _lora_narrow(family)
        cls = LlamaLMHeadModel if family == "llama" else GPTLMHeadModel
        cpu = cls(cfg, device="cpu", seed=seed)
        gpu = cls(cfg, device="cuda", seed=seed)
        gpu.load_state_dict(cpu.state_dict())
        for layer in cpu.layers:       # flash's plain version on the CPU
            layer.attn.use_pallas = True
        with hook_flags(True):
            trainers = [SFTTrainer(gpu, tc, lora=LoRAConfig(rank=4),
                                   device="cuda"),
                        SFTTrainer(cpu, tc, lora=LoRAConfig(rank=4),
                                   device="cpu")]
        with torch.no_grad():
            for a, b in zip(trainers[0].model.lora.values(),
                            trainers[1].model.lora.values()):
                a.copy_(b)
        for tr in trainers:
            tr.build()
        before = param_digest(gpu.parameters())
        rng = np.random.default_rng(seed + 61)
        batches = [_sft_rows(rng, cfg.vocab_size, 4, 64) for _ in range(4)]
        opt = trainers[1].optimizer
        bound = [torch.zeros(p.shape, device="cuda")
                 for p in trainers[0].params]
        on_card, on_cpu, stats = [], [], []
        for step, batch in enumerate(batches, 1):
            for tr, rows in zip(trainers, (on_card, on_cpu)):
                m = tr.train_step(batch)
                stats.append(m.pop("numerics"))
                rows.append({k: float(v) for k, v in m.items()})
            _t4_bound(bound, trainers, step, opt)
        worst = {k: max(abs(a[k] - b[k]) / abs(b[k])
                        for a, b in zip(on_card, on_cpu))
                 for k in ("loss", "grad_norm")}
        check(worst["loss"] <= T4_LOSS_TOL
              and worst["grad_norm"] <= T4_GRAD_NORM_TOL,
              f"{family} LoRA card vs CPU differs: {worst}")
        moments = {}
        for key in ("m", "v"):
            per_leaf = []
            for name, a, b in zip(trainers[1].names,
                                  trainers[0].opt_state[key],
                                  trainers[1].opt_state[key]):
                b = b.to("cuda")
                scale = b.abs().max().item() or 1.0
                per_leaf.append(((a - b).abs().max().item() / scale, name))
            moments[key] = max(per_leaf)
            check(moments[key][0] <= T4_MOMENT_TOL,
                  f"{family} LoRA card vs CPU {key} of {moments[key][1]}: "
                  f"{moments[key][0]:.3g} of its largest entry")
        over = max(((a.detach() - b.detach().to("cuda")).abs()
                    / bnd).max().item()
                   for a, b, bnd in zip(trainers[0].params,
                                        trainers[1].params, bound))
        check(over <= 1.0, f"{family} LoRA adapters past their bound: {over}")
        gaps = _numerics_gap(stats[-2], stats[-1])
        check(gaps["frac"] <= LORA_FRAC_TOL
              and gaps["absmax"] <= LORA_ABSMAX_TOL
              and gaps["other"] <= T4_GRAD_NORM_TOL,
              f"{family} LoRA numerics card vs CPU: {gaps}")
        check(param_digest(gpu.parameters()) == before,
              f"{family} LoRA: the frozen base changed")
        check(all(p.grad is None for p in gpu.parameters()),
              f"{family} LoRA: the base has gradients")
        out[family] = {"worst": worst, "moments": moments,
                       "adapters_of_bound": over, "numerics_gaps": gaps,
                       "scopes": list(stats[-1]),
                       "losses": [x["loss"] for x in on_card]}
        del trainers, gpu, cpu
    print("lora reference: card vs CPU, 4 SFT steps, rank 4, bf16 base, "
          "fp32 compute, flash: " + json.dumps(out) + f" (tolerances loss "
          f"{T4_LOSS_TOL}, grad norm {T4_GRAD_NORM_TOL}, moments "
          f"{T4_MOMENT_TOL}, adapters 1 x their bound, numerics fractions "
          f"{LORA_FRAC_TOL}, absmax {LORA_ABSMAX_TOL}, others "
          f"{T4_GRAD_NORM_TOL}) ({time.perf_counter() - t0:.1f}s); {card}")


def sft_chat_batch(seed: int, vocab: int, rows: int, seq: int):
    """`rows` chat samples of `TokenizedDataset.synthetic`-sized texts
    (prompts of 200-900 characters, answers of 200-1,000) through
    `build_sft_example` (the in-tree byte-fallback SentencePiece model,
    an instruction template, eos closing the answer), padded to `seq`;
    labels from `mask_prompt_labels` (held equal to the template's own
    mask).  Returns (batch, loss tokens)."""
    from hetu_tpu_torch.data import (ChatFormat, InputOutputTemplate,
                                     TokenizedDataset, build_sft_example)
    from hetu_tpu_torch.data.tokenizers.sp_model import (
        SentencePieceTokenizer, write_model_proto)
    from hetu_tpu_torch.engine import mask_prompt_labels
    pieces = [("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3)]
    pieces += [(f"<0x{b:02X}>", 0.0, 6) for b in range(256)]
    tok = SentencePieceTokenizer(model_bytes=write_model_proto(
        pieces, 1, byte_fallback=True))
    text = lambda s: "".join(chr(97 + int(c)) if c < 26 else " "  # noqa
                             for c in s)
    prompts = TokenizedDataset.synthetic(rows, 30, 200, 900, seed=seed)
    answers = TokenizedDataset.synthetic(rows, 30, 200, 1000,
                                         seed=seed + 1)
    ids = np.zeros((rows, seq), np.int32)
    labels = np.full((rows, seq), -100, np.int32)
    plens, lens = [], []
    for i in range(rows):
        r_ids, r_lab = build_sft_example(
            {"input": text(prompts[i]), "output": text(answers[i])},
            InputOutputTemplate(), tok.encode, chat_format=ChatFormat(),
            bos_id=tok.bos_id, eos_id=tok.eos_id, max_len=seq)
        ids[i, :len(r_ids)] = r_ids
        labels[i, :len(r_lab)] = r_lab
        plens.append(int(np.argmax(np.asarray(r_lab) != -100)))
        lens.append(len(r_ids))
    masked = mask_prompt_labels(ids, plens, seq_lens=lens)
    check(np.array_equal(masked, labels),
          "mask_prompt_labels differs from the template's mask")
    check(int(ids.max()) < vocab, "token ids past the vocabulary")
    return {"input_ids": ids, "labels": masked}, int(
        (masked[:, 1:] != -100).sum())


def lora_llama_phase(seed: int, kernels, card: str):
    """Phase 16 (b): LoRA SFT of Llama-3-8B at full width, depth cut to
    8 layers (the whole smoke's time limit; bf16 frozen base drawn from
    `seed`, bf16 compute, flash,
    "dots_attn"), `LoRAConfig(rank=16)` on the reference's Llama
    targets, `SFTTrainer(..., TrainingConfig(global_batch_size=8,
    micro_batch_size=2, seq_len=2048), device="cuda").train(...)`, 4
    steps on one chat batch (`sft_chat_batch`), HETU_TORCH_RUNLOG,
    HETU_TORCH_HEALTH and HETU_TORCH_NUMERICS on: exact launch counts
    each step (phase 8's counts at 8 layers; AdamW once on its fp32
    arm over the adapter leaves), the loss finite and falling, only the
    adapters changed (the base's fingerprint before and after, no
    gradient on it), peak memory at most 70 GiB (else the micro-batch
    halves); step p50 and max, tokens/s over slots and over loss
    tokens, mfu, the run log's records by kind and its anomalies, one
    step profiled with the hooks on (idle share) and one with the
    numerics collector off (the numerics' device operations a record
    step).  Returns the run's launches."""
    import tempfile
    from hetu_tpu_torch.engine import SFTTrainer, TrainingConfig
    from hetu_tpu_torch.models.llama import LlamaConfig, LlamaLMHeadModel
    from hetu_tpu_torch.obs.runlog import RunLog
    from hetu_tpu_torch.peft import LoRAConfig
    from hetu_tpu_torch.peft.lora import target_parameters
    t_phase = time.perf_counter()
    cfg = LlamaConfig.llama3_8b(num_hidden_layers=8,
                                param_dtype=torch.bfloat16,
                                remat_policy="dots_attn")
    L, gbs, seq = cfg.num_hidden_layers, 8, 2048
    lora = LoRAConfig(rank=16)
    batch, loss_tokens = sft_chat_batch(seed, cfg.vocab_size, gbs, seq)
    tmp = tempfile.mkdtemp(prefix="lora_runlog_")
    log_path = os.path.join(tmp, "runlog.jsonl")
    model = LlamaLMHeadModel(cfg, device="cuda", seed=seed)
    n_base = sum(p.numel() for p in model.parameters())
    targets = [n for n, _ in target_parameters(model, lora)]
    before = param_digest(model.parameters())
    for mbs in (2, 1):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with hook_flags(True, runlog=log_path):
            tr = SFTTrainer(model, TrainingConfig(
                global_batch_size=gbs, micro_batch_size=mbs, seq_len=seq,
                lr=1e-3, warmup_steps=1, total_steps=100, log_every=1),
                lora=lora, device="cuda").build()
        n_micro = gbs // mbs
        per_step = {name: 0 for name in kernels}
        per_step.update(_t4_per_step(kernels, cfg, n_micro, "dots_attn"))
        for name in [k for k in per_step if k.endswith("_f16")]:
            per_step[name] = 0
        zero_counts(kernels)
        losses, times, launches, arms = [], [], {k: 0 for k in kernels}, None
        cut = False
        for i in range(4):
            t0 = time.perf_counter()
            metrics = tr.train([batch], num_steps=1)
            times.append(time.perf_counter() - t0)
            losses.append(float(metrics["loss"]))
            counts = read_counts(kernels)
            check(counts == per_step, f"lora step {i + 1} launches {counts},"
                                      f" expected {per_step}")
            arms = arm_table()
            check_adam_arm(f"lora step {i + 1}", 1, "f32")
            for k, n in counts.items():
                launches[k] += n
            zero_counts(kernels)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            if i == 0 and peak > TRAIN_PEAK_GIB and mbs > 1:
                print(f"lora: CUT micro-batch {mbs} -> {mbs // 2}: peak "
                      f"{peak:.1f} GiB > {TRAIN_PEAK_GIB} GiB")
                cut = True
                break
        if not cut:
            break
        tr.close()
        del tr
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(peak <= TRAIN_PEAK_GIB, f"lora peak {peak:.2f} GiB")
    check(all(math.isfinite(x) for x in losses), f"lora losses {losses}")
    check(losses[-1] < losses[0], f"lora loss did not fall: {losses}")
    n_adapters = sum(p.numel() for p in tr.params)
    t_prof = time.perf_counter()
    with_numerics = {}
    busy, wall, by_name, top = _profile(lambda: tr.train_step(batch), 1,
                                        top=8, counts=with_numerics)
    tr._numerics = False
    without = {}
    _profile(lambda: tr.train_step(batch), 1, counts=without)
    tr._numerics = True
    t_prof = time.perf_counter() - t_prof
    zero_counts(kernels)
    tr.close()
    recs = RunLog.read(log_path)
    kinds = {}
    for r in recs:
        kinds[r["kind"]] = kinds.get(r["kind"], 0) + 1
    anomalies = [(r["anomaly"], r["step"]) for r in recs
                 if r["kind"] == "anomaly"]
    last = [r for r in recs if r["kind"] == "numerics"][-1]
    del tr
    gc.collect()
    check(param_digest(model.parameters()) == before,
          "lora: the frozen base changed")
    check(all(p.grad is None and not p.requires_grad
              for p in model.parameters()), "lora: the base has gradients")
    p50 = float(np.median(times))
    slots = gbs * seq
    flops = cfg.flops_per_token(seq)
    print("lora " + json.dumps({
        "model": "Llama-3-8B", "layers": L, "base_params": n_base,
        "base_dtype": "bf16", "compute_dtype": "bf16",
        "remat_policy": "dots_attn", "attention": "flash",
        "lora_rank": lora.rank, "lora_targets": len(targets),
        "adapter_params": n_adapters, "micro_batch": mbs,
        "micro_batches": n_micro, "seq_len": seq, "slots_per_step": slots,
        "loss_tokens_per_step": loss_tokens, "losses": losses,
        "step_s": times, "step_s_p50": p50, "step_s_max": max(times),
        "tokens_per_s_slots": slots / p50,
        "tokens_per_s_loss_tokens": loss_tokens / p50,
        "mfu": flops * slots / p50 / PEAK_OPS_PER_S[torch.bfloat16],
        "mfu_counts": "the model's training FLOPs per token over the "
                      "slots (6 x parameters + attention, no recompute; "
                      "the frozen base's weight gradients are taken for "
                      "the adapted matrices, as the reference's merge "
                      "does)",
        "peak_memory_gib": peak,
        "launches_per_step": {k: v for k, v in per_step.items() if v},
        "launches_by_arm_per_step": arms,
        "runlog_records": kinds, "anomalies": anomalies,
        "numerics_scopes": list(last["scopes"]),
        "profiled_step": {"device_busy_ms": busy, "wall_ms": wall,
                          "device_idle_share": 1.0 - busy / (p50 * 1e3),
                          "top_kernels_ms": top},
        "device_ops_step": round(sum(with_numerics.values())),
        "device_ops_step_numerics_off": round(sum(without.values())),
        "numerics_ops_per_record_step": round(
            sum(with_numerics.values()) - sum(without.values())),
        "profiles_s": t_prof, "phase_s": time.perf_counter() - t_phase,
        "card": card}))
    del model
    return launches


def lora_multitask_phase(seed: int, card: str):
    """Phase 16 (c): two tasks' adapters (rank 4) over phase 16 (a)'s
    narrow Llama on the card, micro-batches from
    `schedule_micro_batches` (fused leftovers included), one
    `MultiTaskSFTEngine.train_micro` each: every task with rows in the
    micro changes its adapters, the other keeps its bits; AdamW launches
    once a task span; the base untouched."""
    from hetu_tpu_torch.models.llama import LlamaLMHeadModel
    from hetu_tpu_torch.ops.cuda import adam as ad
    from hetu_tpu_torch.optim import AdamW
    from hetu_tpu_torch.peft import LoRAConfig, MultiLoRAManager
    from hetu_tpu_torch.peft.multi_task import (MultiTaskSFTEngine,
                                                schedule_micro_batches)
    t0 = time.perf_counter()
    model = LlamaLMHeadModel(_lora_narrow("llama"), device="cuda",
                             seed=seed)
    base = param_digest(model.parameters())
    mgr = MultiLoRAManager(model, LoRAConfig(rank=4), ["a", "b"], seed=seed)
    eng = MultiTaskSFTEngine(mgr, AdamW(lr=1e-3, device="cuda"))
    rng = np.random.default_rng(seed + 71)
    samples = {t: [rng.integers(1, 4096, int(n)).astype(np.int32)
                   for n in rng.integers(20, 60, k)]
               for t, k in ((0, 9), (1, 5))}
    micros = schedule_micro_batches(samples, max_tokens=256,
                                    train_task_num=2, bucket_sizes=(32, 64))
    spans, seen = 0, set()
    for micro in micros:
        before = {t: [p.clone() for p in mgr.parameters(t)] for t in "ab"}
        ad.launches = 0
        eng.train_micro(micro)
        ran = {"ab"[t] for t in micro.task_ids()}
        seen |= ran
        spans += len(ran)
        check(ad.launches == len(ran), f"multi-task: {ad.launches} AdamW "
                                       f"launches for {len(ran)} spans")
        for t in "ab":
            same = all(torch.equal(x, y) for x, y in zip(
                before[t], mgr.parameters(t)))
            check(same == (t not in ran),
                  f"multi-task: task {t} {'kept' if same else 'changed'} "
                  f"its adapters in a micro of tasks {sorted(ran)}")
    check(seen == {"a", "b"} and any(len(m.task_ids()) == 2 for m in micros),
          "multi-task: no fused micro")
    check(param_digest(model.parameters()) == base,
          "multi-task: the base changed")
    print(f"lora multi-task: {len(micros)} micro-batches, {spans} task "
          f"spans, shapes {sorted({(m.batch_size, m.seq_length) for m in micros})}"
          f"; each task's adapters changed only on its own rows "
          f"({time.perf_counter() - t0:.1f}s); {card}")
    del eng, mgr, model


def lora_identity_phase(seed: int, kernels, card: str):
    """Phase 16 (d): phase 8's step (Llama-3-8B widths, fp32 parameters,
    bf16 compute, flash, "dots_attn", `TrainingConfig(4, 2, 2048)`) cut
    to 2 layers with every hook flag unset: each kernel's launches by
    arm and the device operations of one step (`device_ops`, the two
    compared within a round) equal those with the hooks' call sites
    taken out (`hooks_absent`)."""
    from hetu_tpu_torch.engine import Trainer, TrainingConfig
    from hetu_tpu_torch.models.llama import LlamaConfig, LlamaLMHeadModel
    t0 = time.perf_counter()
    cfg = LlamaConfig.llama3_8b(num_hidden_layers=2, remat_policy="dots_attn")
    batch = _train_batch(cfg.vocab_size, 4, 2048, seed)
    with hook_flags(False):
        model = LlamaLMHeadModel(cfg, device="cuda", seed=seed)
        tr = Trainer(model, TrainingConfig(
            global_batch_size=4, micro_batch_size=2, seq_len=2048, lr=1e-3,
            warmup_steps=2, total_steps=1000, log_every=1),
            device="cuda").build()
        check(tr.run_log is None and tr._health is None and not tr._numerics,
              "hooks on with their flags unset")
        per_step = {name: 0 for name in kernels}
        per_step.update(_t4_per_step(kernels, cfg, 2, "dots_attn"))
        for name in [k for k in per_step if k.endswith("_f16")]:
            per_step[name] = 0
        result = {}
        for absent in (False, True):
            with hooks_absent() if absent else contextlib.nullcontext():
                tr.train_step(batch)
                torch.cuda.synchronize()
                zero_counts(kernels)
                tr.train_step(batch)
                torch.cuda.synchronize()
                counts, arms = read_counts(kernels), arm_table()
                check(counts == per_step, f"phase 8's step (absent="
                      f"{absent}) launches {counts}, expected {per_step}")
                zero_counts(kernels)
            result["hooks_absent" if absent else "flags_unset"] = {
                "launches_by_arm": arms}
        ops = device_ops(lambda: tr.train_step(batch),
                         (contextlib.nullcontext, hooks_absent))
        zero_counts(kernels)
        for key, n in zip(("flags_unset", "hooks_absent"), ops):
            result[key]["device_ops"] = n
    check(result["flags_unset"] == result["hooks_absent"],
          f"the hooks change phase 8's step with their flags unset: "
          f"{result}")
    print("lora identity: phase 8's step at 2 layers, flags unset vs the "
          "hooks taken out: " + json.dumps(result)
          + f" ({time.perf_counter() - t0:.1f}s); {card}")
    del tr, model


# -------------------------------------------------------------- serving4
#: the paths' serving kernels (phase 17 checks each launched, and no
#: training kernel)
SERVING4_KERNELS = ("paged_attention", "fused_rotary_qk", "fused_swiglu",
                    "kv_write_tokens", "kv_write_pages", "sample_logits")


def serving4_trace(vocab: int, seed: int, n: int = 24):
    """Phase 17's trace: `n` requests in bursts of 8 at 20 a second (the
    queue stays full), prompts 64-1,024 tokens, 32 new each; gold
    (priority 2) and bulk (deadline 60 s) alternate by rid; rids 2 and 3
    of every four (a gold and a bulk one) are the tenant free's, the
    others acme's; the odd requests sampled (0.8, top-k 50, top-p 0.95).
    The free tenant holds 4 of the first burst, so under (a)'s cap of 3
    the burst's last request meets a quota stall with a slot free
    whatever the card's step time (the virtual clock advances by the
    steps' wall time; with one free request in four the cap bound only
    when bursts and completions fell a certain way)."""
    from hetu_tpu_torch.serving import (SamplingParams, SLOClass,
                                        bursty_arrivals, synthetic_requests)
    reqs = synthetic_requests(
        n, vocab_size=vocab, prompt_lens=(64, 1024), max_new=(32, 32),
        arrivals=bursty_arrivals(n, 20.0, burst=8, seed=seed),
        slo_classes=[SLOClass("gold", priority=2),
                     SLOClass("bulk", deadline_s=60.0)],
        tenants=["acme", "acme", "free", "free"], seed=seed)
    for r in reqs[1::2]:
        r.sampling = SamplingParams(temperature=0.8, top_k=50, top_p=0.95,
                                    seed=seed + 100 + r.rid)
    return reqs


def _serving4_launches(path, launches):
    check(all(launches[k] > 0 for k in SERVING4_KERNELS),
          f"{path}: a serving kernel never launched: {launches}")
    serving = set(SERVING4_KERNELS) | {"quantize_blockwise",
                                       "dequantize_blockwise"}
    check(all(n == 0 for k, n in launches.items() if k not in serving),
          f"{path}: a kernel off the path launched: {launches}")


def _pcts(vals):
    vals = sorted(vals)
    return {"p50": vals[len(vals) // 2], "max": vals[-1]} if vals else None


def _record_keys(recs):
    """{(kind, serve event or span kind): the union of the keys} of a
    run log's serve, span and anomaly records."""
    out = {}
    for r in recs:
        if r["kind"] in ("serve", "span", "anomaly"):
            key = (r["kind"], r.get("event") or r.get("span")
                   or r.get("anomaly"))
            out.setdefault(key, set()).update(r)
    return out


def _serving4_policies(model, serve, seed, kill_at, run_log, *, opts):
    """One run of (a)'s engine: preemption, the free tenant capped at 3
    slots, deadlines, a retry budget of one, brownout, the tracer, the
    health detectors and a cost model, and an engine kill at `kill_at`;
    the scheduler's invariants checked before every step.  Returns the
    engine, its results and the live slots at the kill."""
    from hetu_tpu_torch.chaos.inject import maybe_chaos_serving
    from hetu_tpu_torch.chaos.plan import FaultPlan, FaultSpec
    from hetu_tpu_torch.obs.health import ServingHealthMonitor
    from hetu_tpu_torch.serving import (CostModel, RequestTracer,
                                        ServeConfig, ServingEngine,
                                        parse_quotas)
    c = model.config
    cost = CostModel.from_model_dims(
        num_params=c.num_params(), num_layers=c.num_hidden_layers,
        hidden_size=c.hidden_size, num_kv_heads=c.num_key_value_heads,
        head_dim=c.head_dim, page_size=serve["page_size"], kv_mode="bf16")
    eng = ServingEngine(
        model, ServeConfig(**serve, **opts, preempt=True, deadline=True,
                           quotas=parse_quotas("free:3"), retry_budget=1,
                           brownout=True),
        device=model.device, run_log=run_log,
        tracer=RequestTracer(run_log=run_log, keep=True),
        health=ServingHealthMonitor(runlog=run_log), cost_model=cost)
    if model.device.type == "cuda":
        eng.warmup()
    plan = FaultPlan([FaultSpec(kind="engine_kill", at_step=kill_at)])
    at_kill = []

    def on_step(i):
        eng.scheduler.check_invariants()
        if i == kill_at:
            at_kill.append(len(eng.scheduler.active_slots()))
        maybe_chaos_serving(plan, eng, i)
    return eng, on_step, at_kill


def serving4_cpu_records(tmp):
    """(a)'s engine options on the CPU (a tiny Llama, every request at
    once): the run log whose record keys the card run's must equal."""
    from hetu_tpu_torch.models.llama import LlamaConfig, LlamaLMHeadModel
    from hetu_tpu_torch.obs.runlog import RunLog
    from hetu_tpu_torch.serving import (SamplingParams, SLOClass,
                                        synthetic_requests)
    model = LlamaLMHeadModel(LlamaConfig.tiny(), device="cpu", seed=0)
    log = RunLog(os.path.join(tmp, "cpu.jsonl"))
    serve = dict(num_slots=3, page_size=8, max_len=64, prefill_chunk=16)
    eng, on_step, _ = _serving4_policies(model, serve, 0, 6, log,
                                         opts={"sampling": True})
    reqs = synthetic_requests(
        10, vocab_size=256, prompt_lens=(5, 40), max_new=(4, 9),
        arrivals=np.zeros(10), seed=9,
        tenants=["acme", "acme", "acme", "free"],
        slo_classes=[SLOClass("gold", priority=2),
                     SLOClass("bulk", deadline_s=60.0)])
    for r in reqs[1::2]:
        r.sampling = SamplingParams(temperature=0.8, top_k=20, seed=r.rid)
    eng.run(reqs, on_step=on_step)
    log.close()
    return RunLog.read(os.path.join(tmp, "cpu.jsonl"))


def serving4_policies_phase(model, seed, kernels, card, tmp):
    """(a): the undisturbed run of the trace, then the same trace
    through every host layer with an engine kill at step 40 (tokens of
    every completed request equal the undisturbed run's; preemptions and
    quota stalls happened; the kill requeued every live slot; the
    scheduler's invariants held before every step; deadline casualties
    emitted nothing after; slo_report reconciles every request's spans
    with zero residual; the record keys equal the CPU run's); then both
    again with n-gram speculation."""
    from hetu_tpu_torch.obs.runlog import RunLog
    from hetu_tpu_torch.serving import (ServeConfig, ServingEngine,
                                        serving_report)
    vocab = model.config.vocab_size
    serve = dict(num_slots=8, page_size=16, max_len=2048, prefill_chunk=256)
    cpu_keys = _record_keys(serving4_cpu_records(tmp))
    by_path, out, base_tokens = {}, {}, {}
    for spec in ({}, {"spec_decode": "ngram", "spec_k": 4}):
        tag = "ngram" if spec else "decode"
        opts = dict(sampling=True, **spec)
        gc.collect()
        torch.cuda.empty_cache()
        alone = ServingEngine(model, ServeConfig(**serve, **opts),
                              device="cuda").warmup()
        zero_counts(kernels)
        t0 = time.perf_counter()
        base = alone.run(serving4_trace(vocab, seed))
        base_wall = time.perf_counter() - t0
        launches = read_counts(kernels)
        if not spec:
            _serving4_launches("serving4_colocated", launches)
            by_path["serving4_colocated"] = launches
            base_tokens["ttft"] = [r.stats.ttft_s for r in base]
        want = {r.rid: r.tokens for r in base}
        base_tokens[tag] = want
        check(all(r.finished_reason == "length" and len(r.tokens) == 32
                  for r in base), f"serving4 {tag}: an undisturbed "
              "request did not finish by length")
        del alone
        gc.collect()
        torch.cuda.empty_cache()

        path = os.path.join(tmp, f"card_{tag}.jsonl")
        log = RunLog(path)
        eng, on_step, at_kill = _serving4_policies(model, serve, seed, 40,
                                                   log, opts=opts)
        torch.cuda.reset_peak_memory_stats()
        zero_counts(kernels)
        t0 = time.perf_counter()
        res = eng.run(serving4_trace(vocab, seed), on_step=on_step)
        wall = time.perf_counter() - t0
        launches = read_counts(kernels)
        eng.scheduler.check_invariants()
        log.close()
        path_name = f"serving4_policies_{tag}"
        if not spec:
            _serving4_launches(path_name, launches)
        by_path[path_name] = launches
        reg = eng.registry
        done = [r for r in res if r.finished_reason == "length"]
        for r in done:
            check(r.tokens == want[r.rid], f"{path_name}: request {r.rid} "
                  "differs from the undisturbed run")
        for r in res:
            check(r.finished_reason in ("length", "deadline_exceeded"),
                  f"{path_name}: request {r.rid} ended "
                  f"{r.finished_reason}")
            if r.finished_reason == "deadline_exceeded":
                check(r.tokens == want[r.rid][:len(r.tokens)]
                      and len(r.tokens) < 32, f"{path_name}: expired "
                      f"request {r.rid} emitted past its deadline")
        check(len(res) == 24 and len({r.rid for r in res}) == 24,
              f"{path_name}: {len(res)} results")
        preempt = reg.counter_value("serve.preemptions")
        quota = reg.counter_value("serve.admission_stalls",
                                  reason="quota_exceeded")
        requeues = reg.counter_value("serve.replica_requeues")
        check(preempt > 0 and quota > 0, f"{path_name}: preemptions "
              f"{preempt}, quota stalls {quota}")
        check(at_kill and requeues == at_kill[0] > 0,
              f"{path_name}: {requeues} requeues, {at_kill} live at the "
              "kill")
        check(eng.pool.free_count == eng.pool.num_pages,
              f"{path_name}: pages leaked")
        recs = RunLog.read(path)
        rep = serving_report(recs)
        check(rep["reconciliation"]["max_residual_s"] < 1e-9,
              f"{path_name}: spans do not tile e2e: "
              f"{rep['reconciliation']}")
        keys = _record_keys(recs)
        for k, v in keys.items():
            if k in cpu_keys:
                check(v == cpu_keys[k], f"{path_name}: {k} keys "
                      f"{sorted(v ^ cpu_keys[k])} differ from the CPU's")
        check({("serve", e) for e in ("admit", "done", "preempt", "retry",
                                      "failover", "report")}
              <= set(keys) & set(cpu_keys),
              f"{path_name}: record kinds {sorted(set(keys))}")
        gap = reg.histogram("serve.token_latency_s")
        ttft = [r.stats.ttft_s for r in done]
        out[path_name] = {
            "requests": len(res), "completed": len(done),
            "deadline_exceeded": len(res) - len(done),
            "preemptions": preempt, "quota_stalls": quota,
            "replica_requeues": requeues, "live_at_kill": at_kill[0],
            "ttft_s": _pcts(ttft),
            "ttft_s_undisturbed": _pcts([r.stats.ttft_s for r in base]),
            "decode_step_s_p50": gap.percentile(50),
            "decode_step_s_max": gap.vmax,
            "tokens_per_s": sum(len(r.tokens) for r in res) / wall,
            "run_wall_s": wall, "undisturbed_wall_s": base_wall,
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "records": len(recs), "record_types": len(keys),
            "slo_attainment": rep["slo_attainment"],
            "costs_total": (rep.get("costs") or {}).get("total")}
        print(f"{path_name} " + json.dumps(out[path_name]))
        del eng
    return by_path, base_tokens


def _ship_check(worker_out, quant):
    """One real prefill scratch through a wire's pack and unpack: the
    payload within the wire's grid of each head vector's absmax (the
    reference's round-trip rule) and `wire_bytes` the predicted size.
    On the int8 wire, whose pack and unpack launch the quantize and
    dequantize kernels at the wire's shape ([L * max_len * n_kv, hd]),
    the payload, the scales and the unpacked values also equal, bit for
    bit, the plain versions' on the same scratch (on the host)."""
    from hetu_tpu_torch.serving import pack_shipment, unpack_shipment
    req, attempt, t1, ks, vs = worker_out
    ship = pack_shipment(1, req, attempt, t1, ks, vs, quant=quant)
    bk, bv = unpack_shipment(ship, ks.device)
    grid = {"none": 0.0, "int8": 1.0 / 254.0, "int4": 1.0 / 14.0}[quant]
    for back, x in ((bk, ks), (bv, vs)):
        x = x.float()
        err = (back.float() - x).abs()
        lim = x.abs().amax(dim=-1, keepdim=True) * grid + 1e-6
        check(bool((err <= lim).all()), f"{quant} wire: round trip past "
              f"its grid by {float((err - lim).max())}")
    if quant == "int8":
        plain = pack_shipment(1, req, attempt, t1, ks.cpu(), vs.cpu(),
                              quant=quant)
        for part in ("ks", "vs", "k_scale", "v_scale"):
            check(torch.equal(getattr(ship, part), getattr(plain, part)),
                  f"int8 wire: the quantize kernel's {part} differs from "
                  f"the plain version's at {tuple(ks.shape)}")
        pk, pv = unpack_shipment(plain)
        check(torch.equal(bk.cpu(), pk) and torch.equal(bv.cpu(), pv),
              f"int8 wire: the dequantize kernel's unpack differs from "
              f"the plain version's at {tuple(ks.shape)}")
        print(f"int8 wire: payload, scales and unpack bit-equal to the "
              f"plain versions at {tuple(ks.shape)} "
              f"{str(ks.dtype).removeprefix('torch.')} a side")
    return ship.wire_bytes


def serving4_disagg_phase(model, seed, kernels, card, want, colocated_ttft):
    """(b): a 2-slot prefill tier and a decode engine on the card share
    the model; (a)'s trace over the three wires without faults — the
    exact wire's tokens equal the colocated run's, the quantized wires
    complete, every shipment's bytes are the predicted scratch size,
    the int8 wire launches the quantize twice a pack and the dequantize
    twice an unpack — then the exact wire under a shipment storm and a
    prefill kill: the survivors' tokens equal the colocated run's and
    the scheduler's invariants (no rid in two slots) hold before every
    coordinator step."""
    from hetu_tpu_torch.chaos.plan import FaultPlan, FaultSpec
    from hetu_tpu_torch.serving import (DisaggCoordinator, PrefillWorker,
                                        ServeConfig, ServingEngine)
    c = model.config
    vocab = c.vocab_size
    serve = ServeConfig(num_slots=8, page_size=16, max_len=2048,
                        prefill_chunk=256, sampling=True, retry_budget=2)
    scratch = c.num_hidden_layers * serve.max_len * c.num_key_value_heads \
        * c.head_dim                     # elements of one K (or V) scratch
    predicted = {"none": 2 * 2 * scratch,
                 "int8": 2 * (scratch + 4 * scratch // c.head_dim),
                 "int4": 2 * (scratch // 2 + 4 * scratch // c.head_dim)}
    worker = PrefillWorker(model, prefill_chunk=256, max_len=2048,
                           num_slots=2, sampling=True, device="cuda")
    probe = serving4_trace(vocab, seed)[0]
    worker.submit(probe)
    payload = []
    while not payload:
        payload = worker.step()
    for quant, n in predicted.items():
        got = _ship_check(payload[0], quant)
        check(got == n, f"{quant} wire: {got} bytes a shipment, "
              f"predicted {n}")
    del payload
    storm = [FaultSpec(kind="shipment_drop", op="ship", after_calls=2,
                       count=2, prob=1.0),
             FaultSpec(kind="shipment_dup", op="ship", after_calls=6,
                       count=2, prob=1.0),
             FaultSpec(kind="shipment_delay", op="ship", after_calls=10,
                       count=2, prob=1.0, delay_s=2.0),
             FaultSpec(kind="shipment_drop", op="ack", after_calls=3,
                       count=1, prob=1.0),
             FaultSpec(kind="prefill_kill", at_step=30)]
    by_path, out = {}, {}
    for wire, plan in (("none", None), ("int8", None), ("int4", None),
                       ("storm", FaultPlan(storm, seed=0))):
        gc.collect()
        torch.cuda.empty_cache()
        eng = ServingEngine(model, serve, device="cuda").warmup()
        coord = DisaggCoordinator(
            PrefillWorker(model, prefill_chunk=256, max_len=2048,
                          num_slots=2, sampling=True, device="cuda"),
            eng, plan=plan, ship_quant="none" if plan else wire)
        torch.cuda.reset_peak_memory_stats()
        zero_counts(kernels)
        t0 = time.perf_counter()
        res = coord.run(serving4_trace(vocab, seed),
                        on_step=lambda i: eng.scheduler.check_invariants())
        wall = time.perf_counter() - t0
        launches = read_counts(kernels)
        eng.scheduler.check_invariants()
        path = f"serving4_disagg_{wire}"
        _serving4_launches(path, launches)
        by_path[path] = launches
        s = coord.summary()
        check(len(res) == 24 and len({r.rid for r in res}) == 24,
              f"{path}: {len(res)} results")
        for r in res:
            if plan is None:
                check(r.finished_reason == "length" and len(r.tokens) == 32,
                      f"{path}: request {r.rid} {r.finished_reason}")
            if (wire in ("none", "storm")
                    and r.finished_reason == "length"):
                check(r.tokens == want[r.rid], f"{path}: request {r.rid} "
                      "differs from the colocated run")
        check(eng.pool.free_count == eng.pool.num_pages,
              f"{path}: pages leaked")
        check(coord.prefill.idle and not coord.prefill._live,
              f"{path}: the prefill tier kept a scratch")
        if plan is None:
            check(s["ship_sent"] == s["adoptions"] == coord.packs == 24
                  and s["ship_bytes"] == 24 * predicted[wire],
                  f"{path}: {s}, {coord.packs} packs")
            quant = (2 * coord.packs, 2 * coord.unpacks) \
                if wire == "int8" else (0, 0)
            check((launches["quantize_blockwise"],
                   launches["dequantize_blockwise"]) == quant,
                  f"{path}: quantize / dequantize launches "
                  f"{launches['quantize_blockwise']} / "
                  f"{launches['dequantize_blockwise']}, expected {quant}")
        else:
            check(s["ship_dropped"] >= 2 and s["ship_duped"] >= 2
                  and s["ship_dedups"] >= 1
                  and eng.registry.counter_value(
                      "serve.prefill_tier_kills") == 1,
                  f"{path}: the storm did not fire: {s}")
        ttft = [r.stats.ttft_s for r in res if r.stats.ttft_s is not None]
        out[path] = {
            "summary": s, "packs": coord.packs, "unpacks": coord.unpacks,
            "wire_bytes_per_shipment": s["ship_bytes"] / max(
                s["ship_sent"], 1),
            "ship_pack_s": _pcts(coord.ship_pack_s),
            "ship_adopt_s": _pcts(coord.ship_adopt_s),
            "ship_pack_to_adopt_s": _pcts(coord.ship_wall_s),
            "ttft_s": _pcts(ttft), "ttft_s_colocated": _pcts(
                colocated_ttft),
            "tokens_per_s": sum(len(r.tokens) for r in res) / wall,
            "run_wall_s": wall,
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "launches": launches}
        print(f"{path} " + json.dumps(out[path]))
        del coord, eng
    return by_path


def serving4_frontend_phase(model, seed, kernels, want):
    """(c): two replicas on the card share the model behind a
    `Frontend` with the free tenant capped at 3 live requests across
    both, hedging after 2 router steps, and replica 0 killed at router
    step 12 for 6 steps: the single replica's tokens, the quota held
    every step (over the requests not answered yet; the slots the
    tenant holds, hedge losers of answered requests included, are
    printed beside); then replica 0 drained (it serves nothing of 4
    more requests) and rejoined."""
    from hetu_tpu_torch.chaos.plan import FaultPlan, FaultSpec
    from hetu_tpu_torch.serving import (Frontend, ServeConfig,
                                        ServingEngine, parse_quotas)
    gc.collect()
    torch.cuda.empty_cache()
    vocab = model.config.vocab_size
    serve = ServeConfig(num_slots=8, page_size=16, max_len=2048,
                        prefill_chunk=256, sampling=True, retry_budget=2)
    engines = [ServingEngine(model, serve, device="cuda").warmup()
               for _ in range(2)]
    plan = FaultPlan([FaultSpec(kind="engine_kill", rank=0, at_step=12,
                                count=6)])
    fe = Frontend(engines, plan=plan, hedge_after=2,
                  quotas=parse_quotas("free:3"))
    live_free, held_free = [], []
    step = fe.step

    def counted(now):
        res = step(now)
        # the tenant's requests live on either replica that the fleet
        # has not answered yet: what the fleet quota bounds (a hedge's
        # two copies are one request; the losing copy of an answered
        # request runs on as discarded work, as the reference's does,
        # and is counted apart, as slots the tenant holds)
        rids = [st.request.rid for e in engines for st in e.scheduler.slots
                if st is not None and st.request.tenant == "free"]
        live_free.append(len({r for r in rids if r not in fe._finished}))
        held_free.append(len(rids))
        for e in engines:
            e.scheduler.check_invariants()
        return res
    fe.step = counted
    torch.cuda.reset_peak_memory_stats()
    zero_counts(kernels)
    t0 = time.perf_counter()
    res = fe.run(serving4_trace(vocab, seed))
    wall = time.perf_counter() - t0
    launches = read_counts(kernels)
    _serving4_launches("serving4_frontend", launches)
    check(len(res) == 24 and len({r.rid for r in res}) == 24,
          f"serving4_frontend: {len(res)} results")
    for r in res:
        check(r.finished_reason == "length" and r.tokens == want[r.rid],
              f"serving4_frontend: request {r.rid} differs from the "
              "single replica's run")
    s = fe.summary()
    check(s["reroutes"] > 0 and fe.replicas[0].kills == 1,
          f"serving4_frontend: the kill rerouted nothing: {s}")
    check(max(live_free) <= 3 and s["quota_holds"] > 0,
          f"serving4_frontend: free tenant live {max(live_free)}, "
          f"holds {s['quota_holds']}")
    fe.step = step
    fe.drain(0)
    served0 = engines[0].registry.counter_value("serve.requests_done")
    # four of the requests again under new rids (a rid answered once is
    # never answered again)
    import dataclasses
    more = fe.run([dataclasses.replace(r, rid=r.rid + 100)
                   for r in serving4_trace(vocab, seed)[:4]])
    check(engines[0].registry.counter_value("serve.requests_done")
          == served0, "serving4_frontend: the drained replica served")
    check([r.tokens for r in more] == [want[r.rid - 100] for r in more],
          "serving4_frontend: drained-fleet tokens differ")
    fe.rejoin(0)
    check(not fe.replicas[0].draining and not fe.replicas[0].down,
          "serving4_frontend: replica 0 did not rejoin")
    ttft = [r.stats.ttft_s for r in res]
    print("serving4_frontend " + json.dumps({
        "summary": s, "max_live_free": max(live_free),
        "max_slots_held_free": max(held_free),
        "ttft_s": _pcts(ttft), "tokens_per_s": sum(
            len(r.tokens) for r in res) / wall, "run_wall_s": wall,
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "launches": launches}))
    del fe, engines
    return {"serving4_frontend": launches}


def serving4_phase(seed: int, kernels, card: str):
    """Phase 17 ("serving4"): the serving host layers on Llama-3-8B at
    full width, depth cut to 8 layers (bf16 weights drawn from `seed`;
    the whole smoke's time limit), one model
    shared by every engine of the phase: (a) policies and failover, (b)
    disaggregated prefill/decode, (c) the replica frontend.  Prints its
    wall time and peak memory; returns the paths' launch counts."""
    import tempfile
    from hetu_tpu_torch.models.llama import LlamaConfig, LlamaLMHeadModel
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = LlamaLMHeadModel(LlamaConfig.llama3_8b(
        num_hidden_layers=8, param_dtype=torch.bfloat16), device="cuda",
        seed=seed)
    with tempfile.TemporaryDirectory() as tmp:
        by_path, base = serving4_policies_phase(model, seed, kernels, card,
                                                tmp)
    by_path.update(serving4_disagg_phase(model, seed, kernels, card,
                                         base["decode"], base["ttft"]))
    by_path.update(serving4_frontend_phase(model, seed, kernels,
                                           base["decode"]))
    del model
    print(f"serving4: {time.perf_counter() - t_phase:.1f}s, peak "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; {card}")
    return by_path


# ----------------------------------------------------------------- MoE
def mixtral_config(**kw):
    """Mixtral-8x7B's published widths (mistralai/Mixtral-8x7B-v0.1):
    hidden 4096, 32 layers, 32 q / 8 kv heads of 128, 8 experts, top-2,
    expert SwiGLU 14336, vocab 32000, rope_theta 1e6, 32,768 positions;
    the reference's capacity factor (1.25) and sort dispatch."""
    from hetu_tpu_torch.models.llama import LlamaConfig
    d = dict(vocab_size=32000, hidden_size=4096, intermediate_size=14336,
             num_hidden_layers=32, num_attention_heads=32,
             num_key_value_heads=8, max_position_embeddings=32768,
             rope_theta=1e6, num_experts=8, moe_top_k=2)
    d.update(kw)
    return LlamaConfig(**d)


def active_params(cfg) -> int:
    """The parameters a token runs through: attention, norms, the router
    and top-k of the E experts a layer, and the embedding and head (the
    reference's `num_params` counts all E experts)."""
    h, i, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
    kvh = cfg.num_key_value_heads * cfg.head_dim
    per_layer = (h * (h + 2 * kvh + h) + 2 * h + h * cfg.num_experts
                 + 3 * h * i * cfg.moe_top_k)
    emb = cfg.vocab_size * h * (1 if cfg.tie_word_embeddings else 2)
    return L * per_layer + emb + h


class RoutingProbe:
    """Within it, each MoE layer call's router logits and routing plan
    (`nn.moe.select_experts`, `nn.moe.sort_routing`) are kept, on the
    host, in call order."""

    def __enter__(self):
        from hetu_tpu_torch.nn import moe
        self.moe, self.calls = moe, []
        self._sel, self._sort = moe.select_experts, moe.sort_routing

        def select(logits, ids, cfg):
            self.calls.append({"logits": logits.detach().float().cpu(),
                               "cfg": cfg})
            return self._sel(logits, ids, cfg)

        def sort(*args):
            plan = self._sort(*args)
            self.calls[-1]["plan"] = {k: plan[k].cpu() for k in (
                "dest", "tok", "keep", "load", "dropped")}
            return plan
        moe.select_experts, moe.sort_routing = select, sort
        return self

    def __exit__(self, *exc):
        self.moe.select_experts, self.moe.sort_routing = self._sel, \
            self._sort


def near_ties(logits, cfg, tol: float = 1e-6) -> int:
    """Rows whose expert choice rests on a margin under `tol`: the gap
    between the k-th and (k+1)-th of the score the gate ranks (the
    router probabilities; the Sinkhorn plan for "balance"; the group
    mass, then the in-group probabilities, for "sam"; "ktop1" ranks the
    probabilities left after each pick, whose order is theirs)."""
    from hetu_tpu_torch.nn import moe
    if cfg.gate == "hash":
        return 0
    k = max(cfg.top_k, 1) if cfg.gate != "top1" else 1
    probs = torch.softmax(logits.float(), dim=-1)

    def gap(score, kk):
        top = torch.topk(score, min(kk + 1, score.shape[-1]), dim=-1).values
        return top[:, kk - 1] - top[:, kk]
    if cfg.gate == "balance":
        g = gap(moe._sinkhorn(logits.float(), cfg.sinkhorn_iters), k)
    elif cfg.gate == "sam":
        gs = cfg.resolved_sam_group_size()
        grouped = probs.reshape(probs.shape[0], -1, gs)
        g = torch.minimum(gap(grouped.sum(-1), 1), gap(grouped.amax(1), k))
    else:
        g = gap(probs, k)
    return int((g.abs() < tol).sum())


def moe_reference_phase(seed: int, card: str):
    """Phase 18 (a): a narrow MoE Llama (2 layers, hidden 256, 2 q / 1
    kv heads of 128, 8 experts, top-2, expert SwiGLU 512, vocab 32000,
    fp32, capacity factor 0.5: pairs drop) on the card and on the CPU
    from one set of weights, for each gate: the training forward's
    logits within 1e-4 and every layer's routing plan (dest, tok, keep,
    load, dropped) equal, the serving engine's greedy tokens equal
    (requests queued at 0; chunks of 64 drop pairs).  A plan that
    differs must hold a counted near-tie (a gate margin under 1e-6),
    and then its gate's later checks are skipped and counted."""
    from hetu_tpu_torch.models.llama import LlamaConfig, LlamaLMHeadModel
    from hetu_tpu_torch.nn.moe import GATES
    from hetu_tpu_torch.serving import (ServeConfig, ServingEngine,
                                        synthetic_requests)
    t0 = time.perf_counter()
    out = {}
    for gate in GATES:
        cfg = LlamaConfig(
            vocab_size=32000, hidden_size=256, intermediate_size=512,
            num_hidden_layers=2, num_attention_heads=2,
            num_key_value_heads=1, max_position_embeddings=512,
            rope_theta=1e6, num_experts=8, moe_top_k=2,
            moe_capacity_factor=0.5, moe_gate=gate,
            moe_sam_group_size=4 if gate == "sam" else 0,
            compute_dtype=torch.float32, use_flash_attention=False)
        gcard = LlamaLMHeadModel(cfg, device="cuda", seed=seed)
        gcpu = LlamaLMHeadModel(cfg, device="cpu", seed=seed)
        gcpu.load_state_dict({k: v.cpu()
                              for k, v in gcard.state_dict().items()})
        ids = np.random.default_rng(seed + 18).integers(0, 32000, (2, 64))
        logits, probes = [], []
        for model, dev in ((gcard, "cuda"), (gcpu, "cpu")):
            with RoutingProbe() as probe, torch.no_grad():
                logits.append(model(torch.as_tensor(ids, device=dev)).cpu())
            probes.append(probe.calls)
        diff_calls, ties = 0, 0
        for c_card, c_cpu in zip(*probes):
            ties += near_ties(c_cpu["logits"], c_cpu["cfg"])
            if any(not torch.equal(c_card["plan"][k].long(),
                                   c_cpu["plan"][k].long())
                   for k in c_cpu["plan"]):
                diff_calls += 1
        check(len(probes[0]) == len(probes[1]) == cfg.num_hidden_layers,
              f"{gate}: {len(probes[0])} routed calls")
        dropped = sum(int(c["plan"]["dropped"]) for c in probes[1])
        check(diff_calls == 0 or ties > 0,
              f"moe reference {gate}: {diff_calls} plans differ without a "
              "near-tie")
        res = {"plans_equal": diff_calls == 0, "near_ties": ties,
               "pairs_dropped": dropped}
        if diff_calls == 0:
            err = (logits[0] - logits[1]).abs().max().item()
            check(bool(torch.isfinite(logits[0]).all()), "non-finite logits")
            check(err <= 1e-4, f"moe reference {gate}: card vs CPU logits "
                               f"differ by {err}")
            tokens = []
            for model, dev in ((gcard, "cuda"), (gcpu, "cpu")):
                reqs = synthetic_requests(3, vocab_size=32000,
                                          prompt_lens=(40, 120),
                                          max_new=(6, 6), seed=seed)
                eng = ServingEngine(model, ServeConfig(
                    num_slots=3, page_size=16, max_len=256,
                    prefill_chunk=64), device=dev)
                tokens.append([r.tokens for r in eng.run(reqs)])
            check(tokens[0] == tokens[1],
                  f"moe reference {gate}: card vs CPU tokens {tokens}")
            res.update(logits_max_abs_err=err, tokens_equal=True)
        out[gate] = res
        del gcard, gcpu
    check(all(r["pairs_dropped"] > 0 for r in out.values()),
          "the narrow check drops no pair")
    print(f"moe reference: hidden 256, 2 layers, 8 experts top-2, fp32, "
          f"capacity factor 0.5, card vs CPU per gate " + json.dumps(out)
          + f" ({time.perf_counter() - t0:.1f}s); {card}")


class VerifyDrops:
    """On engine `eng`, each verify step's MoE layer calls: the slots
    whose rows lost a (token, expert) pair to capacity, mapped to the
    requests then decoding there and their tokens so far.  `first` maps
    a rid to the fewest tokens it had emitted when a verify step first
    dropped one of its pairs."""

    def __init__(self, eng):
        self.eng, self.records, self.first = eng, [], {}

    def __enter__(self):
        from hetu_tpu_torch.nn import moe
        self.moe, self._sort = moe, moe.sort_routing
        eng, verify = self.eng, self.eng._verify
        state = {"slots": None}
        C = eng.config.spec_k + 1

        def traced_verify(table, tokens, positions, active, *a, **kw):
            state["slots"] = {i: (eng.scheduler.slots[i].request.rid,
                                  len(eng.scheduler.slots[i].generated))
                              for i in active}
            try:
                return verify(table, tokens, positions, active, *a, **kw)
            finally:
                state["slots"] = None

        def sort(*args):
            plan = self._sort(*args)
            if state["slots"] is not None:
                self.records.append((state["slots"], plan["tok"],
                                     plan["keep"]))
            return plan
        self._verify = verify
        eng._verify, moe.sort_routing = traced_verify, sort
        self.C = C
        return self

    def __exit__(self, *exc):
        self.moe.sort_routing = self._sort
        del self.eng._verify
        self.drops = 0
        for slots, tok, keep in self.records:
            rows = tok[~keep].cpu().tolist()
            self.drops += len(rows)
            for r in rows:
                hit = slots.get(r // self.C)
                if hit is not None:
                    rid, n = hit
                    self.first[rid] = min(self.first.get(rid, n), n)


def _first_divergence(a, b):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                None if len(a) == len(b) else min(len(a), len(b)))


def moe_step_times(eng, reqs):
    """One decode step over 8 slots at the trace's depths with the
    engine's experts bound: host enqueue, wall, the device's busy time
    and idle share under torch.profiler, the dequantize kernel's share
    of busy and the heaviest kernels."""
    from hetu_tpu_torch.models.generation import decode_step_paged
    model, S = eng.model, eng.config.num_slots
    mp = eng.scheduler.max_pages
    depths = [r.prompt_len + 16 for r in reqs][:S]
    table = torch.zeros((S, mp), dtype=torch.int32, device="cuda")
    for s, d in enumerate(depths):
        n = d // eng.config.page_size + 1
        table[s, :n] = torch.arange(1 + s * mp, 1 + s * mp + n)
    pos = np.asarray(depths, np.int32)
    tok = torch.zeros(S, dtype=torch.int32, device="cuda")

    def step():
        with eng._experts():
            return decode_step_paged(model, tok, eng.pool.k, eng.pool.v,
                                     table, pos)[0]
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        step()
    enqueue = (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / reps
    counts = {}
    busy, _, by_name, top = _profile(step, 3, counts=counts)
    dq = sum(t for n, t in by_name.items() if "dequant" in n)
    return {"host_enqueue_ms": enqueue * 1e3, "wall_ms": wall * 1e3,
            "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / (wall * 1e3),
            "dequantize_ms": dq, "dequantize_share_of_busy": dq / busy,
            "device_ops_per_step": round(sum(counts.values())),
            "top_kernels_ms": top}


def moe_serving_phase(seed: int, kernels, card: str):
    """Phase 18 (b): Mixtral-8x7B widths cut to 12 layers, bf16 weights
    drawn on the card, `ServeConfig(8, page_size=16, max_len=2048,
    prefill_chunk=256, sampling=True)`, phase 5's trace with the odd
    requests sampled (0.8, top-k 50, top-p 0.95): experts as they are
    ("gspmd"), resident int8, resident int4, then int8 with n-gram
    speculation (spec_k 4).  Exact launch counts per run (the quantize
    2 x layers at build; the dequantize 2 x layers a forward under
    int8/int4; SwiGLU layers a forward).  The int8 and int4 tokens must
    equal those of the model whose experts hold the dequantized values
    ("gspmd" on them: the reference's contract, generate() on the
    dequantized weights); the speculative run's tokens equal the int8
    run's, but where a verify step (40 rows, capacity 16) dropped one of
    the request's pairs at or before its first difference.  TTFT,
    decode step p50, tokens/s, peak memory, and a decode step's device
    work against its host enqueue (gspmd, int8, int4).  Returns the
    runs' launches."""
    from hetu_tpu_torch.models.llama import LlamaLMHeadModel
    from hetu_tpu_torch.serving import (SamplingParams, ServeConfig,
                                        ServingEngine, poisson_arrivals,
                                        synthetic_requests)
    from hetu_tpu_torch.serving import experts as ex
    cfg = mixtral_config(num_hidden_layers=12, param_dtype=torch.bfloat16)
    L = cfg.num_hidden_layers
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = LlamaLMHeadModel(cfg, device="cuda", seed=seed)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == cfg.num_params() + L * cfg.hidden_size * 8,
          f"parameter count {n_params}")
    print(f"moe serving: Mixtral-8x7B widths, {L} layers, "
          f"{n_params / 1e9:.3f}B params bf16 "
          f"({torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB), drawn in "
          f"{time.perf_counter() - t_phase:.1f}s")

    def trace():
        reqs = synthetic_requests(
            8, vocab_size=cfg.vocab_size, prompt_lens=(64, 1024),
            max_new=(32, 32), arrivals=poisson_arrivals(8, 10.0, seed=seed),
            seed=seed)
        for r in reqs[1::2]:
            r.sampling = SamplingParams(temperature=0.8, top_k=50,
                                        top_p=0.95, seed=seed + 100 + r.rid)
        return reqs

    by_path, tokens, stores, times, peaks = {}, {}, {}, {}, []

    def serve(path, dispatch, spec=False, timed=False, keep_store=False):
        gc.collect()
        torch.cuda.empty_cache()
        opts = dict(spec_decode="ngram", spec_k=4) if spec else {}
        serve_cfg = ServeConfig(num_slots=8, page_size=16, max_len=2048,
                                prefill_chunk=256, sampling=True,
                                moe_dispatch=dispatch, **opts)
        zero_counts(kernels)
        t0 = time.perf_counter()
        eng = ServingEngine(model, serve_cfg, device="cuda")
        build_s = time.perf_counter() - t0
        built = read_counts(kernels)
        quantized = dispatch in ("int8", "int4")
        check(built["quantize_blockwise"] == (2 * L if quantized else 0)
              and sum(built.values()) == built["quantize_blockwise"],
              f"{path}: build launches {built}")
        if quantized:                   # the store's quantize, at build
            by_path[f"{path}_build"] = built
        eng.warmup()
        reqs = trace()
        torch.cuda.reset_peak_memory_stats()
        zero_counts(kernels)
        probe = VerifyDrops(eng) if spec else contextlib.nullcontext()
        t0 = time.perf_counter()
        with probe:
            results = eng.run(reqs)
        wall = time.perf_counter() - t0
        launches = read_counts(kernels)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        peaks.append(peak)
        for r in results:
            check(r.finished_reason == "length" and len(r.tokens) == 32,
                  f"{path}: request {r.rid}: {r.finished_reason}, "
                  f"{len(r.tokens)} tokens")
            check(all(0 <= t < cfg.vocab_size for t in r.tokens),
                  f"{path}: request {r.rid}: token out of the vocabulary")
        eng.scheduler.check_invariants()
        check(eng.pool.free_count == eng.pool.num_pages,
              f"{path}: pages leaked")
        reg = eng.registry
        steps = int(reg.counter_value("serve.decode_steps"))
        chunks = int(reg.counter_value("serve.prefill_chunks"))
        sampled = sum(not r.sampling.greedy for r in reqs)
        fwd = steps + chunks
        expect = {name: 0 for name in kernels}
        expect.update(fused_rotary_qk=fwd * L, fused_swiglu=fwd * L,
                      kv_write_tokens=steps * L, kv_write_pages=len(reqs),
                      dequantize_blockwise=2 * L * fwd if quantized else 0)
        if spec:
            expect.update(paged_verify=steps * L, fused_sample=steps,
                          sample_logits=sampled)
        else:
            expect.update(paged_attention=steps * L,
                          sample_logits=steps + sampled)
        check(launches == expect, f"{path}: launches {launches}, expected "
                                  f"{expect}")
        ttft = sorted(r.stats.ttft_s for r in results)
        gap = reg.histogram("serve.token_latency_s")
        tokens_out = sum(len(r.tokens) for r in results)
        out = {"moe_dispatch": dispatch, "spec": spec,
               "requests": len(results), "sampled_requests": sampled,
               "decode_steps": steps, "prefill_chunks": chunks,
               "ttft_s_p50": ttft[len(ttft) // 2], "ttft_s_max": ttft[-1],
               "decode_step_s_p50": gap.percentile(50),
               "decode_step_s_max": gap.vmax,
               "tokens_per_s": tokens_out / wall, "run_wall_s": wall,
               "build_s": build_s, "peak_memory_gib": peak,
               "launches_at_build": {k: n for k, n in built.items() if n},
               "launches": {k: n for k, n in launches.items() if n}}
        if quantized:
            out["expert_bytes"] = reg.gauge_value("serve.moe_expert_bytes")
            out["expert_bytes_fp"] = reg.gauge_value(
                "serve.moe_expert_bytes_fp")
        if spec:
            out.update(verify_pairs_dropped=probe.drops,
                       requests_dropped_in_verify=len(probe.first))
            out["first_drop"] = probe.first
        tokens[path] = [r.tokens for r in results]
        if timed:
            times[path] = out["decode_step_device"] = moe_step_times(eng,
                                                                     reqs)
        if keep_store:
            stores[dispatch] = (eng.moe_store, eng.moe_spec)
        print(f"moe {path} " + json.dumps(out))
        by_path[path] = launches
        del eng
        return out

    serve("moe_serving", "gspmd", timed=True)
    serve("moe_serving_int8", "int8", timed=True)
    serve("moe_serving_int4", "int4", timed=True)
    spec_out = serve("moe_serving_spec_int8", "int8", spec=True,
                     keep_store=True)
    # speculation leaves the tokens as they were, but where a verify
    # step's capacity dropped one of the request's pairs first
    parted = {}
    for rid, (a, b) in enumerate(zip(tokens["moe_serving_spec_int8"],
                                     tokens["moe_serving_int8"])):
        d = _first_divergence(a, b)
        if d is not None:
            first = spec_out["first_drop"].get(rid)
            check(first is not None and first <= d,
                  f"speculation changed request {rid}'s tokens at {d} "
                  f"without a verify-step capacity drop before it")
            parted[rid] = (d, first)
    print(f"moe speculation: {8 - len(parted)} of 8 requests' tokens equal "
          f"to the int8 run's; parted after a verify step dropped their "
          f"pairs (rid: (first difference, tokens out at the first drop)) "
          f"{parted}")
    # generate() on the dequantized weights: the model's experts take
    # the dequantized values and serve as they are
    stores["int4"] = ex.quantize_expert_tree(model, bits=4)
    peaks.append(torch.cuda.max_memory_allocated() / 2 ** 30)  # both stores
    for bits in ("int8", "int4"):
        store, spec = stores.pop(bits)
        with torch.no_grad():
            for key, meta in spec.items():
                model.get_parameter(key).copy_(
                    ex.dequantize_leaf(store[key], meta))
        del store
        path = f"moe_serving_dequantized_{bits}"
        serve(path, "gspmd")
        check(tokens[path] == tokens[f"moe_serving_{bits}"],
              f"{bits} experts: tokens differ from the dequantized model's")
        print(f"moe {bits}: tokens equal to the dequantized weights' "
              f"served as they are")
    del model
    b, q8, q4 = (times[p]["device_busy_ms"] for p in (
        "moe_serving", "moe_serving_int8", "moe_serving_int4"))
    print(f"moe serving: decode step device busy bf16 {b:.3f} ms, int8 "
          f"{q8:.3f} ms ({q8 / b:.2f}x), int4 {q4:.3f} ms ({q4 / b:.2f}x); "
          f"phase (b) {time.perf_counter() - t_phase:.1f}s, peak of the "
          f"runs {max(peaks):.2f} GiB; {card}")
    return by_path


def moe_training_phase(seed: int, kernels, card: str):
    """Phase 18 (c): Mixtral-8x7B widths cut to 2 layers, bf16 parameters
    (fp32 accumulators and AdamW moments), flash, "dots_attn",
    `TrainingConfig(8, 2, 2048)`, 4 steps: exact launch counts a step
    (the post norm 4 times a layer and micro-batch — the router's
    segment and the experts' each run it and run it again in the
    backward — its backward twice; RoPE and SwiGLU forwards twice, their
    backwards and flash once; AdamW twice, once on its bf16 arm and once
    on its fp32 arm for the routers, fp32 as the reference's), phase 8's loss
    checks, peak memory at most 70 GiB, step p50, tokens/s, and mfu over
    the active parameters (attention, router, top-2 of 8 experts; the
    capacity padding not counted) beside the reference's
    `flops_per_token`, which counts all 8 experts."""
    from hetu_tpu_torch.engine import Trainer, TrainingConfig
    from hetu_tpu_torch.models.llama import LlamaLMHeadModel
    from hetu_tpu_torch.ops.cuda import adam as ad
    t_phase = time.perf_counter()
    gbs, mbs, seq, steps = 8, 2, 2048, 4
    cfg = mixtral_config(num_hidden_layers=2, param_dtype=torch.bfloat16,
                         remat_policy="dots_attn")
    L, n_micro = cfg.num_hidden_layers, gbs // mbs
    per = L * n_micro
    per_step = {name: 0 for name in kernels}
    per_step.update(residual_rmsnorm_fwd=4 * per,
                    residual_rmsnorm_bwd=2 * per, fused_rotary_qk=2 * per,
                    rotary_qk_bwd=per, fused_swiglu=2 * per, swiglu_bwd=per,
                    flash_fwd=per, flash_bwd_dq=per, flash_bwd_dkv=per,
                    adam_update=2)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = LlamaLMHeadModel(cfg, device="cuda", seed=seed)
    tr = Trainer(model, TrainingConfig(
        global_batch_size=gbs, micro_batch_size=mbs, seq_len=seq, lr=1e-3,
        warmup_steps=2, total_steps=1000, log_every=1),
        device="cuda").build()
    n_params = sum(p.numel() for p in tr.params)
    batch = _train_batch(cfg.vocab_size, gbs, seq, seed)
    zero_counts(kernels)
    launches = {name: 0 for name in kernels}
    losses, times = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        metrics = tr.train([batch], num_steps=1)
        times.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        counts = read_counts(kernels)
        check(counts == per_step, f"moe training step {i + 1} launches "
                                  f"{counts}, expected {per_step}")
        arms = ad.arm_launches["launches"]
        check(arms == {"f32": 1, "bf16": 1, "f16": 0},
              f"moe training step {i + 1}: AdamW arms {arms}")
        for a, n in arms.items():
            ADAM_ARMS[a] += n
        for k, n in counts.items():
            launches[k] += n
        zero_counts(kernels)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    sigma = cfg.initializer_range * math.sqrt(cfg.hidden_size)
    expect_first = math.log(cfg.vocab_size) + sigma ** 2 / 2
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    check(abs(losses[0] - expect_first) <= 0.5,
          f"first loss {losses[0]} is not within 0.5 of {expect_first}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    check(peak <= TRAIN_PEAK_GIB, f"peak {peak:.2f} GiB past "
                                  f"{TRAIN_PEAK_GIB} GiB")
    tokens = gbs * seq
    p50 = float(np.median(times))
    attn = 12 * L * cfg.hidden_size * seq
    active_flops = (6.0 * active_params(cfg) + attn) * tokens
    print("moe training " + json.dumps({
        "model": "Mixtral-8x7B widths", "layers": L, "params": n_params,
        "active_params": active_params(cfg), "param_dtype": "bf16",
        "remat_policy": "dots_attn", "micro_batch": mbs,
        "micro_batches": n_micro, "seq_len": seq, "losses": losses,
        "expected_first_loss": expect_first, "step_s": times,
        "step_s_p50": p50, "tokens_per_s": tokens / p50,
        "mfu_active": active_flops / p50 / PEAK_OPS_PER_S[torch.bfloat16],
        # the reference's flops_per_token counts all 8 experts: it
        # overstates an MoE step's work (here by its ratio to the above)
        "mfu_reference_flops_per_token": cfg.flops_per_token(seq) * tokens
        / p50 / PEAK_OPS_PER_S[torch.bfloat16],
        "peak_memory_gib": peak, "launches_per_step": {
            k: n for k, n in per_step.items() if n},
        "phase_s": time.perf_counter() - t_phase, "card": card}))
    del tr, model
    return {"moe_training": launches}


def moe_kernel_phase(seed: int):
    """Phase 18 (d): each kernel the MoE paths launch, at its MoE shape,
    bf16, against its plain version, timed as phase 3 times them:
    SwiGLU over the expert buffers [E x C, 14336] (decode C = 8, a
    256-token chunk C = 80, a training micro-batch of 2 x 2048 C = 1280)
    and its backward at the training shape; the quantize of a layer's
    expert leaves at block 256, w_gate_up [3,670,016, 256] and w_down
    [1,835,008, 256], to int8 and to the int4 grid (payload bit for bit,
    scales within one fp32 ulp); the dequantize of the same payloads to
    bf16 (bit for bit; int4 values unpacked first), beside PyTorch's
    per-channel qint8 `dequantize` (a yardstick, between CUDA events)."""
    from hetu_tpu_torch.ops.cuda import quant as qu
    from hetu_tpu_torch.ops.cuda import swiglu as sw
    g = torch.Generator(device="cuda").manual_seed(seed + 180)
    out = {"fused_swiglu": [], "swiglu_bwd": [], "quantize_blockwise": [],
           "dequantize_blockwise": []}
    inter = 14336
    for rows, inner in ((64, 20), (640, 20), (10240, 4)):
        gu = torch.randn((rows, 2, inter), generator=g,
                         device="cuda").bfloat16()
        n = rows * inter
        out["fused_swiglu"].append(case(
            f"fused_swiglu [{rows},{inter}] bf16 (MoE experts)", ulps(1),
            lambda i, gu=gu: sw.fused_swiglu(gu),
            lambda i, gu=gu: sw.swiglu_plain(gu[:, 0], gu[:, 1]),
            3 * n * 2, 5 * n, composition=swiglu_composition(gu),
            inner=inner))
        if rows == 10240:
            dy = torch.randn((rows, inter), generator=g,
                             device="cuda").bfloat16()
            out["swiglu_bwd"].append(case(
                f"swiglu_bwd [{rows},{inter}] bf16 (MoE experts)", ulps(1),
                lambda i: sw.swiglu_bwd(gu, dy),
                lambda i: torch.stack(sw.swiglu_bwd_plain(
                    gu[:, 0], gu[:, 1], dy), dim=-2),
                5 * n * 2, 12 * n, inner=inner,
                composition_ms=swiglu_bwd_composition_ms(gu, dy)))
            del dy
        del gu
    for name, nb in (("w_gate_up", 3670016), ("w_down", 1835008)):
        x = (0.02 * torch.randn((nb, 256), generator=g,
                                device="cuda")).bfloat16()
        n = x.numel()
        payloads = {}
        for bits in (8, 4):
            out["quantize_blockwise"].append(case(
                f"quantize_blockwise {name} [{nb},256] bf16 -> int{bits}",
                (same(), fp32_ulps(1)),
                lambda i, x=x, bits=bits: qu.quantize_blockwise(
                    x, 256, bits=bits),
                lambda i, x=x, bits=bits: qu.quantize_blockwise_plain(
                    x, 256, bits),
                n * 2 + n + nb * 4, 4 * n, inner=2))
            payloads[bits] = qu.quantize_blockwise(x, 256, bits=bits)
            gc.collect()
            torch.cuda.empty_cache()
        del x
        for bits, (q, s) in payloads.items():
            if bits == 4 and name == "w_down":
                continue            # the kernel as at w_gate_up's
            qt = torch._make_per_channel_quantized_tensor(
                q, s.double(), torch.zeros(nb, dtype=torch.long,
                                           device="cuda"), 0)
            out["dequantize_blockwise"].append(case(
                f"dequantize_blockwise {name} q [{nb},256] int{bits} "
                f"values -> bf16", same(),
                lambda i, q=q, s=s: qu.dequantize_blockwise(
                    q, s, out_dtype=torch.bfloat16),
                lambda i, q=q, s=s: qu.dequantize_blockwise_plain(
                    q, s).bfloat16(),
                n + 4 * nb + 2 * n, n, inner=2,
                library_ms=event_ms(
                    lambda qt=qt: qt.dequantize().bfloat16(), reps=5)))
            del qt
        del payloads
        gc.collect()
        torch.cuda.empty_cache()
    return out


def moe_phase(seed: int, kernels, card: str):
    """Phase 18 ("moe"): (a) card vs CPU per gate, (b) serving and (c)
    training at Mixtral-8x7B widths, (d) the kernels at the MoE shapes.
    Returns ({path: launches}, {kernel: cases})."""
    t0 = time.perf_counter()
    moe_reference_phase(seed, card)
    gc.collect()
    torch.cuda.empty_cache()
    by_path = moe_serving_phase(seed, kernels, card)
    gc.collect()
    torch.cuda.empty_cache()
    by_path.update(moe_training_phase(seed, kernels, card))
    gc.collect()
    torch.cuda.empty_cache()
    cases = moe_kernel_phase(seed)
    print(f"moe: {time.perf_counter() - t0:.1f}s; {card}")
    return by_path, cases


# ------------------------------------------------------- serving fp16
#: the serving kernels whose fp16 arms phase 19 ("serving_fp16") checks
#: at Llama-2-7B's shapes and drives on its paths
F16_SERVING = ("paged_attention", "paged_attention_int8",
               "paged_attention_int4", "paged_verify", "kv_write_tokens",
               "kv_write_pages", "fused_sample", "sample_logits",
               "quantize_blockwise", "dequantize_blockwise")


def llama2_config(**kw):
    """Meta's Llama-2-7B as published (meta-llama/Llama-2-7b-hf: hidden
    4096, 32 layers, 32 q / 32 kv heads of 128, SwiGLU 11008, vocab
    32000, rope theta 10000, `torch_dtype: float16`): fp16 parameters
    and compute."""
    from hetu_tpu_torch.models.llama import LlamaConfig
    return LlamaConfig.llama2_7b(**{"param_dtype": torch.float16,
                                    "compute_dtype": torch.float16, **kw})


def tinyllama_config():
    """The draft: TinyLlama-1.1B's published widths (TinyLlama/TinyLlama-
    1.1B-intermediate-step-1431k-3T: hidden 2048, 22 layers, 32 q / 4 kv
    heads of 64, SwiGLU 5632, vocab 32000, untied head), fp16."""
    from hetu_tpu_torch.models.llama import LlamaConfig
    return LlamaConfig(vocab_size=32000, hidden_size=2048,
                       intermediate_size=5632, num_hidden_layers=22,
                       num_attention_heads=32, num_key_value_heads=4,
                       max_position_embeddings=2048,
                       param_dtype=torch.float16,
                       compute_dtype=torch.float16)


def _beside_bf16(res, bf16_ms):
    """A fp16 case with its bf16 arm's time on the same work, this call."""
    res["bf16_ms"] = bf16_ms
    print(f"  {res['case'][:60]}: fp16 {res['ms']:.5f} ms, bf16 "
          f"{bf16_ms:.5f} ms, ratio {res['ms'] / bf16_ms:.3f}")
    return res


def serving_fp16_kernel_phase(seed: int):
    """Every fp16 arm of the serving kernels at Llama-2-7B's shapes, each
    against its plain version on the card and timed beside it, its bound
    and its library call, and beside its bf16 arm on the same work (16-bit
    both: the same bytes): paged decode q [8, 32, 128] and verify
    [8, 5, 32, 128] over 32 kv heads at depths 40-1,100 in the three page
    modes (o within one fp16 ulp + 1e-5 of the plain version; two runs
    the same bits); `write_kv_tokens` [8, 1 | 5, 32, 128] and
    `write_kv_pages` (32 layers x 1,024 of 2,048 positions) bit for bit;
    the product + draw at hidden [40, 4096] x head [4096, 32000] (N-major,
    library `torch.mm` in fp16 with fp32 out) and GPT's tied [1280, 50257]
    (K-major), the draw alone over fp16 logits [8 | 40, 32000]; the
    quantize and dequantize (fp16 out) at the draft's matrices (TinyLlama's
    embedding [32000 x 2048] and w_down [5632 x 2048] at block 128) bit
    for bit."""
    from hetu_tpu_torch.ops.cuda import paged_attention as pa
    from hetu_tpu_torch.ops.cuda import quant as qu
    from hetu_tpu_torch.ops.cuda import sample as sa
    f16 = torch.float16
    out = {f"{name}_f16": [] for name in F16_SERVING}
    scale = 128 ** -0.5
    for quant, C in (("none", 1), ("int8", 1), ("int4", 1), ("none", 5),
                     ("int8", 5), ("int4", 5)):
        q, pools, table, pos, nbytes, ops = serving_pages(
            seed + 40 + C, quant, C, 4, nq=32, n_kv=32, dtype=f16)
        name = ("paged_verify" if C > 1 else "paged_attention"
                if quant == "none" else f"paged_attention_{quant}")
        fn = pa.paged_verify if C > 1 else pa.paged_attention
        plain_fn = pa.paged_verify_plain if C > 1 else \
            pa.paged_attention_plain
        qq = q if C > 1 else q[:, 0]
        label = (f"{name} {quant} pages q=[8,{C},32,128] n_kv=32 ps=16 "
                 f"mp=128 fp16 (Llama-2-7B)")

        def run(i, qq=qq, pools=pools, quant=quant, fn=fn, table=table,
                pos=pos):
            k, v, ks, vs = pools[i % len(pools)]
            return fn(qq, k, v, table, pos, softmax_scale=scale,
                      k_scale=ks, v_scale=vs, quant=quant)

        def plain(i, qq=qq, pools=pools, quant=quant, plain_fn=plain_fn,
                  table=table, pos=pos):
            k, v, ks, vs = pools[i % len(pools)]
            return plain_fn(qq, k, v, table, pos, scale, ks, vs, quant)
        same_bits(label, run)
        res = case(label, ulps(1, 1e-5, f16), run, plain, nbytes, ops,
                   op_dtype=f16)
        bpools = [(k.bfloat16() if quant == "none" else k,
                   v.bfloat16() if quant == "none" else v, ks, vs)
                  for k, v, ks, vs in pools]
        out[f"{name}_f16"].append(_beside_bf16(res, device_ms(
            lambda it=iter(range(10 ** 6)), qb=qq.bfloat16(): run(
                next(it), qb, bpools))))
        del pools, bpools
    gc.collect()
    torch.cuda.empty_cache()
    # the page write: a decode and a verify step's layer, a prefill
    modes = [(quant, C) for C in (1, 5) for quant in ("none", "int8",
                                                      "int4")]
    kw = dict(n_kv=32, hd=128, group=1)
    out["kv_write_tokens_f16"] = [
        _beside_bf16(a, b["ms"]) for a, b in zip(
            kv_token_cases(seed + 50, modes, dtype=f16, **kw),
            kv_token_cases(seed + 50, modes, **kw))]
    kw = dict(layers=32, tokens=1024, max_len=2048, n_kv=32, hd=128)
    out["kv_write_pages_f16"] = [
        _beside_bf16(a, b["ms"]) for a, b in zip(
            kv_pages_cases(seed + 51, ("none", "int8", "int4"), dtype=f16,
                           **kw),
            kv_pages_cases(seed + 51, ("none", "int8", "int4"), **kw))]
    gc.collect()
    torch.cuda.empty_cache()
    # the sampler: Llama-2's [H, V] head and GPT's tied table's view
    g = torch.Generator(device="cuda").manual_seed(seed + 52)
    for head, text in (
            ((0.02 * torch.randn((4096, 32000), generator=g,
                                 device="cuda")).half(),
             "[4096,32000] (Llama-2-7B)"),
            ((0.02 * torch.randn((50257, 1280), generator=g,
                                 device="cuda")).half().t(),
             "[1280,50257] (GPT's tied wte.t())")):
        fused, product = sampler_cases(g, seed, head, text)
        R = 40
        hb = torch.randn((R, head.shape[0]), generator=g,
                         device="cuda").bfloat16()
        wb = head.bfloat16() if head.is_contiguous() else \
            head.t().bfloat16().t()
        temps, top_ks, top_ps, words = _sampler_rows(seed, R, head.shape[1])
        args = (words, temps, top_ks, top_ps)
        out["fused_sample_f16"] += [
            _beside_bf16(fused, device_ms(
                lambda: sa.fused_sample(hb, wb, *args), 2)),
            _beside_bf16(product, device_ms(
                lambda: sa.lm_head_logits(hb, wb), 2))]
        del head, hb, wb
    V = 32000
    for rows in (8, 40):
        temps, top_ks, top_ps, words = _sampler_rows(seed, 40, V)
        lg = (4.0 * torch.randn((rows, V), generator=g, device="cuda")).half()
        args = tuple(t[:rows] for t in (words, temps, top_ks, top_ps))
        label = f"sample_logits logits [{rows},{V}] fp16 (Llama-2-7B)"
        same_bits(label, lambda i, lg=lg, args=args: sa.sample_logits(
            lg, *args))
        res = case(label, same(),
                   lambda i, lg=lg, args=args: sa.sample_logits(lg, *args),
                   lambda i, lg=lg, args=args: sa.sample_plain(lg, *args),
                   rows * V * 2 + rows * 4 * 5, rows * V * 4)
        out["sample_logits_f16"].append(_beside_bf16(res, device_ms(
            lambda lb=lg.bfloat16(), args=args: sa.sample_logits(lb,
                                                                 *args))))
    # the draft's matrices: quantized once at load, dequantized to fp16
    # every draft forward
    for nb, what in ((32000 * 2048 // 128, "the draft's embedding"),
                     (5632 * 2048 // 128, "the draft's w_down")):
        x = (0.02 * torch.randn((nb, 128), generator=g,
                                device="cuda")).half()
        n = nb * 128
        inner = 2 if nb > 100000 else 20
        res = case(f"quantize_blockwise [{nb},128] fp16 -> int8 ({what})",
                   (same(), same()),
                   lambda i, x=x: qu.quantize_blockwise(x, 128),
                   lambda i, x=x: qu.quantize_blockwise_plain(x, 128),
                   n * 2 + n + nb * 4, 4 * n, inner=inner)
        xb = x.bfloat16()
        out["quantize_blockwise_f16"].append(_beside_bf16(res, device_ms(
            lambda: qu.quantize_blockwise(xb, 128), inner)))
        q, s = qu.quantize_blockwise(x, 128)
        del x, xb
        qt = torch._make_per_channel_quantized_tensor(
            q, s.double(), torch.zeros(nb, dtype=torch.long,
                                       device="cuda"), 0)
        res = case(f"dequantize_blockwise q [{nb},128] int8 -> fp16 "
                   f"({what})", same(),
                   lambda i, q=q, s=s: qu.dequantize_blockwise(
                       q, s, out_dtype=f16),
                   lambda i, q=q, s=s: qu.dequantize_blockwise_plain(
                       q, s).half(),
                   n + 4 * nb + 2 * n, n, inner=inner,
                   library_ms=event_ms(lambda qt=qt: qt.dequantize().half(),
                                       reps=20))
        out["dequantize_blockwise_f16"].append(_beside_bf16(res, device_ms(
            lambda q=q, s=s: qu.dequantize_blockwise(
                q, s, out_dtype=torch.bfloat16), inner)))
        del q, s, qt
    gc.collect()
    torch.cuda.empty_cache()
    return out


#: a near-tie between fp16 logits: phase 4's 1e-3, plus two fp16 ulps of
#: a logit below 8 (2 x 2^-8), which the card's and the CPU's fp16 logits
#: may each round apart
F16_NEAR_TIE = 1e-3 + 2 * 2.0 ** -8


def serving_fp16_reference_phase(seed: int, kernels):
    """(b) A narrow fp16 Llama with Llama-2's geometry (MHA, 4 heads of
    128, vocab 32000, 2 layers, fp16 parameters) served on the card and
    on the CPU (the plain versions) from the same weights: greedy on fp16
    exact pages, then half the requests sampled with n-gram speculation
    on int8 and on int4 pages.  Tokens equal, or equal up to the first
    difference at a token whose CPU top-two gap after noise is a near-tie
    of fp16 logits (under `F16_NEAR_TIE`, counted).  Returns the card's
    launches of the three runs."""
    import hetu_tpu_torch.serving.engine as engine_mod
    from hetu_tpu_torch.models.llama import LlamaLMHeadModel
    from hetu_tpu_torch.serving import (SamplingParams, ServeConfig,
                                        ServingEngine, poisson_arrivals,
                                        synthetic_requests)
    cfg = llama2_config(hidden_size=512, intermediate_size=1376,
                        num_hidden_layers=2, num_attention_heads=4,
                        num_key_value_heads=4)
    cpu = LlamaLMHeadModel(cfg, device="cpu", seed=seed + 60)
    card = LlamaLMHeadModel(cfg, device="cuda", seed=seed + 60)
    card.load_state_dict(cpu.state_dict())

    def trace(sampled):
        reqs = synthetic_requests(
            3, vocab_size=cfg.vocab_size, prompt_lens=(20, 60),
            max_new=(8, 8), arrivals=poisson_arrivals(3, 100.0, seed=seed),
            seed=seed + 61)
        if sampled:
            for r in reqs[1::2]:
                r.sampling = SamplingParams(temperature=0.8, top_k=50,
                                            top_p=0.95, seed=seed + r.rid)
        return reqs
    launches = {}
    t0 = time.perf_counter()
    for label, sampled, opts in (
            ("greedy, fp16 exact pages", False, {}),
            ("sampled + ngram, int8 pages", True,
             dict(sampling=True, spec_decode="ngram", spec_k=4,
                  kv_quant="int8")),
            ("sampled + ngram, int4 pages", True,
             dict(sampling=True, spec_decode="ngram", spec_k=4,
                  kv_quant="int4"))):
        serve = ServeConfig(num_slots=2, page_size=16, max_len=256,
                            prefill_chunk=64, **opts)
        runs = []
        for model in (card, cpu):
            eng = ServingEngine(model, serve, device=model.device).warmup()
            check(eng.pool.k.dtype == {"none": torch.float16,
                                       "int8": torch.int8,
                                       "int4": torch.uint8}[
                                           serve.kv_quant],
                  f"serving_fp16 (b) {label}: pool {eng.pool.k.dtype}")
            zero_counts(kernels)
            if model is cpu:
                with GapProbe(engine_mod) as probe:
                    probe.eng = eng
                    res = eng.run(trace(sampled))
            else:
                res = eng.run(trace(sampled))
                launches[label] = read_counts(kernels)
            eng.scheduler.check_invariants()
            runs.append(res)
        firsts = []
        for a, b in zip(*runs):
            check(len(a.tokens) == len(b.tokens) == 8,
                  f"serving_fp16 (b) {label}: request {a.rid} emitted "
                  f"{len(a.tokens)} / {len(b.tokens)} tokens")
            t = _first_divergence(a.tokens, b.tokens)
            if t is None:
                continue
            plen = next(r.prompt_len for r in trace(sampled)
                        if r.rid == a.rid)
            gap = probe.gaps.get((a.rid, plen + t), float("inf"))
            firsts.append((a.rid, t, gap))
            check(gap < F16_NEAR_TIE, f"serving_fp16 (b) {label}: request "
                                      f"{a.rid} diverges at token {t}, CPU "
                                      f"gap {gap}")
        print(f"serving_fp16 (b) {label}: card vs CPU tokens "
              + ("identical" if not firsts else
                 f"part after near-ties (request, token, CPU gap) {firsts}")
              + f", spec accepted {sum(r.stats.spec_accepted for r in runs[0])}"
              f" ({time.perf_counter() - t0:.1f}s)")
    return launches


def _f16_step(eng, reqs, spec_k=0):
    """One greedy decode step (or, with `spec_k`, one verify step and
    its fused sampler) over the engine's slots at the trace's depths:
    host enqueue, wall, the card's busy time and idle share, the paged
    kernels' share and the device operations a step."""
    from hetu_tpu_torch.models.generation import (decode_step_paged,
                                                  verify_step_paged)
    from hetu_tpu_torch.serving.sampling import sample_hidden_grid
    model, S = eng.model, eng.config.num_slots
    mp = eng.scheduler.max_pages
    C = spec_k + 1
    depths = [r.prompt_len + 16 for r in reqs][:S]
    table = torch.zeros((S, mp), dtype=torch.int32, device="cuda")
    for s_, d in enumerate(depths):
        n = (d + C - 1) // eng.config.page_size + 1
        table[s_, :n] = torch.arange(1 + s_ * mp, 1 + s_ * mp + n)
    pos = np.asarray(depths, np.int32)
    if spec_k:
        tok = torch.zeros((S, C), dtype=torch.int32, device="cuda")
        seeds, temps, top_ks, top_ps = eng._sample_args([])
        temps[1::2], top_ks[1::2], top_ps[1::2] = 0.8, 50, 0.95
        grid = pos[:, None] + np.arange(1, C + 1)

        def step():
            hidden = verify_step_paged(model, tok, eng.pool.k, eng.pool.v,
                                       table, pos, return_hidden=True,
                                       **eng._pools())[0]
            return sample_hidden_grid(hidden, model.lm_head_weight(), seeds,
                                      grid, temps, top_ks, top_ps)
    else:
        tok = torch.zeros(S, dtype=torch.int32, device="cuda")

        def step():
            return decode_step_paged(model, tok, eng.pool.k, eng.pool.v,
                                     table, pos, **eng._pools())[0]
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        step()
    enqueue = (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / reps
    counts = {}
    busy, _, by_name, top = _profile(step, 3, counts=counts)
    paged = paged_ms(by_name)
    return {"host_enqueue_ms": enqueue * 1e3, "wall_ms": wall * 1e3,
            "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / (wall * 1e3),
            "paged_attention_ms": paged,
            "paged_attention_share_of_busy": paged / busy,
            "device_ops_per_step": round(sum(counts.values())),
            "top_kernels_ms": top}


def _f16_arms(kernels, launches):
    """{kernel: fp16 launches} of the serving kernels in a run's counts."""
    return {name: launches[f"{name}_f16"] for name in F16_SERVING}


def _f16_run(label, eng, reqs, kernels, *, vocab, card, drafts=None):
    """Run `reqs` through `eng`, check every request finished with its 32
    tokens and no page leaked; print TTFT, the decode gap, tokens/s,
    acceptance, peak memory and the fp16 launches by kernel.  Returns
    (results, launches)."""
    torch.cuda.reset_peak_memory_stats()
    zero_counts(kernels)
    t0 = time.perf_counter()
    results = eng.run(reqs)
    wall = time.perf_counter() - t0
    launches = read_counts(kernels)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(len(results) == len(reqs), f"{label}: {len(results)} done")
    for r in results:
        check(r.finished_reason == "length" and len(r.tokens) == 32,
              f"{label}: request {r.rid}: {r.finished_reason}, "
              f"{len(r.tokens)} tokens")
        check(all(0 <= t < vocab for t in r.tokens),
              f"{label}: request {r.rid}: token out of the vocabulary")
    eng.scheduler.check_invariants()
    cached = eng.prefix_cache.stats()["pages"] if eng.prefix_cache else 0
    check(eng.pool.used_count == cached, f"{label}: pages leaked")
    reg = eng.registry
    ttft = sorted(r.stats.ttft_s for r in results)
    gap = reg.histogram("serve.token_latency_s")
    prop = int(reg.counter_value("serve.spec_proposed"))
    acc = int(reg.counter_value("serve.spec_accepted"))
    tokens_out = sum(len(r.tokens) for r in results)
    print(f"serving_fp16 {label} " + json.dumps({
        "ttft_s_p50": ttft[len(ttft) // 2], "ttft_s_max": ttft[-1],
        "gap_s_p50": gap.percentile(50), "gap_s_max": gap.vmax,
        "tokens_per_s": tokens_out / wall, "run_wall_s": wall,
        "decode_steps": int(reg.counter_value("serve.decode_steps")),
        "spec_proposed": prop, "spec_accepted": acc,
        "prefix_hits": int(reg.counter_value("serve.prefix_hits")),
        "peak_memory_gib": peak,
        "f16_launches": _f16_arms(kernels, launches)}) + f"; {card}")
    return results, launches


def serving_fp16_llama_phase(seed: int, kernels, card: str):
    """(c) Llama-2-7B as published in fp16 (`llama2_config`), depth cut
    to 16 layers, weights drawn on the card from the seed, behind phase 5's
    `ServeConfig(8, 16, 2048, 256)` and trace: greedy on fp16 exact
    pages; half the requests sampled on int8 pages, without speculation
    (the int8 decode arm) and with n-gram speculation (spec_k 4, the
    verify arm), then again with that run's own continuation
    as its drafts (`oracle_drafter`: the same tokens, drafts accepted);
    sampled on int4 pages; a TinyLlama-width fp16 draft resident in int8
    (`ModelDrafter`, block 128) proposing 2 tokens a step with stochastic
    verification and the prefix cache on int8 pages over
    `shared_prompt_trace` (16 requests sharing a 512-token prompt).  Each run's fp16 launches by kernel; a
    greedy decode step and an int8 verify step profiled; then the greedy
    run again with the model in bf16 (the same weights cast), its decode
    step profiled beside the fp16 one.  Every serving kernel's fp16 arm
    must have launched on these paths."""
    from hetu_tpu_torch.models.llama import LlamaLMHeadModel
    from hetu_tpu_torch.serving import (ServeConfig, ServingEngine,
                                        poisson_arrivals, synthetic_requests)
    from hetu_tpu_torch.serving.spec_decode import ModelDrafter
    # depth 32 -> 16 for the smoke's time: phase 20 (d) serves
    # Llama-2-13B in fp16 at its full depth
    cfg = llama2_config(num_hidden_layers=16)
    t0 = time.perf_counter()
    model = LlamaLMHeadModel(cfg, device="cuda", seed=seed)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == cfg.num_params(), "Llama-2-7B parameter count")
    check(all(p.dtype == torch.float16 for p in model.parameters()),
          "Llama-2-7B parameters not fp16")
    print(f"serving_fp16: Llama-2-7B {cfg.num_hidden_layers} layers, "
          f"{n_params / 1e9:.3f}B params fp16 "
          f"({torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB), drawn in "
          f"{time.perf_counter() - t0:.1f}s")

    def trace(sampled):
        reqs = synthetic_requests(
            8, vocab_size=cfg.vocab_size, prompt_lens=(64, 1024),
            max_new=(32, 32), arrivals=poisson_arrivals(8, 10.0, seed=seed),
            seed=seed)
        if sampled:
            from hetu_tpu_torch.serving import SamplingParams
            for r in reqs[1::2]:
                r.sampling = SamplingParams(temperature=0.8, top_k=50,
                                            top_p=0.95, seed=seed + r.rid)
        return reqs

    def serve(**kw):
        return ServeConfig(num_slots=8, page_size=16, max_len=2048,
                           prefill_chunk=256, **kw)
    by_path, steps = {}, {}
    run = dict(vocab=cfg.vocab_size, card=card)
    eng = ServingEngine(model, serve(), device="cuda").warmup()
    check(eng.pool.k.dtype == torch.float16, "serving_fp16: pool not fp16")
    _, by_path["serving_fp16_greedy"] = _f16_run(
        "(c) greedy, fp16 exact pages", eng, trace(False), kernels, **run)
    steps["decode_step_fp16"] = _f16_step(eng, trace(False))
    del eng
    eng = ServingEngine(model, serve(kv_quant="int8", sampling=True),
                        device="cuda").warmup()
    _, by_path["serving_fp16_int8"] = _f16_run(
        "(c) sampled, int8 pages", eng, trace(True), kernels, **run)
    del eng
    sampled = dict(kv_quant="int8", sampling=True, spec_decode="ngram",
                   spec_k=4)
    eng = ServingEngine(model, serve(**sampled), device="cuda").warmup()
    spec, by_path["serving_fp16_int8_ngram"] = _f16_run(
        "(c) sampled + ngram, int8 pages", eng, trace(True), kernels, **run)
    steps["verify_step_int8_fp16"] = _f16_step(eng, trace(True), spec_k=4)
    del eng
    eng = ServingEngine(model, serve(**sampled), device="cuda",
                        drafter=oracle_drafter(trace(True), spec)).warmup()
    oracle, by_path["serving_fp16_int8_oracle"] = _f16_run(
        "(c) sampled + its own continuation as drafts, int8 pages", eng,
        trace(True), kernels, **run)
    check([r.tokens for r in oracle] == [r.tokens for r in spec],
          "serving_fp16: drafting the run's own tokens changed them")
    check(sum(r.stats.spec_accepted for r in oracle) > 0,
          "serving_fp16: no draft accepted")
    del eng
    eng = ServingEngine(model, serve(kv_quant="int4", sampling=True),
                        device="cuda").warmup()
    _, by_path["serving_fp16_int4"] = _f16_run(
        "(c) sampled, int4 pages", eng, trace(True), kernels, **run)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    # the model drafter with the prefix cache
    dcfg = tinyllama_config()
    draft = LlamaLMHeadModel(dcfg, device="cuda", seed=seed + 1)
    zero_counts(kernels)
    drafter = ModelDrafter(draft, quantize_bits=8, quantize_block=128)
    load = read_counts(kernels)
    check(load["quantize_blockwise_f16"] == len(drafter._spec) > 0,
          f"serving_fp16: the draft's load quantized "
          f"{load['quantize_blockwise_f16']} fp16 matrices of "
          f"{len(drafter._spec)}")
    del draft
    gc.collect()
    torch.cuda.empty_cache()
    eng = ServingEngine(model, serve(
        kv_quant="int8", sampling=True, spec_decode="model", spec_k=2,
        prefix_cache=True), device="cuda", drafter=drafter).warmup()
    reqs = shared_prompt_trace(cfg.vocab_size, seed)
    _, launches = _f16_run("(c) TinyLlama-width int8 draft + prefix cache, "
                           "int8 pages", eng, reqs, kernels, **run)
    check(eng.registry.counter_value("serve.prefix_hits") >= len(reqs) // 2,
          "serving_fp16: too few prefix hits")
    launches["quantize_blockwise_f16"] += load["quantize_blockwise_f16"]
    launches["quantize_blockwise"] += load["quantize_blockwise"]
    by_path["serving_fp16_drafter"] = launches
    del eng, drafter
    gc.collect()
    torch.cuda.empty_cache()
    used = {name for path in by_path.values()
            for name, n in _f16_arms(kernels, path).items() if n}
    check(used == set(F16_SERVING), f"serving_fp16: fp16 arms never "
                                    f"launched: {set(F16_SERVING) - used}")
    # the same greedy run with the model in bf16, its decode step beside
    # the fp16 one's
    for p in model.parameters():
        p.data = p.data.bfloat16()
    model.config.param_dtype = model.config.compute_dtype = torch.bfloat16
    eng = ServingEngine(model, serve(), device="cuda").warmup()
    check(eng.pool.k.dtype == torch.bfloat16, "bf16 pool")
    _f16_run("(c) greedy, the same weights in bf16, bf16 exact pages", eng,
             trace(False), kernels, **run)
    steps["decode_step_bf16"] = _f16_step(eng, trace(False))
    print("serving_fp16 steps " + json.dumps(steps) + f"; {card}")
    del eng, model
    gc.collect()
    torch.cuda.empty_cache()
    return by_path


def serving_fp16_phase(seed: int, kernels, card: str):
    """Phase 19 ("serving_fp16"): (a) the fp16 arms at Llama-2-7B's
    shapes, (b) the narrow fp16 Llama card vs CPU, (c) Llama-2-7B in fp16
    at full width and depth.  Returns (by_path, cases)."""
    t0 = time.perf_counter()
    cases = serving_fp16_kernel_phase(seed)
    by_path = {f"serving_fp16_reference {k}": v for k, v in
               serving_fp16_reference_phase(seed, kernels).items()}
    gc.collect()
    torch.cuda.empty_cache()
    by_path.update(serving_fp16_llama_phase(seed, kernels, card))
    print(f"serving_fp16: {time.perf_counter() - t0:.1f}s; {card}")
    return by_path, cases


# ----------------------------------------------- fp16 parameters (20)
def llama2_13b_config(**kw):
    """Meta's Llama-2-13B as published (meta-llama/Llama-2-13b-hf: hidden
    5120, 40 layers, 40 q / 40 kv heads of 128, SwiGLU 13824, vocab
    32000, rope theta 10000, `torch_dtype: float16`): fp16 parameters
    and compute."""
    from hetu_tpu_torch.models.llama import LlamaConfig
    return LlamaConfig.llama2_13b(**{"param_dtype": torch.float16,
                                     "compute_dtype": torch.float16, **kw})


def _adam_leaves(g, numels, dtype, offsets=None):
    """p (`dtype`), g, m, v of AdamW's cases (adam_case's scales), each
    leaf `offsets[i]` elements into its buffer (off 16 bytes)."""
    offsets = offsets or [0] * len(numels)

    def randn(n, dt, std, off):
        buf = torch.empty(n + off, dtype=dt, device="cuda")[off:]
        return buf.copy_(std * torch.randn(n, generator=g, device="cuda"))
    p = [randn(n, dt, 0.02, o) for n, dt, o in zip(
        numels, dtype if isinstance(dtype, list) else [dtype] * len(numels),
        offsets)]
    grad = [randn(n, torch.float32, 1e-3, o) for n, o in zip(numels, offsets)]
    m = [randn(n, torch.float32, 1e-4, o) for n, o in zip(numels, offsets)]
    v = [randn(n, torch.float32, 1e-6, o).abs_()
         for n, o in zip(numels, offsets)]
    return p, grad, m, v


ADAM_KW = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)


def _adam_scalars(step=10):
    c1 = float(np.float32(1) - np.float32(0.9) ** np.float32(step))
    c2 = float(np.float32(1) - np.float32(0.95) ** np.float32(step))
    return 3e-4, c1, c2


def _bits_equal(xs, ys):
    return all(a.dtype == b.dtype and torch.equal(a, b)
               for a, b in zip(xs, ys))


def _adam_bits(label, p, grad, m, v, skip_values=(None, 1, 0)):
    """The kernel (`adam_update_multi`) on (p, m, v) and the plain version
    on copies, one step for each skip flag of `skip_values` (None: no
    flag): every p, m and v bit for bit after each, and a set flag leaves
    them as they were.  Returns the largest |kernel - plain|."""
    from hetu_tpu_torch.ops.cuda import adam as ad
    lr, c1, c2 = _adam_scalars()
    ref = [[t.clone() for t in ts] for ts in (p, m, v)]
    for flag in skip_values:
        skip = None if flag is None else torch.full(
            (), flag, dtype=torch.int32, device="cuda")
        was = param_digest(p + m + v) if flag else None
        ad.adam_update_multi(p, grad, m, v, lr, c1, c2, skip=skip, **ADAM_KW)
        for leaf in zip(ref[0], grad, ref[1], ref[2]):
            ad.adam_plain(*leaf, lr, c1, c2, skip=skip, **ADAM_KW)
        torch.cuda.synchronize()
        check(all(_bits_equal(a, b) for a, b in zip((p, m, v), ref)),
              f"{label}: kernel and plain version differ (skip {flag})")
        if flag:
            check(param_digest(p + m + v) == was,
                  f"{label}: the skip flag set, p, m or v changed")
    print(f"kernel {label}: p, m and v bit for bit the plain version's "
          f"over {len(p)} leaves, skip flag none / set / clear; set: "
          f"nothing written")
    del ref
    return 0.0


def adam_f16_phase(seed: int):
    """Phase 20 (a), AdamW's fp16 arm: (i) over the leaf table of (c)
    (Llama-2-7B at 8 layers, 1.881 B elements, fp16 p, fp32 g, m, v):
    bit for bit against the plain version with no flag, the skip flag
    set (nothing written) and clear; timed (one launch, CUDA events)
    beside the plain version, the bf16 arm on the same element count in
    this call, its bound (24 bytes an element over 3.35 TB/s) and
    `torch._fused_adamw_` where it takes fp16 p with fp32 g, m, v (else
    null, with its words); (ii) a mixed fp32 / bf16 / fp16 list of odd
    sizes, tails and views off a 16-byte boundary, bit for bit the same
    way.  Returns {kernel: [cases]}."""
    from hetu_tpu_torch.ops.cuda import adam as ad
    g = torch.Generator(device="cuda").manual_seed(seed + 90)
    from hetu_tpu_torch.models.llama import LlamaLMHeadModel
    numels = leaf_numels(LlamaLMHeadModel, llama2_config(num_hidden_layers=8),
                         ".layers.")
    n = sum(numels)
    check(abs(n - 1.881e9) < 1e6, f"the (c) table holds {n} elements")
    label = (f"adam_update fp16 arm, the Llama-2-7B 8-layer table: "
             f"{len(numels)} leaves, {n} elements, fp16 p, fp32 g/m/v")
    p, grad, m, v = _adam_leaves(g, numels, torch.float16)
    err = _adam_bits(label, p, grad, m, v)
    lr, c1, c2 = _adam_scalars()
    ms = event_ms(lambda: ad.adam_update_multi(p, grad, m, v, lr, c1, c2,
                                               **ADAM_KW))
    plain_ms = event_ms(lambda: [ad.adam_plain(*leaf, lr, c1, c2, **ADAM_KW)
                                 for leaf in zip(p, grad, m, v)], reps=2)
    library_ms, library_words = None, None
    steps = [torch.full((), 10.0, device="cuda") for _ in numels]

    def library():
        torch._fused_adamw_(p, grad, m, v, [], steps, lr=lr, beta1=0.9,
                            beta2=0.95, weight_decay=0.1, eps=1e-8,
                            amsgrad=False, maximize=False)
    try:
        torch._fused_adamw_(p[-2:], grad[-2:], m[-2:], v[-2:], [],
                            steps[-2:], lr=lr, beta1=0.9, beta2=0.95,
                            weight_decay=0.1, eps=1e-8, amsgrad=False,
                            maximize=False)
        library_ms = event_ms(library)
    except RuntimeError as e:   # a yardstick only: the port never calls it
        library_words = str(e).splitlines()[0]
        print(f"{label}: torch._fused_adamw_ refuses an fp16 p with fp32 "
              f"g, m, v ({library_words}); library_ms stays null")
    for i, t in enumerate(p):                 # the same count in bf16
        p[i] = t.bfloat16()
        del t
    bf16_ms = event_ms(lambda: ad.adam_update_multi(p, grad, m, v, lr, c1,
                                                    c2, **ADAM_KW))
    b_ms, b_by = bound(24 * n, 15 * n)
    res = {"case": label, "max_abs_err": err, "tolerance": "bits equal",
           "excess": 0.0, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
           "bound_by": b_by, "library_ms": library_ms,
           "library_refusal": library_words, "composition_ms": None,
           "bf16_ms": bf16_ms}
    print(f"kernel {label}: ms={ms:.5f} plain_ms={plain_ms:.5f} "
          f"bound_ms={b_ms:.5f} ({b_by}) bf16 arm {bf16_ms:.5f} ms "
          f"(fp16 / bf16 {ms / bf16_ms:.3f}) library_ms={library_ms}")
    del p, grad, m, v
    gc.collect()
    torch.cuda.empty_cache()
    # a mixed list: fp16 aligned and off 16 bytes, tails, several chunks
    C, f16, bf16, f32 = ad.CHUNK, torch.float16, torch.bfloat16, torch.float32
    spec = [(3 * C + 5, f16, 0), (1001, f16, 1), (C, f16, 2), (4097, f16, 3),
            (12, f16, 0), (4096, f32, 1), (2 * C + 3, bf16, 0), (5, f16, 1)]
    mixed = _adam_leaves(g, [s[0] for s in spec], [s[1] for s in spec],
                         [s[2] for s in spec])
    mixed_label = ("adam_update mixed fp32 / bf16 / fp16 list, odd sizes, "
                   "tails, views off 16 bytes")
    _adam_bits(mixed_label, *mixed)
    return {"adam_update_f16": [res, {
        "case": mixed_label, "max_abs_err": 0.0, "tolerance": "bits equal",
        "excess": 0.0, "ms": None, "plain_ms": None, "bound_ms": None,
        "bound_by": None, "library_ms": None, "composition_ms": None}]}


def llama2_13b_kernel_phase(seed: int):
    """Phase 20 (a), the kernels of (c) and (d) at Llama-2-13B's widths
    in fp16, each against its plain version at its phase's tolerance and
    timed beside its bound: flash q/kv [2, 2048, 40, 128] causal; the
    fused RMS norm at [4096, 5120] (640 16-byte chunks a row); SwiGLU at
    [4096, 13824]; RoPE from the fused projection [2, 2048, 40, 1+2,
    128] (group 1) and its backward; paged decode q [8, 40, 128] over 40
    kv heads on exact and int8 pages; `write_kv_tokens` at 40 kv heads
    and `write_kv_pages` at 40 layers x 40 heads (1,024 of 2,048
    positions), exact and int8; the sampler's product hidden [40, 5120]
    x head [5120, 32000].  Returns {kernel: [cases]}."""
    from hetu_tpu_torch.ops.cuda import paged_attention as pa
    g = torch.Generator(device="cuda").manual_seed(seed + 91)
    f16, note = torch.float16, " (Llama-2-13B)"
    out = {}

    def randn(*shape, std=1.0, dtype=f16):
        return (std * torch.randn(shape, generator=g, device="cuda")).to(
            dtype)
    for name, more in flash_timed(g, 2, 2048, 40, 40, 128, f16,
                                  layout=note).items():
        out[f"{name}_f16"] = more
    gc.collect()
    torch.cuda.empty_cache()
    out.update(f16_rms_cases(randn, 4096, 5120, note))
    out.update(f16_swiglu_cases(randn, 4096, 13824, note))
    out.update(f16_rope_cases(randn, 2, 2048, 40, 1, 10000.0, note))
    gc.collect()
    torch.cuda.empty_cache()
    scale = 128 ** -0.5
    for quant in ("none", "int8"):
        q, pools, table, pos, nbytes, ops = serving_pages(
            seed + 92, quant, 1, 4, nq=40, n_kv=40, dtype=f16)
        name = "paged_attention" if quant == "none" else \
            f"paged_attention_{quant}"
        label = (f"{name} {quant} pages q=[8,40,128] n_kv=40 ps=16 mp=128 "
                 f"fp16{note}")

        def run(i, pools=pools, quant=quant, q=q[:, 0], table=table,
                pos=pos):
            k, v, ks, vs = pools[i % len(pools)]
            return pa.paged_attention(q, k, v, table, pos,
                                      softmax_scale=scale, k_scale=ks,
                                      v_scale=vs, quant=quant)

        def plain(i, pools=pools, quant=quant, q=q[:, 0], table=table,
                  pos=pos):
            k, v, ks, vs = pools[i % len(pools)]
            return pa.paged_attention_plain(q, k, v, table, pos, scale, ks,
                                            vs, quant)
        same_bits(label, run)
        out[f"{name}_f16"] = [case(label, ulps(1, 1e-5, f16), run, plain,
                                   nbytes, ops, op_dtype=f16)]
        del pools
    modes = [("none", 1), ("int8", 1)]
    out["kv_write_tokens_f16"] = kv_token_cases(
        seed + 93, modes, dtype=f16, n_kv=40, hd=128, group=1)
    out["kv_write_pages_f16"] = kv_pages_cases(
        seed + 94, ("none", "int8"), layers=40, tokens=1024, max_len=2048,
        n_kv=40, hd=128, dtype=f16)
    gc.collect()
    torch.cuda.empty_cache()
    head = (0.02 * torch.randn((5120, 32000), generator=g,
                               device="cuda")).half()
    out["fused_sample_f16"] = sampler_cases(g, seed, head,
                                            "[5120,32000]" + note)
    del head
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _f16_param_bound(bound, trainers, step, opt):
    """Add an applied step's share to each fp16 parameter's card-vs-CPU
    bound: lr x what the two sides' AdamW directions differ by (each
    recomputed in fp32, 2^-21 |u| for its own rounding) + one fp16 ulp
    at the larger of the two values (each side's store rounds once)."""
    card_t, cpu_t = trainers
    for i, (pg, pc, mg, vg, mc, vc) in enumerate(zip(
            card_t.params, cpu_t.params, card_t.opt_state["m"],
            card_t.opt_state["v"], cpu_t.opt_state["m"],
            cpu_t.opt_state["v"])):
        u = _adam_direction(mg, vg, step, opt)
        u_ref = _adam_direction(mc.to("cuda"), vc.to("cuda"), step, opt)
        bound[i] += opt._lr(step) * ((u - u_ref).abs() + 2.0 ** -21 * (
            u.abs() + u_ref.abs())) + _f16_ulp(torch.maximum(
                pg.detach().float().abs(), pc.detach().to("cuda").abs()))


def _f16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One fp16 ulp at each element of x (11 significant bits; 2^-24 in
    the subnormal range)."""
    _, exp = torch.frexp(x.float())
    return torch.maximum(torch.ldexp(torch.ones_like(x, dtype=torch.float32),
                                     exp - 11),
                         torch.full_like(x, 2.0 ** -24, dtype=torch.float32))


def _one_token_batch(rows: int, seq: int, token: int = 7):
    """One token everywhere: every position adds the same outer product
    to the head's row of that token, a coherent sum that passes fp16's
    65,504 in the fp16 weight gradient under the scale (the activations'
    cotangents stay far below it)."""
    ids = np.full((rows, seq), token, np.int32)
    return {"input_ids": ids, "labels": ids.copy()}


def _narrow_f16_config():
    """Llama-2's geometry, narrow: hidden 256, 2 q / 2 kv heads of 128,
    SwiGLU 688, vocab 2048, 2 layers, fp16 parameters and compute, flash,
    "dots_attn" (the CPU side's fp16 products are slow on the card's
    host: phase 15 (b)'s hidden 512 took 54 s there)."""
    from hetu_tpu_torch.models.llama import LlamaConfig
    return LlamaConfig.tiny(hidden_size=256, num_attention_heads=2,
                            num_key_value_heads=2, intermediate_size=688,
                            vocab_size=2048, num_hidden_layers=2,
                            max_position_embeddings=2048,
                            param_dtype=torch.float16,
                            compute_dtype=torch.float16,
                            use_flash_attention=True,
                            remat_policy="dots_attn")


def _merge_gap(card_merged, cpu_merged, adapters, cfg):
    """The largest |card - CPU| of two merges, over each element's one
    fp16 ulp at each of the merge's roundings (the delta's and the
    sum's): <= 1 holds."""
    worst = 0.0
    for name, w in card_merged.items():
        c = cpu_merged[name].to("cuda")
        if name not in adapters:
            check(torch.equal(w, c), f"merge: {name} passed through changed")
            continue
        a, b = adapters[name]["A"], adapters[name]["B"]
        delta = (a @ b).reshape(w.shape) * cfg.scale
        err = (w.float() - c.float()).abs()
        ulp = _f16_ulp(delta.abs()) + _f16_ulp(torch.maximum(
            w.float().abs(), c.float().abs()))
        worst = max(worst, float((err / ulp).max()))
    return worst


def fp16_params_reference_phase(seed: int, card: str):
    """Phase 20 (b): a narrow Llama with fp16 parameters and compute
    (`_narrow_f16_config`, `loss_scale="auto"`: the scale on) on the card
    and on the CPU from one set of weights, `TrainingConfig(4, 2, 64)`:
    4 steps, the first of one token everywhere (its fp16 weight gradient
    overflows at 2^16: skipped, p, m and v as before on both, the scale
    halves), the (skipped, scale) course equal; on the applied steps the
    loss within T4_LOSS_TOL and the grad norm within T4_GRAD_NORM_TOL
    relative, every leaf's m and v within T4_MOMENT_TOL of its largest
    entry, every fp16 parameter within the AdamW-direction bound plus one
    fp16 ulp a step (`_f16_param_bound`); a save after step 2 and a new
    trainer resumed from it, steps 3 and 4 again: bit for bit; LoRA SFT
    (rank 4, every target) of 2 steps on the same fp16 base, card vs
    CPU within phase 16's limits; the card's adapters merged on the card
    and on the CPU, within one fp16 ulp at each of the merge's roundings
    (`_merge_gap`)."""
    import tempfile
    from hetu_tpu_torch.engine import SFTTrainer, Trainer, TrainingConfig
    from hetu_tpu_torch.models.llama import LlamaLMHeadModel
    from hetu_tpu_torch.peft import LoRAConfig, merge_lora_params
    t0 = time.perf_counter()
    cfg = _narrow_f16_config()
    cpu = LlamaLMHeadModel(cfg, device="cpu", seed=seed + 95)
    start = {k: v.clone() for k, v in cpu.state_dict().items()}

    def card_model():
        gpu = LlamaLMHeadModel(cfg, device="cuda", seed=seed + 95)
        gpu.load_state_dict(start)
        return gpu
    gpu = card_model()
    for layer in cpu.model.layers:
        layer.attn.use_pallas = True
    tmp = tempfile.mkdtemp(prefix="fp16_params_")
    tc = TrainingConfig(global_batch_size=4, micro_batch_size=2, seq_len=64,
                        warmup_steps=1, total_steps=10, log_every=100)
    trainers = [Trainer(gpu, dataclasses.replace(tc, ckpt_dir=tmp),
                        device="cuda").build(),
                Trainer(cpu, tc, device="cpu").build()]
    rng = np.random.default_rng(seed + 96)
    batches = [_one_token_batch(4, 64)] + [
        _train_batch(cfg.vocab_size, 4, 64, int(s))
        for s in rng.integers(0, 2 ** 31, 3)]
    opt = trainers[1].optimizer
    bound = [torch.zeros(p.shape, device="cuda") for p in gpu.parameters()]
    runs = ([], [])
    for step, batch in enumerate(batches, 1):
        before = [param_digest(tr.params + tr.opt_state["m"]
                               + tr.opt_state["v"]) for tr in trainers]
        for tr, out in zip(trainers, runs):
            out.append({k: float(v) for k, v in tr.train_step(batch).items()})
            tr.settle()
        if runs[0][-1]["amp_skipped"]:
            check(all(param_digest(tr.params + tr.opt_state["m"]
                                   + tr.opt_state["v"]) == b
                      for tr, b in zip(trainers, before)),
                  "fp16 params (b): a skipped step wrote p, m or v")
        else:
            _f16_param_bound(bound, trainers, trainers[0].opt_state["step"],
                             opt)
        if step == 2:
            trainers[0].save(wait=True)
    t_train = time.perf_counter() - t0
    on_card, on_cpu = runs
    course = [(x["amp_skipped"], x["loss_scale"]) for x in on_card]
    check(course == [(x["amp_skipped"], x["loss_scale"]) for x in on_cpu]
          == [(1.0, 2.0 ** 15)] + [(0.0, 2.0 ** 15)] * 3,
          f"fp16 params (b): the scale's course {course} vs "
          f"{[(x['amp_skipped'], x['loss_scale']) for x in on_cpu]}")
    worst = {k: max(abs(a[k] - b[k]) / abs(b[k])
                    for a, b in zip(on_card[1:], on_cpu[1:]))
             for k in ("loss", "grad_norm")}
    check(worst["loss"] <= T4_LOSS_TOL
          and worst["grad_norm"] <= T4_GRAD_NORM_TOL,
          f"fp16 params (b): card vs CPU differs: {worst}")
    moments = {}
    for key in ("m", "v"):
        moments[key] = max(
            ((a - b.to("cuda")).abs().max().item()
             / (b.abs().max().item() or 1.0), name)
            for name, a, b in zip(trainers[1].names,
                                  trainers[0].opt_state[key],
                                  trainers[1].opt_state[key]))
        check(moments[key][0] <= T4_MOMENT_TOL,
              f"fp16 params (b): {key} of {moments[key][1]}: "
              f"{moments[key][0]:.3g} of its largest entry")
    over = max(((a.detach().float() - b.detach().to("cuda").float()).abs()
                / bnd).max().item()
               for a, b, bnd in zip(trainers[0].params, trainers[1].params,
                                    bound))
    check(over <= 1.0, f"fp16 params (b): parameters past their bound {over}")
    check(all(p.dtype == torch.float16 for p in trainers[0].params),
          "fp16 params (b): parameters left fp16")
    # the resume, on the card, from the step-2 checkpoint
    resumed = Trainer(card_model(), dataclasses.replace(tc, ckpt_dir=tmp),
                      device="cuda").build()
    resumed.restore()
    again = [{k: float(v) for k, v in resumed.train_step(b).items()}
             for b in batches[2:]]
    resumed.settle()
    a, b = trainers[0].state(), resumed.state()
    exact = (again == on_card[2:] and all(
        torch.equal(a["params"][n], b["params"][n])
        and torch.equal(a["opt_state"]["m"][n], b["opt_state"]["m"][n])
        and torch.equal(a["opt_state"]["v"][n], b["opt_state"]["v"][n])
        for n in trainers[0].names) and all(
        torch.equal(a["scaler"][k], b["scaler"][k]) for k in a["scaler"]))
    check(exact, "fp16 params (b): the resume is not bit for bit")
    t_resume = time.perf_counter() - t0 - t_train
    del trainers, resumed, gpu, a, b
    shutil.rmtree(tmp, ignore_errors=True)
    # LoRA SFT on the same fp16 base, card vs CPU
    gpu = card_model()
    cpu.load_state_dict(start)
    lora = LoRAConfig(rank=4)
    sft = [SFTTrainer(gpu, tc, lora=lora, device="cuda"),
           SFTTrainer(cpu, tc, lora=lora, device="cpu")]
    with torch.no_grad():
        for x, y in zip(sft[0].model.lora.values(),
                        sft[1].model.lora.values()):
            x.copy_(y)
    for tr in sft:
        tr.build()
    sft_rows = [_sft_rows(rng, cfg.vocab_size, 4, 64) for _ in range(2)]
    lbound = [torch.zeros(p.shape, device="cuda") for p in sft[0].params]
    lruns = ([], [])
    for step, batch in enumerate(sft_rows, 1):
        for tr, out in zip(sft, lruns):
            out.append({k: float(v) for k, v in tr.train_step(batch).items()})
        _t4_bound(lbound, sft, step, sft[1].optimizer)
    lworst = {k: max(abs(x[k] - y[k]) / abs(y[k]) for x, y in zip(*lruns))
              for k in ("loss", "grad_norm")}
    check(all(x["amp_skipped"] == 0.0 and x["loss_scale"] == y["loss_scale"]
              for x, y in zip(*lruns)), f"fp16 LoRA (b): scales {lruns}")
    check(lworst["loss"] <= T4_LOSS_TOL
          and lworst["grad_norm"] <= T4_GRAD_NORM_TOL,
          f"fp16 LoRA (b): card vs CPU differs: {lworst}")
    lover = max(((x.detach() - y.detach().to("cuda")).abs() / bnd).max().item()
                for x, y, bnd in zip(sft[0].params, sft[1].params, lbound))
    check(lover <= 1.0, f"fp16 LoRA (b): adapters past their bound {lover}")
    # the card's adapters merged on the card and on the CPU
    adapters = {n: {f: t.detach() for f, t in ab.items()}
                for n, ab in sft[0].model.lora_params.items()}
    merged = merge_lora_params(gpu, adapters, lora)
    on_cpu_merge = merge_lora_params(cpu, {
        n: {f: t.cpu() for f, t in ab.items()} for n, ab in adapters.items()},
        lora)
    gap = _merge_gap(merged, on_cpu_merge, adapters, lora)
    check(gap <= 1.0, f"fp16 LoRA (b): card and CPU merges {gap} ulps apart")
    check(all(w.dtype == torch.float16 for w in merged.values()),
          "fp16 LoRA (b): a merged weight is not fp16")
    print(f"fp16 params reference: narrow Llama (MHA, 2 layers), fp16 "
          f"params and compute, flash + dots_attn, scale auto, 4 steps: "
          f"(skipped, scale) {course} on both; applied steps card vs CPU "
          f"worst relative diff {worst} (tol {T4_LOSS_TOL}, "
          f"{T4_GRAD_NORM_TOL}); moments {moments} of their largest entry "
          f"(tol {T4_MOMENT_TOL}); parameters at most {over:.4f} of their "
          f"bound (fp16 ulps + AdamW directions; tol 1); losses "
          f"{[x['loss'] for x in on_card]}; resume from step 2 bit for bit; "
          f"LoRA SFT 2 steps on the fp16 base: {lworst}, adapters "
          f"{lover:.4f} of their bound; merges card vs CPU at most "
          f"{gap:.3f} of one fp16 ulp a rounding "
          f"({time.perf_counter() - t0:.1f}s: steps {t_train:.1f}, resume "
          f"{t_resume:.1f}); {card}")
    del sft, gpu, cpu, merged, on_cpu_merge


def _adam_kernel_ms(by_name):
    """The AdamW kernel's device ms in a profile's {name: ms}."""
    return sum(t for n, t in by_name.items() if "adam_multi_kernel" in n)


def fp16_params_llama2_7b_phase(seed: int, kernels, card: str):
    """Phase 20 (c): Llama-2-7B as published (`llama2_config`: fp16
    parameters and compute), depth 32 -> 8, flash, "dots_attn",
    `TrainingConfig(4, 2, 2048)` (phase 8's), 6 steps, the third of one
    token everywhere (`_one_token_batch`): exact launch counts each step
    (phase 8's fp16 arms; AdamW once on its fp16 arm, the skipped step's
    launch included); step 3 skipped (p, m, v as before) and the scale
    halved 2^16 -> 2^15, the other steps applied, the losses finite and
    falling over them; step p50, tokens/s, mfu (989 TFLOP/s), peak
    memory (<= 70 GiB), one step profiled (the AdamW kernel's ms, idle
    share); then the same widths with bf16 parameters and compute, 3
    steps (the first allocates), their p50.  Returns the fp16 run's
    launches."""
    from hetu_tpu_torch.engine import Trainer, TrainingConfig
    from hetu_tpu_torch.models.llama import LlamaLMHeadModel
    t_phase = time.perf_counter()
    cfg = llama2_config(num_hidden_layers=8, use_flash_attention=True,
                        remat_policy="dots_attn")
    gbs, mbs, seq = 4, 2, 2048
    per_step = _t4_per_step(kernels, cfg, gbs // mbs, "dots_attn")
    per_step["adam_update_f16"] = 1
    batches = [_train_batch(cfg.vocab_size, gbs, seq, seed)] * 6
    batches[2] = _one_token_batch(gbs, seq)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = LlamaLMHeadModel(cfg, device="cuda", seed=seed)
    tc = TrainingConfig(global_batch_size=gbs, micro_batch_size=mbs,
                        seq_len=seq, lr=1e-3, warmup_steps=2,
                        total_steps=1000, log_every=1)
    tr = Trainer(model, tc, device="cuda").build()
    check(tr._scaler is not None, "fp16 compute without the scaler")
    check(all(p.dtype == torch.float16 for p in tr.params)
          and all(a.dtype == torch.float32 for a in tr._accum),
          "(c) fp16 parameters with fp32 accumulators")

    def state():
        return param_digest(tr.params + tr.opt_state["m"]
                            + tr.opt_state["v"])
    zero_counts(kernels)
    launches = {name: 0 for name in kernels}
    rows, times = [], []
    for i, batch in enumerate(batches):
        before = state() if i == 2 else None
        t0 = time.perf_counter()
        metrics = tr.train([batch], num_steps=1)
        times.append(time.perf_counter() - t0)
        rows.append((float(metrics["loss"]), float(metrics["grad_norm"]),
                     float(metrics["loss_scale"]),
                     float(metrics["amp_skipped"])))
        counts = read_counts(kernels)
        check(counts == per_step, f"fp16 params (c) step {i + 1} launches "
              f"{counts}, expected {per_step}")
        check_adam_arm(f"fp16 params (c) step {i + 1}", 1, "f16")
        for k, n in counts.items():
            launches[k] += n
        zero_counts(kernels)
        if before is not None:
            check(state() == before,
                  "(c) the skipped step wrote p, m or v")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    skips = [x[3] for x in rows]
    check(skips == [0.0, 0.0, 1.0, 0.0, 0.0, 0.0]
          and [x[2] for x in rows] == [2.0 ** 16] * 2 + [2.0 ** 15] * 4,
          f"(c) the forced overflow: (loss, norm, scale, skipped) {rows}")
    applied = [x[0] for x in rows if x[3] == 0.0]
    check(all(math.isfinite(x) for x in applied) and applied[-1] < applied[0],
          f"(c) losses over the applied steps {applied}")
    check(peak <= TRAIN_PEAK_GIB, f"(c) peak {peak:.2f} GiB")
    check(tr.opt_state["step"] == 5, f"(c) AdamW's count "
          f"{tr.opt_state['step']} after 5 applied steps")
    busy, wall, by_name, top = _profile(lambda: tr.train_step(batches[0]),
                                        1, top=8)
    tr.settle()
    zero_counts(kernels)
    adam_ms = _adam_kernel_ms(by_name)
    del tr, model
    gc.collect()
    torch.cuda.empty_cache()
    # the same widths with bf16 parameters and compute, 3 steps
    bcfg = dataclasses.replace(cfg, param_dtype=torch.bfloat16,
                               compute_dtype=torch.bfloat16)
    model = LlamaLMHeadModel(bcfg, device="cuda", seed=seed)
    tr = Trainer(model, tc, device="cuda").build()
    bf16_times = []
    for batch in batches[:3]:
        t0 = time.perf_counter()
        tr.train([batch], num_steps=1)
        bf16_times.append(time.perf_counter() - t0)
    zero_counts(kernels)
    del tr, model
    gc.collect()
    torch.cuda.empty_cache()
    p50 = float(np.median(times))
    slots = gbs * seq
    flops = cfg.flops_per_token(seq)
    n_params = cfg.num_params()
    print("fp16 params llama2-7b " + json.dumps({
        "model": "Llama-2-7B", "layers": cfg.num_hidden_layers,
        "params": n_params, "param_dtype": "fp16", "compute_dtype": "fp16",
        "remat_policy": "dots_attn", "micro_batch": mbs, "seq_len": seq,
        "loss_grad_norm_scale_skipped": rows, "step_s": times,
        "step_s_p50": p50, "tokens_per_s": slots / p50,
        "mfu": flops * slots / p50 / PEAK_OPS_PER_S[torch.float16],
        "peak_memory_gib": peak, "adam_f16_ms_per_step": adam_ms,
        "launches_per_step": {k: v for k, v in per_step.items() if v},
        "profiled_step": {"device_busy_ms": busy, "wall_ms": wall,
                          "device_idle_share": 1.0 - busy / (p50 * 1e3),
                          "top_kernels_ms": top},
        "bf16_params_step_s": bf16_times,
        "bf16_params_step_s_p50": float(np.median(bf16_times)),
        "phase_s": time.perf_counter() - t_phase, "card": card}))
    return launches


class LogitProbe(EngineProbe):
    """On a greedy engine, the logits row each emitted token's argmax ran
    over, keyed by (request, the token's position): the engine module's
    `decode_step_paged` and `first_token_from_logits` are wrapped for the
    run."""
    names = ("decode_step_paged", "first_token_from_logits")

    def __init__(self, engine_mod):
        super().__init__(engine_mod)
        self.rows = {}

    def wrappers(self, saved):
        def decode_step_paged(model, tokens, *args, **kw):
            out = saved["decode_step_paged"](model, tokens, *args, **kw)
            positions = args[3]
            for s, st in enumerate(self.eng.scheduler.slots):
                if st is not None:
                    self.rows[(st.request.rid, int(positions[s]) + 1)] = \
                        out[0][s].float()
            return out

        def first_token_from_logits(req, row, position, *, sampling):
            self.rows[(req.rid, position)] = row.float()
            return saved["first_token_from_logits"](req, row, position,
                                                    sampling=sampling)
        return {"decode_step_paged": decode_step_paged,
                "first_token_from_logits": first_token_from_logits}


#: the engine's logits may lie this many times as far from the fp32
#: forward's as the model's own fp16 forward does at the same depth
F16_ENGINE_NU = 2.0


def _forward_logits(model, ids, start, dtype):
    """Logits [n, vocab] (fp32) at positions start.. of ids [s] through
    the model's blocks without a cache and with the dense attention (the
    plain composition, scores and softmax in fp32, as the engine's
    chunked prefill attends), in `dtype`: fp16, a second fp16 forward
    beside the model's flash one; fp32, the fp16 weights widened exactly
    and every product, norm and attention in fp32 (TF32 off) — the
    forward without rounding that the fp16 paths are measured against."""
    layers = model.layers
    routes = [layer.attn.use_pallas for layer in layers]
    x = model.embed_at(ids[None]).to(dtype)
    cos_t, sin_t = model.rope_at(1, ids.numel())
    try:
        for layer in layers:
            layer.attn.use_pallas = False
            x = layer(x, cos_t, sin_t)
    finally:
        for layer, route in zip(layers, routes):
            layer.attn.use_pallas = route
    return model.logits(model.final_norm(x[:, start:]))[0].float()


def _greedy_against_uncached(model, reqs, results, rows, label, nu=None):
    """Each greedy request's tokens against the merged model's uncached
    forward on the card (`model(ids)`, U) over its prompt and its own
    tokens.  With the engine's rows (`LogitProbe`, E), the depth's fp16
    rounding is measured first: nu, the largest |U - T| over the emitted
    tokens' rows, T the fp32 forward (`_forward_logits`), beside the
    dense fp16 forward's (D); each token must be its engine row's argmax
    and the engine's rows within F16_ENGINE_NU * nu of T (the first
    token's, from the chunked prefill, and the paged decode's apart).
    Without rows, nu is given (the probed run's).  Where a token is not
    U's argmax, U's gap between the two must be under 2 nu: a near tie
    at this depth, two entries whose order U cannot tell from T's (each
    may lie nu from T); the argmax and the bound on E alone would allow
    6 nu.  Returns the readings (absolute logits; `largest_logit`, T's
    largest)."""
    prompts = {r.rid: np.asarray(r.prompt) for r in reqs}
    err = {}

    def note(name, a, b):
        err[name] = max(err.get(name, 0.0), float((a - b).abs().max()))
    off, n, largest, seqs = [], 0, 0.0, []
    with torch.no_grad():
        for res in results:
            p = prompts[res.rid]
            ids = torch.from_numpy(np.concatenate([p, np.asarray(
                res.tokens[:-1])]).astype(np.int32)).to(model.device)
            u = model(ids[None])[0, len(p) - 1:].float()
            seqs.append((res, u))
            n += len(res.tokens)
            if rows is None:
                continue
            t32 = _forward_logits(model, ids, len(p) - 1, torch.float32)
            d16 = _forward_logits(model, ids, len(p) - 1, torch.float16)
            e = torch.stack([rows[(res.rid, len(p) + t)]
                             for t in range(len(res.tokens))])
            check(e.argmax(-1).cpu().tolist() == list(res.tokens),
                  f"{label}: request {res.rid}: a token is not its engine "
                  "row's argmax")
            largest = max(largest, float(t32.abs().max()))
            note("fp16_forward_vs_fp32", u, t32)
            note("dense_fp16_forward_vs_fp32", d16, t32)
            note("engine_prefill_vs_fp32", e[:1], t32[:1])
            note("engine_decode_vs_fp32", e[1:], t32[1:])
            note("engine_prefill_vs_fp16_forward", e[:1], u[:1])
            note("engine_decode_vs_fp16_forward", e[1:], u[1:])
            note("engine_prefill_vs_dense_fp16_forward", e[:1], d16[:1])
        if rows is not None:
            nu = err["fp16_forward_vs_fp32"]
        for res, u in seqs:
            top = u.argmax(-1).cpu().tolist()
            off += [(res.rid, t, float(u[t, top[t]] - u[t, tok]))
                    for t, tok in enumerate(res.tokens) if top[t] != tok]
    out = {"tokens": n, "largest_logit": largest, **err,
           "tie_limit": 2 * nu, "off_argmax_request_token_gap": off}
    print(f"{label}: " + json.dumps(out))
    for rid, t, gap in off:
        check(gap < 2 * nu, f"{label}: request {rid} token {t} off the "
              f"uncached forward's argmax at a gap {gap}, not under the "
              f"tie limit 2 nu = {2 * nu}")
    for name in ("engine_prefill_vs_fp32", "engine_decode_vs_fp32"):
        check(err.get(name, 0.0) <= F16_ENGINE_NU * nu, f"{label}: {name} "
              f"{err.get(name)}, past {F16_ENGINE_NU} x the fp16 forward's "
              f"{nu}")
    return out


def fp16_params_llama2_13b_phase(seed: int, kernels, card: str):
    """Phase 20 (d): Llama-2-13B as published (`llama2_13b_config`), an
    fp16 frozen base drawn from the seed at full depth (40 layers), LoRA
    rank 16 on the default targets, `SFTTrainer` on phase 16's chat
    batch (`sft_chat_batch`), `TrainingConfig(8, 2, 2048)`, flash,
    "dots_attn", the scale on ("auto"), 3 steps: exact launch counts
    (the fp16 arms; AdamW once on its fp32 arm, over the adapters), the
    base unchanged, peak <= 70 GiB (else the micro-batch halves, and the
    run says so); step p50, tokens/s over slots and loss tokens, mfu.
    Then the adapters merged into the fp16 base (`merge_lora_params`),
    the trainer and base freed, a fresh fp16 model loaded with the
    merged weights (`load_state_dict`) and served by the engine with
    phase 5's `ServeConfig` and trace: greedy on exact pages and half
    the requests sampled on int8 pages; TTFT, tokens/s, peak, and a
    greedy decode step profiled (device busy against its 7.8 ms weight
    bound, host enqueue).  The greedy run's logits and tokens are
    checked in runs of their own under `LogitProbe`, untimed, at 40
    layers and on models of the same widths at 1 and 10 layers drawn
    from the seed (`_greedy_against_uncached`); the timed run's tokens
    too where they differ from the probed run's.  Returns {path:
    launches}."""
    import hetu_tpu_torch.serving.engine as engine_mod
    from hetu_tpu_torch.engine import SFTTrainer, TrainingConfig
    from hetu_tpu_torch.models.llama import LlamaLMHeadModel
    from hetu_tpu_torch.peft import LoRAConfig, merge_lora_params
    from hetu_tpu_torch.peft.lora import target_parameters
    from hetu_tpu_torch.serving import (SamplingParams, ServeConfig,
                                        ServingEngine, poisson_arrivals,
                                        synthetic_requests)
    t_phase = time.perf_counter()
    cfg = llama2_13b_config(use_flash_attention=True,
                            remat_policy="dots_attn")
    L, gbs, seq = cfg.num_hidden_layers, 8, 2048
    lora = LoRAConfig(rank=16)
    batch, loss_tokens = sft_chat_batch(seed, cfg.vocab_size, gbs, seq)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = LlamaLMHeadModel(cfg, device="cuda", seed=seed)
    torch.cuda.synchronize()
    n_base = sum(p.numel() for p in model.parameters())
    check(n_base == cfg.num_params(), "Llama-2-13B parameter count")
    check(all(p.dtype == torch.float16 for p in model.parameters()),
          "Llama-2-13B base not fp16")
    print(f"fp16 params (d): Llama-2-13B {L} layers, {n_base / 1e9:.3f}B "
          f"params fp16 ({torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB), "
          f"drawn in {time.perf_counter() - t0:.1f}s")
    targets = [n for n, _ in target_parameters(model, lora)]
    before = param_digest(model.parameters())
    by_path = {}
    for mbs in (2, 1):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tr = SFTTrainer(model, TrainingConfig(
            global_batch_size=gbs, micro_batch_size=mbs, seq_len=seq,
            lr=1e-3, warmup_steps=1, total_steps=100, log_every=1),
            lora=lora, device="cuda").build()
        check(tr._scaler is not None, "(d) fp16 compute without the scaler")
        per_step = _t4_per_step(kernels, cfg, gbs // mbs, "dots_attn")
        zero_counts(kernels)
        losses, times, launches, cut = [], [], {k: 0 for k in kernels}, False
        for i in range(3):
            t0 = time.perf_counter()
            metrics = tr.train([batch], num_steps=1)
            times.append(time.perf_counter() - t0)
            losses.append((float(metrics["loss"]),
                           float(metrics["amp_skipped"])))
            counts = read_counts(kernels)
            check(counts == per_step, f"(d) LoRA step {i + 1} launches "
                  f"{counts}, expected {per_step}")
            check_adam_arm(f"(d) LoRA step {i + 1}", 1, "f32")
            for k, n in counts.items():
                launches[k] += n
            zero_counts(kernels)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            if i == 0 and peak > TRAIN_PEAK_GIB and mbs > 1:
                print(f"fp16 params (d): CUT micro-batch {mbs} -> "
                      f"{mbs // 2}: peak {peak:.1f} GiB > {TRAIN_PEAK_GIB}")
                cut = True
                break
        if not cut:
            break
        del tr
    peak_train = torch.cuda.max_memory_allocated() / 2 ** 30
    check(peak_train <= TRAIN_PEAK_GIB, f"(d) LoRA peak {peak_train:.2f} GiB")
    check(all(math.isfinite(x) and s == 0.0 for x, s in losses)
          and losses[-1][0] < losses[0][0], f"(d) LoRA losses {losses}")
    by_path["fp16_params_lora_13b"] = launches
    p50 = float(np.median(times))
    slots = gbs * seq
    n_adapters = sum(p.numel() for p in tr.params)
    print("fp16 params llama2-13b lora " + json.dumps({
        "model": "Llama-2-13B", "layers": L, "base_params": n_base,
        "base_dtype": "fp16", "compute_dtype": "fp16",
        "remat_policy": "dots_attn", "attention": "flash",
        "lora_rank": lora.rank, "lora_targets": len(targets),
        "adapter_params": n_adapters, "micro_batch": mbs,
        "seq_len": seq, "slots_per_step": slots,
        "loss_tokens_per_step": loss_tokens, "loss_skipped": losses,
        "step_s": times, "step_s_p50": p50,
        "tokens_per_s_slots": slots / p50,
        "tokens_per_s_loss_tokens": loss_tokens / p50,
        "mfu": cfg.flops_per_token(seq) * slots / p50
        / PEAK_OPS_PER_S[torch.float16],
        "peak_memory_gib": peak_train, "card": card}))
    # merge into the fp16 base, free the trainer, serve the merged model
    t0 = time.perf_counter()
    with torch.no_grad():
        merged = merge_lora_params(model, tr.model.lora_params, lora)
    check(param_digest(model.parameters()) == before,
          "(d) the frozen base changed")
    del tr, model
    gc.collect()
    torch.cuda.empty_cache()
    served = LlamaLMHeadModel(cfg, device="cuda", seed=seed + 1)
    served.load_state_dict(merged)
    del merged
    gc.collect()
    torch.cuda.empty_cache()
    print(f"fp16 params (d): merged, freed and loaded in "
          f"{time.perf_counter() - t0:.1f}s "
          f"({torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB)")

    def trace(sampled):
        reqs = synthetic_requests(
            8, vocab_size=cfg.vocab_size, prompt_lens=(64, 1024),
            max_new=(32, 32), arrivals=poisson_arrivals(8, 10.0, seed=seed),
            seed=seed)
        if sampled:
            for r in reqs[1::2]:
                r.sampling = SamplingParams(temperature=0.8, top_k=50,
                                            top_p=0.95, seed=seed + r.rid)
        return reqs

    def serve(**kw):
        return ServeConfig(num_slots=8, page_size=16, max_len=2048,
                           prefill_chunk=256, **kw)

    def probed(model):
        """A greedy run of the trace on exact pages under `LogitProbe`
        (untimed: the probe copies every emitted token's row), checked
        against the uncached forwards.  Returns (results, readings)."""
        eng = ServingEngine(model, serve(), device="cuda").warmup()
        with LogitProbe(engine_mod) as probe:
            probe.eng = eng
            results = eng.run(trace(False))
        del eng
        return results, _greedy_against_uncached(
            model, trace(False), results, probe.rows,
            f"(d) greedy at {model.config.num_hidden_layers} layers, "
            "probed")
    run = dict(vocab=cfg.vocab_size, card=card)
    eng = ServingEngine(served, serve(), device="cuda").warmup()
    check(eng.pool.k.dtype == torch.float16, "(d) pool not fp16")
    greedy, by_path["fp16_params_13b_greedy"] = _f16_run(
        "(d) merged Llama-2-13B greedy, fp16 exact pages", eng,
        trace(False), kernels, **run)
    step = _f16_step(eng, trace(False))
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    # the fp16 rounding by depth: the merged model, and models of its
    # widths at 1 and 10 layers drawn from the seed
    readings = {}
    for depth in (1, 10):
        shallow = LlamaLMHeadModel(dataclasses.replace(
            cfg, num_hidden_layers=depth), device="cuda", seed=seed + 2)
        _, readings[depth] = probed(shallow)
        del shallow
    again, readings[L] = probed(served)
    if [r.tokens for r in again] != [r.tokens for r in greedy]:
        _greedy_against_uncached(served, trace(False), greedy, None,
                                 f"(d) greedy at {L} layers, timed",
                                 nu=readings[L]["fp16_forward_vs_fp32"])
    gc.collect()
    torch.cuda.empty_cache()
    eng = ServingEngine(served, serve(kv_quant="int8", sampling=True),
                        device="cuda").warmup()
    _, by_path["fp16_params_13b_int8"] = _f16_run(
        "(d) merged Llama-2-13B sampled, int8 pages", eng, trace(True),
        kernels, **run)
    del eng
    weight_bytes = sum(p.numel() * 2 for p in served.parameters())
    print("fp16 params llama2-13b served " + json.dumps({
        "greedy_by_depth": readings,
        "timed_greedy_tokens_as_probed": [r.tokens for r in again]
        == [r.tokens for r in greedy],
        "decode_step": step, "decode_weight_bound_ms":
        weight_bytes / PEAK_BYTES_PER_S * 1e3,
        "phase_s": time.perf_counter() - t_phase, "card": card}))
    del served
    gc.collect()
    torch.cuda.empty_cache()
    return by_path


def fp16_params_phase(seed: int, kernels, card: str):
    """Phase 20 ("fp16_params"): (a) AdamW's fp16 arm and the kernels at
    Llama-2-13B's widths, (b) a narrow fp16-parameter Llama card vs CPU,
    (c) Llama-2-7B trained with fp16 parameters, (d) Llama-2-13B
    LoRA-tuned on its fp16 base at full depth, merged and served.
    Returns (by_path, cases)."""
    t0 = time.perf_counter()
    cases = adam_f16_phase(seed)
    for name, more in llama2_13b_kernel_phase(seed).items():
        cases.setdefault(name, []).extend(more)
    fp16_params_reference_phase(seed, card)
    gc.collect()
    torch.cuda.empty_cache()
    by_path = {"fp16_params_llama2_7b": fp16_params_llama2_7b_phase(
        seed, kernels, card)}
    gc.collect()
    torch.cuda.empty_cache()
    by_path.update(fp16_params_llama2_13b_phase(seed, kernels, card))
    print(f"fp16_params: {time.perf_counter() - t0:.1f}s; {card}")
    return by_path, cases


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    smi = card_line()

    def mark(what):
        """The run's elapsed time at the end of a phase (where the
        smoke's time goes)."""
        print(f"phase {what}: done at {time.perf_counter() - t_start:.1f}s")
    kind = torch.cuda.get_device_name(0)
    print(f"card: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{kind}")
    # fp32 matrix products in full fp32 (no TF32) for every comparison
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from hetu_tpu_torch.models.gpt import GPTConfig
    from hetu_tpu_torch.models.llama import LlamaConfig
    from hetu_tpu_torch.ops.cuda import build
    t0 = time.perf_counter()
    reports = build.build()
    for name, rep in reports.items():
        print(f"--- nvcc -Xptxas -v: {name}")
        print(rep.strip())
    print(f"build: {len(reports)} kernels in "
          f"{time.perf_counter() - t0:.2f}s")
    ptxas_check(reports["flash_attention"], "flash_bwd_dq_wgmma_kernel")
    for kernel in ("flash_fwd_mma_kernel", "flash_bwd_dkv_mma_kernel"):
        ptxas_check(reports["flash_attention"], kernel)
    for lib in ("paged_attention_bf16", "paged_attention_f32",
                "paged_attention_f16"):
        ptxas_check(reports[lib], "paged_split_kernel")
        ptxas_check(reports[lib], "paged_merge_kernel")
    ptxas_check(reports["swiglu"], "swiglu_fwd_kernel")
    ptxas_check(reports["rotary"], "rotary_qk_kernel")
    for kernel in ("rmsnorm_fwd_kernel", "rmsnorm_bwd_kernel",
                   "layernorm_fwd_kernel", "layernorm_bwd_kernel"):
        ptxas_check(reports["fused_norm"], kernel)
    ptxas_check(reports["quant"], "quantize_kernel")
    mark('build')
    for kernel in ("write_kv_tokens_kernel", "write_kv_pages_kernel"):
        ptxas_check(reports["kv_write"], kernel)

    # each path runs beside its own kernel checks: serving first, so
    # the training kernels' large buffers and CUDA graphs come after it
    kernels = kernel_table()
    cases = serving_kernel_phase(args.seed)
    cases.update(serving2_kernel_phase(args.seed))
    cases.update(serving3_kernel_phase(args.seed))
    mark('serving kernels')
    gc.collect()
    torch.cuda.empty_cache()
    int4_path = reference_phase(args.seed, kernels)
    mark('serving reference')
    gc.collect()
    torch.cuda.empty_cache()
    # the serving paths first: a kernel's `launches` is its count on the
    # first path that ran it
    by_path = serving_phase(args.seed, kernels)
    by_path["reference_int4"] = int4_path
    mark('serving, serving2, serving3')
    gc.collect()
    torch.cuda.empty_cache()
    for name, more in training_kernel_phase(args.seed).items():
        cases.setdefault(name, []).extend(more)
    training_reference_phase(args.seed)
    llama = LlamaConfig.llama3_8b
    by_path["training"] = training_phase(
        args.seed, kernels, smi,
        llama(num_hidden_layers=8, remat_policy="dots_attn"),
        name="Llama-3-8B widths", gbs=4, mbs=2, seq=2048, steps=6,
        time_it=True)
    mark('training')
    gc.collect()
    torch.cuda.empty_cache()
    # the first training slice's path, cut to 2 layers and 2 steps
    by_path["training_dense"] = training_phase(
        args.seed, kernels, smi,
        llama(num_hidden_layers=2, use_flash_attention=False),
        name="Llama-3-8B widths", gbs=4, mbs=2, seq=2048, steps=2,
        time_it=False)
    mark('training_dense')
    gc.collect()
    torch.cuda.empty_cache()
    # the GPT family: its kernel (the LayerNorm arm) and the sampler at
    # its head, the narrow card-vs-CPU check, then training and serving
    # GPT-2-large at full depth
    for name, more in gpt_kernel_phase(args.seed).items():
        cases.setdefault(name, []).extend(more)
    gpt_reference_phase(args.seed)
    mark('gpt kernels and reference')
    gc.collect()
    torch.cuda.empty_cache()
    by_path["gpt_training"] = training_phase(
        args.seed, kernels, smi, GPTConfig.gpt2_large(),
        name="GPT-2-large", gbs=16, mbs=8, seq=1024, steps=6, time_it=True)
    mark('gpt training')
    gc.collect()
    torch.cuda.empty_cache()
    by_path.update(gpt_serving_phase(args.seed, kernels))
    mark('gpt serving')
    # the draft forward's shapes, after each kernel's own paths' cases
    for name, more in draft_kernel_phase(args.seed).items():
        cases[name].extend(more)
    gc.collect()
    torch.cuda.empty_cache()
    # the third training slice: bf16 parameters, the dynamic scale,
    # dropout, checkpoints and the repaired and new recompute policies
    t0 = time.perf_counter()
    training3_reference_phase(args.seed, smi)
    gc.collect()
    torch.cuda.empty_cache()
    by_path["training3_gpt"] = training3_gpt_phase(args.seed, kernels, smi)
    gc.collect()
    torch.cuda.empty_cache()
    by_path.update(training3_llama_phase(args.seed, kernels, smi))
    print(f"training3: {time.perf_counter() - t0:.1f}s; {smi}")
    mark('training3')
    gc.collect()
    torch.cuda.empty_cache()
    # the fourth training slice: the fp16 arms, fp16 compute with the
    # scale on "auto", and batches from the data stack
    t0 = time.perf_counter()
    for name, more in training4_kernel_phase(args.seed).items():
        cases.setdefault(name, []).extend(more)
    training4_reference_phase(args.seed, smi)
    training4_packed_phase(args.seed, smi)
    gc.collect()
    torch.cuda.empty_cache()
    by_path["training4_llama"] = training4_llama_phase(args.seed, kernels,
                                                       smi)
    gc.collect()
    torch.cuda.empty_cache()
    by_path["training4_gpt"] = training4_gpt_phase(args.seed, kernels, smi)
    print(f"training4: {time.perf_counter() - t0:.1f}s; {smi}")
    mark('training4')
    gc.collect()
    torch.cuda.empty_cache()
    # LoRA fine-tuning with the run-log, health and numerics hooks
    t0 = time.perf_counter()
    lora_reference_phase(args.seed, smi)
    gc.collect()
    torch.cuda.empty_cache()
    by_path["lora"] = lora_llama_phase(args.seed, kernels, smi)
    gc.collect()
    torch.cuda.empty_cache()
    lora_multitask_phase(args.seed, smi)
    lora_identity_phase(args.seed, kernels, smi)
    print(f"lora: {time.perf_counter() - t0:.1f}s; {smi}")
    mark('lora')
    gc.collect()
    torch.cuda.empty_cache()
    # the serving host layers: policies and failover, disaggregated
    # prefill/decode, the replica frontend
    by_path.update(serving4_phase(args.seed, kernels, smi))
    mark('serving4')
    gc.collect()
    torch.cuda.empty_cache()
    # Mixture-of-Experts: card vs CPU, serving and training at
    # Mixtral-8x7B widths, the kernels at the MoE shapes
    moe_paths, moe_cases = moe_phase(args.seed, kernels, smi)
    by_path.update(moe_paths)
    mark('moe')
    for name, more in moe_cases.items():
        cases[name].extend(more)
    gc.collect()
    torch.cuda.empty_cache()
    # fp16 serving: the serving kernels' fp16 arms, a narrow fp16 Llama
    # card vs CPU, Llama-2-7B as published in fp16
    f16_paths, f16_cases = serving_fp16_phase(args.seed, kernels, smi)
    by_path.update(f16_paths)
    cases.update(f16_cases)
    mark('serving_fp16')
    gc.collect()
    torch.cuda.empty_cache()
    # fp16 parameters: AdamW's fp16 arm, the kernels at Llama-2-13B's
    # widths, Llama-2-7B trained and Llama-2-13B LoRA-tuned, merged, served
    f16p_paths, f16p_cases = fp16_params_phase(args.seed, kernels, smi)
    by_path.update(f16p_paths)
    for name, more in f16p_cases.items():
        cases.setdefault(name, []).extend(more)
    mark('fp16_params')

    line = []
    for name, (mod, attr, source, replaces) in kernels.items():
        head = cases[name][0]       # the first path's first shape
        counts = {path: n[name] for path, n in by_path.items()}
        line.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": next((n for n in counts.values() if n), 0),
            "launches_by_path": counts,
            **({"launches_by_arm": dict(ADAM_ARMS)}
               if name == "adam_update" else {}),
            "max_abs_err": max(c["max_abs_err"] for c in cases[name]),
            "ms": head["ms"], "kernel_ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "composition_ms": head["composition_ms"],
            "cases": cases[name]})
    print(json.dumps({"kernels": line}))
    print(f"total {time.perf_counter() - t_start:.1f}s")
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
