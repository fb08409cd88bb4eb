"""hetu_tpu_torch: the PyTorch/CUDA port of hetu_tpu for NVIDIA Hopper.

The JAX package `hetu_tpu` is the reference; this package grows beside
it, slice by slice, keeping its module layout and names so each module
has a findable counterpart.  It imports torch and numpy only — never
jax, never `hetu_tpu` (whose package import loads JAX).

This slice is the serving main path: `serving.ServingEngine` over
`models.llama.LlamaLMHeadModel`, with hand-written CUDA kernels for
paged-attention decode, fused RoPE and SwiGLU (`ops/cuda`, sources in
`csrc/`).  Entry points take a `device` argument that defaults to
"cuda"; a CPU tensor runs each kernel's plain PyTorch version.

Importing the package builds nothing: the kernels compile at first use
on a CUDA device (`ops.cuda.build`).
"""
