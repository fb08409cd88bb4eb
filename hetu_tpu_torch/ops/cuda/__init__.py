"""Hand-written CUDA kernels for Hopper (sm_90a), one module per kernel.

Each module holds the kernel's wrapper, its plain PyTorch version and a
launch counter:

  * paged_attention — decode attention over the serving KV pool's page
                      tables (replaces ops/pallas/paged_attention.py)
  * rotary          — RoPE on q AND k in one launch, and its backward
                      (replaces ops/pallas/rotary.py)
  * swiglu          — silu(gate) * up in one pass, and its backward
                      (replaces ops/pallas/swiglu.py)
  * fused_norm      — residual add + RMSNorm, forward and backward
                      (replaces ops/pallas/fused_norm.py, RMS)
  * adam            — fused AdamW update per parameter leaf
                      (replaces ops/pallas/adam.py)
  * flash_attention — flash attention forward, and its dq and dk/dv
                      backward kernels
                      (replaces ops/pallas/flash_attention.py)

The routing rule is the device: each wrapper takes `device=` ("cuda"
by default) and its tensors must lie there.  On CUDA it launches the
kernel or raises; on the CPU it runs the plain version.  There is no
shape gate that quietly falls back, and no try/except around a launch.
`launches` (and `bwd_launches`, `dq_launches`, `dkv_launches`) in each
module counts kernel launches only (the plain
version never counts), so a run can prove its path went through the
kernels.  Sources live in `hetu_tpu_torch/csrc/`; `build.py` compiles
them at first use.
"""
