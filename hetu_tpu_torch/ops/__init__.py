"""Tensor ops of the port (`hetu_tpu/ops` counterparts): norms, rotary,
activations, and the CUDA kernels under `ops.cuda`."""
