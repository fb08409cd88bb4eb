// Paged attention, the bf16 query arm: its exported symbols over the
// kernels of paged_attention.cuh (see there: what they compute, what
// bounds them, the design).
#include "paged_attention.cuh"

PA_EXPORTS(__nv_bfloat16, _bf16)
