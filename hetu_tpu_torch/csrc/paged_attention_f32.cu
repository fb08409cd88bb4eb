// Paged attention, the fp32 query arm: its exported symbols over the
// kernels of paged_attention.cuh (see there: what they compute, what
// bounds them, the design).
#include "paged_attention.cuh"

PA_EXPORTS(float, _f32)
