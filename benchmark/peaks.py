"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit): float32 outside the tensor cores, and HBM3."""

F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
