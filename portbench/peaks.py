"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W limit): HBM3 bandwidth and the float32 and float64 rates outside
the tensor cores."""

BYTES_PER_S = 3.35e12
F32_PER_S = 67e12
F64_PER_S = 34e12
