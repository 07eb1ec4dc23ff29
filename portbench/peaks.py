"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W limit)."""

#: FLOP/s by the dtype an operation computes in
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12,
              "float32": 67e12, "float8": 1979e12}
#: HBM3 bytes/s
HBM_BYTES_PER_S = 3.35e12


def least_seconds(flops: float, nbytes: float, dtype: str) -> float:
    """The least time the chip could take: the larger of the operations
    over the peak rate and the bytes over the memory bandwidth."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)
