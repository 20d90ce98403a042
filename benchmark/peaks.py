"""Published peaks of one NVIDIA H100 SXM (dense, no sparsity), the
yardstick of every roofline and utilization share the benchmark reports.

bf16 on the tensor cores 989 TFLOP/s, TF32 495 TFLOP/s, HBM3 3.35 TB/s.
Float32 work is counted at the TF32 tensor rate over three (3xTF32, the
cheapest float32-accurate route the card offers and the one the port's
K1 takes): 165 TFLOP/s. A share is the least time the card needs for
the work, ``max(flops / rate, bytes / PEAK_BYTES_S)``, over the time
measured. The rates assume the card's full 700 W; the run prints the
card's power limit beside them."""

PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_F32_FLOPS = PEAK_TF32_FLOPS / 3
PEAK_BYTES_S = 3.35e12

RATES = {"float32": PEAK_F32_FLOPS, "bfloat16": PEAK_BF16_FLOPS}


def least_seconds(flops: float, nbytes: float, dtype: str):
    """(least seconds, "operations" or "bytes"): the bound of the work."""
    t_ops = flops / RATES[dtype]
    t_bytes = nbytes / PEAK_BYTES_S
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")
