"""Peak rates of one NVIDIA H100 SXM (80 GB HBM3) at its 700 W power limit,
from NVIDIA's data sheet: the least time the card could take for a piece
of work, the bound the port's measurements hold each kernel against."""

from __future__ import annotations

BYTES_PER_S = 3.35e12  # HBM3
FP32_FLOPS = 67e12  # float32 outside the tensor cores
BF16_TC_FLOPS = 989e12  # bf16 on the tensor cores, dense
# TF32 on the tensor cores, dense; f32 through 3xTF32 (csrc/attention.cu)
# does 3x the operations at this rate
TF32_TC_FLOPS = 495e12


def bound(nbytes: float, flops: float = 0.0, rate: float = FP32_FLOPS):
    """(ms, by): the larger of ``nbytes`` over the memory rate and
    ``flops`` over ``rate`` (the float32 rate unless given), in ms, and
    which of the two it is ("bytes" or "operations")."""
    t_bytes, t_ops = nbytes / BYTES_PER_S, flops / rate
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")
