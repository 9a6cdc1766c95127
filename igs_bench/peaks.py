"""Published peak rates of one NVIDIA H100 SXM (80 GB HBM3) at its 700 W
power limit, from NVIDIA's data sheet (dense, without sparsity), and the
least time a piece of work can take on it (a copy of the port's
``utils/h100.py``)."""

from __future__ import annotations

BYTES_PER_S = 3.35e12  # HBM3
FP32_FLOPS = 67e12  # float32 outside the tensor cores
BF16_TC_FLOPS = 989e12  # bf16 on the tensor cores
TF32_TC_FLOPS = 495e12  # TF32 on the tensor cores
# float32-accurate products on the tensor cores: three TF32 products each
F32_3XTF32_FLOPS = TF32_TC_FLOPS / 3

PEAKS = {"bf16": BF16_TC_FLOPS, "tf32": TF32_TC_FLOPS,
         "3xtf32": F32_3XTF32_FLOPS, "fp32": FP32_FLOPS}


def bound_s(nbytes: float, flops: float, rate: float):
    """(seconds, by): the larger of ``nbytes`` over the memory rate and
    ``flops`` over ``rate``, and which of the two it is."""
    t_bytes, t_ops = nbytes / BYTES_PER_S, flops / rate
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")
