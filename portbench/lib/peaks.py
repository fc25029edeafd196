"""The table of peaks of one NVIDIA H100 and the least time an operation can take.

Published rates of the H100 SXM (NVIDIA's data sheet, dense, without
sparsity), which assume the full power limit of 700 W: a run prints the
card's own ``power.limit`` beside every share it reports against them.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "fp16": 989e12, "fp8": 1979e12, "int8": 1979e12,
                  "tf32": 495e12, "f32": 67e12}


def bound_s(n_bytes: float, ops: float, kind: str) -> float:
    """The least time the card could take: the larger of ``n_bytes`` (each
    input read once, each output written once) over the memory rate and
    ``ops`` over the peak rate of their type."""
    return max(n_bytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[kind])

