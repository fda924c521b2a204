"""The least time an H100 could take for the structured ADMM's iteration
loop alone (the K3 kernel's work), from the shapes, the rho phases and the
lanes alone.

The C form of ``portbench.roofline`` without the operand build, which runs
outside the kernel (``folded_c``): per lane and iteration [A_s; A_d]' r and
[A_s; A_d] x in float32 (2 x 2 m n operations), or the two products with the
shared A_s (2 m_s n multiply-adds) as 3xTF32 on the tensor cores beside A_d's
in float32, and xt = C RHS in float64 (2 n^2). The pipes run at their own
peaks, so the slowest sets a form's time. The bytes of a launch are each
input read once and each output written once: the lane's vectors, its rows
A_d and its float64 C, and the shared A_s and rho_s. The bound is the
faster form, or the bytes where they take longer.
"""

from __future__ import annotations

from typing import Sequence

from portbench.roofline import PEAK_BYTES, PEAK_F32, PEAK_F64, PEAK_TF32


def k3_bound_s(B: int, n: int, m_s: int, m_d: int, phases: Sequence[int]) -> float:
    """Seconds: the least time for B lanes through one launch of the loop per
    entry of ``phases`` (its iterations each), C given."""
    m, its, launches = m_s + m_d, sum(phases), len(phases)
    xt = its * 2 * n * n / PEAK_F64
    plain = max(its * 2 * 2 * m * n / PEAK_F32, xt)
    tensor = max(its * 3 * 2 * 2 * m_s * n / PEAK_TF32, its * 2 * 2 * m_d * n / PEAK_F32, xt)
    lane_bytes = 4 * (2 * n + 4 * m_s + 5 * m_d + n * m_d) + 4 * (n + 2 * m) + 8 * n * n
    shared_bytes = 4 * (m_s * n + m_s)
    return max(B * min(plain, tensor), launches * (B * lane_bytes + shared_bytes) / PEAK_BYTES)
