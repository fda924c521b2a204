"""The least time an H100 could take for the structured ADMM's work of a
step, from the shapes, the rho phases and the lanes alone.

A frozen copy of the program's own bound (``chip_smoke.py::bound``) with
one change: it does not ask the program which operand a shape takes. It
takes the fastest known form of the loop, whatever route the program runs:

- the C form: per lane and iteration [A_s; A_d]' r and [A_s; A_d] x in
  float32 (2 x 2 m n operations) and C RHS in float64 (2 n^2); the operand
  C = (M_s + A_d' R A_d)^-1 built once a phase in float64 (2 (n m_d n + n^3));
- the Woodbury form: [A_s; A_d]' r, A_d S and [A_s; A_d] x in float32
  (2 (2 m n + m_d n)), Ms_inv RHS and WK t in float64 (2 (n^2 + n m_d)); the
  operand WK built once a phase in float32 (2 (n n m_d + 2 n m_d^2 + m_d^3));
- either form with its two products with the shared A_s (2 m_s n
  multiply-adds an iteration) as 3xTF32 on the tensor cores.

float32, float64 and the TF32 tensor cores run at their own peaks on pipes
of their own, so the slowest pipe sets a form's time; a form's bytes are
each input read once and each output written once a launch; the bound is
the fastest form. The operand's build counts, as it is work of the step.
"""

from __future__ import annotations

from typing import Sequence

#: NVIDIA H100 SXM data sheet, dense rates: float32 and float64 outside the
#: tensor cores, TF32 on them, HBM3 bandwidth (bytes/s)
PEAK_F32, PEAK_F64, PEAK_TF32, PEAK_BYTES = 67e12, 67e12, 495e12, 3.35e12


def admm_bound_s(B: int, n: int, m_s: int, m_d: int, phases: Sequence[int]) -> float:
    """Seconds: the least time for B lanes through one launch per entry of
    ``phases`` (its iterations each)."""
    m, its, launches = m_s + m_d, sum(phases), len(phases)
    tf32 = its * 3 * 2 * 2 * m_s * n / PEAK_TF32
    build_c = launches * 2 * (n * m_d * n + n ** 3)
    build_wk = launches * 2 * (n * n * m_d + 2 * n * m_d * m_d + m_d ** 3)
    io = 4 * (2 * n + 4 * m_s + 5 * m_d + n * m_d) + 4 * (n + 2 * m)
    shared = 4 * (m_s * n + m_s)
    c_f64 = (its * 2 * n * n + build_c) / PEAK_F64
    wk_f64 = its * 2 * (n * n + n * m_d) / PEAK_F64
    forms = (   # (seconds of operations a lane, bytes a lane a launch, shared bytes)
        (max(its * 2 * 2 * m * n / PEAK_F32, c_f64), io + 8 * n * n, shared),
        (max(tf32, its * 2 * 2 * m_d * n / PEAK_F32, c_f64), io + 8 * n * n, shared),
        (max((its * 2 * (2 * m * n + m_d * n) + build_wk) / PEAK_F32, wk_f64),
         io + 4 * n * m_d, shared + 4 * n * n),
        (max(tf32, (its * 2 * 3 * m_d * n + build_wk) / PEAK_F32, wk_f64),
         io + 4 * n * m_d, shared + 4 * n * n),
    )
    return min(max(B * ops, launches * (B * per_lane + sh) / PEAK_BYTES)
               for ops, per_lane, sh in forms)
