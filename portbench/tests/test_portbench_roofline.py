"""The roofline count at the two connectivity shapes, against counts worked
by hand (H100 SXM peaks: 67 TFLOP/s float32 and float64, 495 TFLOP/s TF32,
3.35 TB/s)."""

import pytest

from portbench.roofline import admm_bound_s

STEP = (150, 50, 150, 50)          # two IMPC iterations of StructuredConfig(iters=200)


def hand(B, n, m_s, m_d):
    """The 3xTF32 C form, which is the fastest at these shapes: per lane
    its * 3 * 2 * 2 * m_s * n TF32 operations for the A_s products, beside
    its * 2 * 2 * m_d * n float32 and its * 2 * n^2 + 4 * 2 * (n m_d n + n^3)
    float64 ones; bytes far below."""
    its = sum(STEP)
    tf32 = its * 3 * 2 * 2 * m_s * n / 495e12
    f32 = its * 2 * 2 * m_d * n / 67e12
    f64 = (its * 2 * n * n + 4 * 2 * (n * m_d * n + n ** 3)) / 67e12
    return B * max(tf32, f32, f64)


@pytest.mark.parametrize("shape", [(36, 126, 6), (43, 133, 14)])
def test_bound_against_hand_count(shape):
    n, m_s, m_d = shape
    got = admm_bound_s(32768, n, m_s, m_d, STEP)
    assert got == pytest.approx(hand(32768, n, m_s, m_d), rel=1e-12)


def test_pinned_values():
    # (43, 133, 14): 400 * 3 * 2 * 2 * 133 * 43 = 27 451 200 TF32 operations a
    # lane, 5.5457e-8 s; x 32768 lanes = 1.81721 ms
    assert admm_bound_s(32768, 43, 133, 14, STEP) == pytest.approx(1.817214e-3, rel=1e-6)
    # (36, 126, 6): 400 * 12 * 126 * 36 = 21 772 800 a lane, 4.3985e-8 s; 1.44132 ms
    assert admm_bound_s(32768, 36, 126, 6, STEP) == pytest.approx(1.441315e-3, rel=1e-6)


def test_bytes_bind_at_few_iterations():
    """With one iteration a launch the bytes bound the form: 4 launches of
    32768 lanes reading and writing their lane's state and operand."""
    n, m_s, m_d = 43, 133, 14
    m = m_s + m_d
    io = 4 * (2 * n + 4 * m_s + 5 * m_d + n * m_d) + 4 * (n + 2 * m)
    by_bytes = min(4 * (32768 * (io + 8 * n * n) + 4 * (m_s * n + m_s)),
                   4 * (32768 * (io + 4 * n * m_d) + 4 * (m_s * n + m_s) + 4 * n * n)) / 3.35e12
    assert admm_bound_s(32768, n, m_s, m_d, (1, 1, 1, 1)) >= by_bytes * (1 - 1e-12)
