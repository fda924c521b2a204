"""The K3 loop's least time (``portbench.roofline_k3``) at conn32's lane
shape, against a count worked by hand and against the whole step's ADMM
bound (``portbench.roofline``), which adds the operand's build."""

import pytest

from portbench.roofline import admm_bound_s
from portbench.roofline_k3 import k3_bound_s

STEP = (150, 50, 150, 50)          # two IMPC iterations of StructuredConfig(iters=200)
CONN32 = (67, 157, 62)             # 32-robot connectivity team, slack on: (35 + R, 125 + R, 2R - 2)


def test_hand_count_at_conn32():
    """400 iterations a lane: the shared A_s products as 3xTF32, 400 * 3 * 2 *
    2 * 157 * 67 = 50 491 200 operations at 495 TFLOP/s (1.02e-7 s), above A_d's
    400 * 4 * 62 * 67 = 6 646 400 in float32 (9.9e-8 s), xt's 400 * 2 * 67^2 =
    3 591 200 in float64 (5.4e-8 s), and below the plain float32 form's 400 * 4 *
    219 * 67 = 23 476 800 (3.5e-7 s); 32768 lanes: 3.342 ms. The bytes, 4
    launches of 58 836 a lane (the lane's vectors, A_d, C in float64) and the
    shared A_s, take 2.30 ms: the TF32 pipe bounds the loop."""
    n, m_s, m_d = CONN32
    lane_bytes = 4 * (2 * n + 4 * m_s + 5 * m_d + n * m_d) + 4 * (n + 2 * (m_s + m_d)) + 8 * n * n
    assert lane_bytes == 58836
    by_bytes = 4 * (32768 * lane_bytes + 4 * (m_s * n + m_s)) / 3.35e12
    assert by_bytes == pytest.approx(2.3022e-3, rel=1e-4)
    want = 32768 * 50_491_200 / 495e12
    assert want == pytest.approx(3.34242e-3, rel=1e-5)
    assert k3_bound_s(32768, n, m_s, m_d, STEP) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("shape,below", [(CONN32, True), ((163, 253, 254), True),
                                         ((43, 133, 14), False), ((36, 126, 62), False)])
def test_loop_bound_below_the_step_bound(shape, below):
    """The loop alone takes no longer than the loop and the C builds of the same
    step, and less where the float64 of the builds bounds the step: at conn32
    the builds' 4 x 2 (67 * 62 * 67 + 67^3) operations a lane put the float64
    pipe (1.227e-7 s) above the TF32 one (1.020e-7 s). At conn8's (43, 133, 14)
    and the 32-agent (36, 126, 62) the TF32 pipe bounds both."""
    got = k3_bound_s(32768, *shape, STEP)
    step = admm_bound_s(32768, *shape, STEP)
    assert 0 < got <= step
    assert (got < step * (1 - 1e-9)) == below


def test_bytes_bind_at_few_iterations():
    """With one iteration a launch the bytes bound the loop: 4 launches of 32768
    lanes reading and writing their lane's state, rows and C."""
    n, m_s, m_d = CONN32
    lane_bytes = 58836
    by_bytes = 4 * (32768 * lane_bytes + 4 * (m_s * n + m_s)) / 3.35e12
    assert k3_bound_s(32768, n, m_s, m_d, (1, 1, 1, 1)) == pytest.approx(by_bytes, rel=1e-12)
