"""Control Barrier Function rows via ``torch.func`` autodiff (counterpart
of ``mpc_cbf_tpu/ops/cbf.py``).

Replaces the reference's GiNaC symbolic pipeline
(``workspace/lib/cbf/src/detail/FovCBF.cpp``,
``workspace/lib/cbf/src/detail/ConnectivityCBF.cpp``): barriers are plain
functions ``h(x)`` of one state; Lie derivatives come from nested
``torch.func.grad``; callers batch them with ``torch.func.vmap``.

Conventions (matching the reference):
- state x = [px, py, th, vx, vy, w]  (6,)
- control u = [ax, ay, alpha]        (3,)
- continuous dynamics xdot = f(x) + g u with f = [vx, vy, w, 0, 0, 0],
  g = [[0],[I3]]  (FovCBF.cpp:66-88)
- every constraint family yields a row (a, b) meaning  a . u + b >= 0;
  QP assemblies negate it into ``-a . u <= b``
  (FovQPGenerator.cpp:13-37: coefficients = -Ac, ub = Bc).

Relative-degree-2 rows (safety / FOV borders / range, FovCBF.cpp:159-241):
    a = grad(L_f h) . g
    b = L_f^2 h + L_f(alpha(h)) + alpha(L_f h + alpha(h))
Relative-degree-1 rows (velocity boxes, FovCBF.cpp:543-574):
    a = grad(h) . g
    b = L_f h + h              (linear alpha, gamma=1)

Row methods take one state (callers batch them with ``torch.func.vmap``);
``ConnectivityCBF.adjacency`` and ``lambda2`` take leading batch axes
themselves, since ``torch.linalg.eigh`` is batched.
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import numpy as np
import torch
from torch.func import grad, jacrev

from mpc_cbf_torch.types import BIG

Tensor = torch.Tensor


def _vel_rows(vmin: np.ndarray, vmax: np.ndarray, x: Tensor) -> Tuple[Tensor, Tensor]:
    """All 6 velocity barriers: (A [6,3], b [6]); first 3 are max
    (vmax - v), then 3 min (v - vmin) (FovCBF.cpp:112-147).

    L_f h = 0 for these barriers, so a = -+e_d and b = alpha(h) = h.
    """
    v = x[3:6]
    eye = torch.eye(3, dtype=x.dtype, device=x.device)
    # python floats, so no tensor is copied from the host per call
    h_max = torch.stack([float(vmax[d]) - v[d] for d in range(3)])
    h_min = torch.stack([v[d] - float(vmin[d]) for d in range(3)])
    return torch.cat([-eye, eye]), torch.cat([h_max, h_min])


#: most matrices one torch.linalg.eigh call is given. cuSOLVER's batched
#: syev (torch 2.11, CUDA 12.8, H100) answers CUSOLVER_STATUS_INVALID_VALUE
#: for 32 767 matrices and more, of any size tried (4, 8, 32); 16 384 work
#: (scripts/eigh_batch_limit.py).
EIGH_MAX_BATCH = 16384


def batched_eigh(L: Tensor) -> Tuple[Tensor, Tensor]:
    """torch.linalg.eigh of L [..., n, n], in slices of EIGH_MAX_BATCH. Each
    call reads the library's error flag back: one wait for the device per
    slice (there is no eigh that skips the check)."""
    n = L.shape[-1]
    flat = L.reshape(-1, n, n)
    if flat.shape[0] <= EIGH_MAX_BATCH:
        return torch.linalg.eigh(L)
    vals, vecs = zip(*(torch.linalg.eigh(part) for part in flat.split(EIGH_MAX_BATCH)))
    return (torch.cat(vals).reshape(*L.shape[:-2], n),
            torch.cat(vecs).reshape(L.shape))


# Continuous-time dynamics ---------------------------------------------------


def f_drift(x: Tensor) -> Tensor:
    """f(x) = [vx, vy, w, 0, 0, 0]."""
    return torch.cat([x[3:6], torch.zeros_like(x[3:6])])


# g is constant: u enters the velocity block directly.
def _g_matmul(v: Tensor) -> Tensor:
    """v . g for a 6-gradient v -> 3-row: picks the velocity block."""
    return v[3:6]


# Alpha functions -------------------------------------------------------------


def alpha_linear(gamma: float) -> Callable[[Tensor], Tensor]:
    return lambda s: gamma * s


def alpha_cubic(gamma: float) -> Callable[[Tensor], Tensor]:
    return lambda s: gamma * s**3


def alpha_fifth(gamma: float) -> Callable[[Tensor], Tensor]:
    return lambda s: gamma * s**5


# Generic row builders --------------------------------------------------------


def rel_deg2_row(h_fn: Callable[[Tensor], Tensor], alpha: Callable[[Tensor], Tensor],
                 x: Tensor) -> Tuple[Tensor, Tensor]:
    """(a, b) for a relative-degree-2 barrier at state x.

    Mirrors FovCBF::initSafetyCBF's structure (FovCBF.cpp:159-241) with
    torch.func.grad in place of GiNaC::diff.
    """
    h = h_fn(x)

    def lfh_fn(xx):
        return torch.dot(grad(h_fn)(xx), f_drift(xx))

    lfh = lfh_fn(x)
    grad_lfh = grad(lfh_fn)(x)
    lf2h = torch.dot(grad_lfh, f_drift(x))
    a = _g_matmul(grad_lfh)

    def alpha_h_fn(xx):
        return alpha(h_fn(xx))

    lf_alpha = torch.dot(grad(alpha_h_fn)(x), f_drift(x))
    b = lf2h + lf_alpha + alpha(lfh + alpha(h))
    return a, b


def rel_deg1_row(h_fn: Callable[[Tensor], Tensor], alpha: Callable[[Tensor], Tensor],
                 x: Tensor) -> Tuple[Tensor, Tensor]:
    """(a, b) for a relative-degree-1 barrier (FovCBF.cpp:543-574)."""
    grad_h = grad(h_fn)(x)
    lfh = torch.dot(grad_h, f_drift(x))
    a = _g_matmul(grad_h)
    b = lfh + alpha(h_fn(x))
    return a, b


# ---------------------------------------------------------------------------
# FoV CBF family (FovCBF.cpp)
# ---------------------------------------------------------------------------


def _rel_target(x: Tensor, target_xy: Tensor) -> Tuple[Tensor, Tensor]:
    """Target position in the robot body frame (FovCBF.cpp:161-168)."""
    dx = target_xy[0] - x[0]
    dy = target_xy[1] - x[1]
    c, s = torch.cos(x[2]), torch.sin(x[2])
    return c * dx + s * dy, -s * dx + c * dy


class FovCBF:
    """Field-of-view CBF family vs a 2D target.

    Each family is a method returning (a, b) with a . u + b >= 0 for one
    (6,) state and (2,) target; callers batch with ``torch.func.vmap``.

    Parameters mirror FovCBF::FovCBF(fov, safety_dist, max_dist, vmin, vmax).
    """

    def __init__(self, fov: float, safety_dist: float, max_dist: float,
                 vmin, vmax, gamma: float = 0.1):
        self.fov = float(fov)
        self.Ds = float(safety_dist)
        self.Rs = float(max_dist)
        self.vmin = np.asarray(vmin, np.float64)
        self.vmax = np.asarray(vmax, np.float64)
        self.alpha = alpha_fifth(gamma)

    # barrier functions -----------------------------------------------------
    def _h_safety(self, target_xy):
        def h(x):
            xr, yr = _rel_target(x, target_xy)
            return xr * xr + yr * yr - self.Ds**2
        return h

    def _h_range(self, target_xy):
        def h(x):
            xr, yr = _rel_target(x, target_xy)
            return self.Rs**2 - (xr * xr + yr * yr)
        return h

    def _h_border(self, target_xy, side: int):
        """side=+1 left border, side=-1 right border (FovCBF.cpp:247-449).

        fov < pi : tan(fov/2)*xr + side*yr
        fov == pi: xr
        pi < fov < 2pi: tan((2pi-fov)/2)*xr - side*yr
        fov >= 2pi: disabled (handled by caller).
        """
        fov = self.fov

        def h(x):
            xr, yr = _rel_target(x, target_xy)
            if fov < math.pi:
                return math.tan(fov / 2) * xr + side * yr
            elif abs(fov - math.pi) < 1e-12:
                return xr
            else:
                return math.tan((2 * math.pi - fov) / 2) * xr - side * yr
        return h

    def _border_disabled(self) -> bool:
        return self.fov >= 2 * math.pi - 1e-9

    # rows ------------------------------------------------------------------
    def safety_row(self, x: Tensor, target_xy: Tensor):
        """(FovCBF.cpp:159-241; oracle getSafetyConstraints/Bound:622-768)."""
        return rel_deg2_row(self._h_safety(target_xy), self.alpha, x)

    def range_row(self, x: Tensor, target_xy: Tensor):
        """(FovCBF.cpp:455-535)."""
        return rel_deg2_row(self._h_range(target_xy), self.alpha, x)

    def lb_row(self, x: Tensor, target_xy: Tensor):
        """Left FOV border (FovCBF.cpp:247-345)."""
        if self._border_disabled():
            return torch.zeros_like(x[:3]), torch.full_like(x[0], BIG)
        return rel_deg2_row(self._h_border(target_xy, +1), self.alpha, x)

    def rb_row(self, x: Tensor, target_xy: Tensor):
        """Right FOV border (FovCBF.cpp:351-449)."""
        if self._border_disabled():
            return torch.zeros_like(x[:3]), torch.full_like(x[0], BIG)
        return rel_deg2_row(self._h_border(target_xy, -1), self.alpha, x)

    def vel_rows(self, x: Tensor):
        """The 6 velocity barriers of one state: (A [6,3], b [6])."""
        return _vel_rows(self.vmin, self.vmax, x)


# ---------------------------------------------------------------------------
# Connectivity CBF family (ConnectivityCBF.cpp)
# ---------------------------------------------------------------------------


class ConnectivityCBF:
    """Pairwise safety + lambda2-connectivity + CLF + velocity barriers.

    Mirrors ConnectivityCBF(min_dist, max_dist, vmin, vmax)
    (ConnectivityCBF.cpp:42-148). gamma=5, epsilon=0.1.
    """

    def __init__(self, min_dist: float, max_dist: float, vmin, vmax,
                 gamma: float = 5.0, epsilon: float = 0.1,
                 d_desired: float = 2.0, beta1: float = 5.0, beta2: float = 2.0):
        self.dmin = float(min_dist)
        self.dmax = float(max_dist)
        self.vmin = np.asarray(vmin, np.float64)
        self.vmax = np.asarray(vmax, np.float64)
        self.gamma = gamma
        self.epsilon = epsilon
        self.d_desired = d_desired
        self.beta1, self.beta2 = beta1, beta2
        self.alpha_safety = alpha_cubic(gamma)
        self.alpha_conn = alpha_linear(gamma)

    @property
    def sigma(self) -> float:
        """dmax^4 / ln 2 (ConnectivityCBF.cpp:381-383)."""
        return self.dmax**4 / math.log(2.0)

    # pairwise safety -------------------------------------------------------
    def safety_row(self, x: Tensor, neighbor_state: Tensor):
        """h = ||p - p_n||^2 - dmin^2 vs a (>=5,) neighbor state
        [px_n, py_n, ..., vx_n, vy_n] laid out like the ego state.

        The reference hand-derives the Lie terms with the *neighbor velocity
        in the drift* (ConnectivityCBF.cpp:152-198): L_f h = 2 dp . dv,
        L_f^2 h = 2 dv . dv, Ac = [2 dx, 2 dy, 0].
        """
        dx = x[0] - neighbor_state[0]
        dy = x[1] - neighbor_state[1]
        dvx = x[3] - neighbor_state[3]
        dvy = x[4] - neighbor_state[4]
        h = dx * dx + dy * dy - self.dmin**2
        lfh = 2.0 * (dx * dvx + dy * dvy)
        lf2h = 2.0 * (dvx * dvx + dvy * dvy)
        alpha = self.alpha_safety
        # L_f(alpha(h)): grad(alpha(h)) . f — alpha(h) depends on ego px,py
        # only; the reference differentiates wrt ego state so the neighbor
        # velocity does NOT appear here (ConnectivityCBF.cpp:170-186).
        dalpha_dh = 3.0 * self.gamma * h * h
        lf_alpha = dalpha_dh * (2.0 * dx * x[3] + 2.0 * dy * x[4])
        b = lf2h + lf_alpha + alpha(lfh + alpha(h))
        a = torch.stack([2.0 * dx, 2.0 * dy, torch.zeros_like(dx)])
        return a, b

    # CLF -------------------------------------------------------------------
    def clf_row(self, x: Tensor, neighbor_state: Tensor):
        """V = (||dp|| - d_desired)^2; row (a, b) with Bc = L_f^2 V +
        beta1 L_f V + beta2 V (ConnectivityCBF.cpp:200-245).

        Note: the generator uses this as  a . u <= -b  ("<= -getCLFBound",
        ConnectivityQPGenerator.cpp:44-59), callers handle the sign. At
        zero distance (the ego against itself) the row is NaN; callers mask
        it with ``torch.where`` on the value.
        """
        d_des = self.d_desired

        def V_fn(xx):
            dx = xx[0] - neighbor_state[0]
            dy = xx[1] - neighbor_state[1]
            dist = torch.sqrt(dx * dx + dy * dy)
            return (dist - d_des) ** 2

        def lfV_fn(xx):
            g = grad(V_fn)(xx)
            return g[0] * xx[3] + g[1] * xx[4]

        V = V_fn(x)
        lfV = lfV_fn(x)
        grad_lfV = grad(lfV_fn)(x)
        # reference Lf2V uses only the position partials times velocity
        lf2V = grad_lfV[0] * x[3] + grad_lfV[1] * x[4]
        a = torch.stack([grad_lfV[3], grad_lfV[4], torch.zeros_like(grad_lfV[3])])
        b = lf2V + self.beta1 * lfV + self.beta2 * V
        return a, b

    # lambda2 connectivity --------------------------------------------------
    def adjacency(self, positions: Tensor) -> Tensor:
        """Weighted adjacency A_ij = exp((Rs^2 - d_ij^2)^2 / sigma) - 1 for
        d_ij <= Rs else 0 (ConnectivityCBF.cpp:390-409). positions [..., N, 2]."""
        diff = positions[..., :, None, :] - positions[..., None, :, :]
        d2 = torch.sum(diff * diff, dim=-1)
        w = torch.exp((self.dmax**2 - d2) ** 2 / self.sigma) - 1.0
        n = positions.shape[-2]
        off_diag = ~torch.eye(n, dtype=torch.bool, device=positions.device)
        return torch.where((d2 <= self.dmax**2) & off_diag, w, torch.zeros_like(w))

    def lambda2(self, positions: Tensor, node_mask: Tensor = None) -> Tuple[Tensor, Tensor]:
        """Second-smallest Laplacian eigenvalue [...] and its unit eigenvector
        [..., N] (ConnectivityCBF.cpp:390-424). positions [..., N, 2].

        The eigenvector is defined up to its sign, and up to a rotation of
        the eigenspace where lambda2 is repeated; ``conn_row`` uses it only
        through (v_i - v_j)^2, so the sign drops out.

        node_mask [..., N] (optional): absent nodes are DEFLATED out. Their
        adjacency rows/cols are zeroed and a large diagonal shift pushes
        their (otherwise zero) eigenvalues above the real spectrum, so
        vals[1] is the lambda2 of the present-node subgraph with fixed
        shapes. The shift (1e3) dominates the true spectrum: edge weights
        are bounded by exp(Rs^4/sigma) - 1 = 1, so lambda_max <= 2N for any
        sane N. The reference has no masking (fixed team size)."""
        A = self.adjacency(positions)
        if node_mask is not None:
            pair = node_mask[..., :, None] & node_mask[..., None, :]
            A = torch.where(pair, A, torch.zeros_like(A))
        L = torch.diag_embed(torch.sum(A, dim=-1)) - A
        if node_mask is not None:
            L = L + 1e3 * torch.diag_embed((~node_mask).to(L.dtype))
        vals, vecs = batched_eigh(L)
        v = vecs[..., :, 1]
        v = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
        return vals[..., 1], v

    def _grad_h_agent(self, p_i: Tensor, positions: Tensor, eigvec: Tensor,
                      is_self: Tensor) -> Tensor:
        """d lambda2 / d p_i via the eigenvector formula (12):
        sum_j dA_ij/dp_i * (v_i - v_j)^2, with NO range cutoff, matching
        compute_full_grad_h (ConnectivityCBF.cpp:426-469) which omits the
        cutoff present in the numeric adjacency.

        p_i (2,) stands for robot i's position (the point differentiated
        at); positions [N, 2]; is_self [N] bool marks robot i, whose own
        term is masked out, so positions needs no write. Returns (2,)."""
        diff = p_i[None, :] - positions  # [N, 2]
        d2 = torch.sum(diff * diff, dim=-1)
        rs2 = self.dmax**2
        expo = torch.exp((rs2 - d2) ** 2 / self.sigma)  # = A_ij + 1
        # dA_ij/dx_i = -4 (A_ij + 1) (Rs^2 - d^2)/sigma * dx
        coef = -4.0 * expo * (rs2 - d2) / self.sigma
        v_self = torch.sum(torch.where(is_self, eigvec, torch.zeros_like(eigvec)))
        vdiff2 = (v_self - eigvec) ** 2
        contrib = (coef * vdiff2)[:, None] * diff  # [N, 2]
        return torch.sum(torch.where(is_self[:, None], torch.zeros_like(contrib), contrib),
                         dim=0)

    def conn_row(self, x: Tensor, robot_states: Tensor, eigvec: Tensor, h_val: Tensor,
                 self_idx) -> Tuple[Tensor, Tensor]:
        """(a, b) for h = lambda2 - epsilon at robot self_idx (an int or a
        0-d integer tensor).

        robot_states [N, 6]; eigvec [N] (held constant in differentiation,
        as in the reference where eigenvec_i are plain symbols);
        h_val is the numeric lambda2 - epsilon substituted at call time
        (ConnectivityCBF.cpp:471-552).

        b = L_f^2 h + gamma*L_f h + gamma*(L_f h + gamma*h_val)
        with L_f h = grad_i . v_i and L_f^2 h = v_i' Hess_i v_i where the
        Hessian is taken wrt this robot's own position only.
        """
        positions = robot_states[:, :2]
        is_self = torch.arange(positions.shape[0], device=positions.device) == self_idx

        def grad_fn(p_i):
            return self._grad_h_agent(p_i, positions, eigvec, is_self)

        p_self = torch.sum(torch.where(is_self[:, None], positions,
                                       torch.zeros_like(positions)), dim=0)
        grad_i = grad_fn(p_self)  # (2,)
        hess_i = jacrev(grad_fn)(p_self)  # (2, 2)
        v_self = x[3:5]
        lfh = torch.dot(grad_i, v_self)
        lf2h = torch.dot(v_self, hess_i @ v_self)
        g5 = self.alpha_conn
        b = lf2h + g5(lfh) + g5(lfh + g5(h_val))
        a = torch.cat([grad_i, torch.zeros_like(grad_i[:1])])
        return a, b

    def vel_rows(self, x: Tensor):
        """Same construction as FovCBF.vel_rows (ConnectivityCBF.cpp:105-141)."""
        return _vel_rows(self.vmin, self.vmax, x)
