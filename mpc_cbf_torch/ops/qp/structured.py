"""Structure-exploiting batched ADMM for the MPC-CBF QP family
(counterpart of ``mpc_cbf_tpu/ops/qp/structured.py``).

Across an agent/scenario batch the MPC QPs share almost everything: P,
the equality rows, the sampled accel/vel bound rows and the
slack-nonnegativity rows have identical coefficients (only their targets
differ per agent); only the CBF + separating-hyperplane rows (m_d ~ tens)
differ per agent. So A = [A_s (shared, m_s rows); A_d (per-problem, m_d
rows)], and the ADMM x-update solves with

    M_b = M_s + A_d' R_b A_d,   M_s = P + sigma I + A_s' diag(rho_s) A_s

M_s and its inverse Ms_inv are precomputed once at build time in float64
numpy. Each rho phase makes one per-lane operand of the x-update, and the
fixed-count iteration loop runs in the hand-written CUDA kernel of
``fused_admm.py`` (or its plain twin on the CPU). The operand's form is
decided by the shape alone (``fused_admm.takes_wk``):
- the tiled kernel's two shapes (connectivity and λ₂/CLF connectivity)
  keep the JAX package's Woodbury form: the folded correction
  WK = Ms_inv A_d' (R^-1 + A_d Ms_inv A_d')^-1 [B, n, m_d] (``woodbury``);
- every other shape, the fov flagship's too, takes C = M_b^-1 [B, n, n] in
  float64 (``folded_c``): a Cholesky of the lane's [n, n] SPD matrix where
  the Woodbury form inverts an [m_d, m_d] one (43 against 84 rows at the
  fov flagship, 163 against 1524 at a 128-agent fov team).
  A deliberate difference from the JAX package, which keeps the float32
  Woodbury form at every shape: the float32 cancellation between Ms_inv RHS
  and WK t (``fused_admm.structured_admm_iterations_ref``) is why C is
  float64, and a float32 [B, m_d, m_d] inverse of a team of hundreds of
  agents does not fit the card (four [256, 4572, 4572] tensors at 382
  agents, about 86 GB).

Left out on purpose (TPU-only in the JAX package):
- ``_chunked_inv`` / ``inv_chunk``: a VMEM workaround for XLA's blocked
  LU; the batched ``torch.linalg.inv_ex`` here has no such limit;
- ``pallas_block`` / ``pallas_interpret`` and the backend, x64 and VMEM
  gate of ``_solve``: replaced by one boolean, ``use_kernel`` (False: the
  plain PyTorch loop on any device).

``solve_polished`` runs ``solve`` (the kernel on the card) and then the
float64 active-set polish of ``polish.py`` on the same device.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from mpc_cbf_torch.types import BIG
from mpc_cbf_torch.ops.qp.fused_admm import (
    structured_admm_iterations, structured_admm_iterations_ref, takes_wk)
from mpc_cbf_torch.ops.qp.polish import PolishConfig, make_guards, polish_structured
from mpc_cbf_torch.utils import profiling

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class StructuredConfig:
    iters: int = 200
    sigma: float = 1e-6
    rho: float = 0.1
    rho_eq_scale: float = 1e3
    # Two-phase rho schedule, SOFT first then STIFF: the LAST
    # min(hi_frac*iters, hi_iters_cap) iterations scale rho by rho_hi_scale
    # on the slack-nonnegativity rows (polish_guard_rows) and the dynamic
    # (CBF/Voronoi) rows ONLY; tracking rows keep the soft rho throughout.
    # The full (x, z, y) state carries across the switch. rho_hi_scale=1 or
    # hi_frac=0 recovers single-phase. (The measurements behind these
    # defaults are in mpc_cbf_tpu/ops/qp/structured.py.)
    rho_hi_scale: float = 100.0
    hi_frac: float = 0.5
    hi_iters_cap: int = 50
    # iteration budget for WARM-started tail solves (IMPC iterations > 0):
    # None = same as iters. Consumed by StructuredIMPC, which builds a
    # second operator for the tail; this operator itself always runs iters.
    iters_tail: Optional[int] = None
    alpha: float = 1.6
    eps_pri: float = 5e-3     # f32 bar (relative)
    # iteration loop: True = the CUDA kernel for CUDA float32 tensors (a
    # CUDA tensor of another dtype raises) and the plain PyTorch loop for
    # CPU tensors; False = the plain loop on any device (the kernel's
    # reference)
    use_kernel: bool = True
    # lanes per chunk for the WHOLE solve (a Python loop over lane slices,
    # the last one may be shorter). The C form's precompute (folded_c) holds
    # per lane a float64 copy of A_d [m_d, n] and four float64 [n, n]
    # tensors (the product, its factor, the factor's inverse, C); at swarm
    # scale they dominate: a 400-agent fov lane is 23 MB. None = auto: off
    # below m_d = 128 (every WK-form shape), else the largest power of two,
    # at least 256, that keeps those tensors within 8 GB, a budget chosen
    # for an 80 GB card (the JAX package's 2.5 GB was sized for a 16 GB TPU
    # and its four [m_d, m_d] float32 tensors). 0 = off; k = k lanes.
    lane_chunk: Optional[int] = None
    # f64 active-set polish after the ADMM iterations (ops/qp/polish.py):
    # certifies a lane when its point is feasible and stationary to 1e-6
    # (relative) on a right-signed working set, which puts its controls
    # within ~1e-3 of the exact optimum; lanes that fail certification keep
    # their ADMM iterate. StructuredIMPC calls solve_polished when it is set.
    polish: bool = False


class StructuredSolution(NamedTuple):
    z: Tensor          # [B, n]
    pri_res: Tensor    # [B]
    converged: Tensor  # met the (loose, f32) ADMM bar — NOT the <1e-3 bar
    # lane certified to f64 optimality by the active-set polish
    # (solve_polished only; always False from solve)
    certified: Tensor
    # duals of the shared/dynamic rows in UNSCALED row coordinates
    # ([B, m_s] / [B, m_d]): feed back as ys0/yd0 to warm-start the next
    # solve of a nearby problem
    ys: Tensor
    yd: Tensor


class StructuredQPOperator:
    """Shared-structure operator built once per controller configuration.

    P [n, n]; A_s [m_s, n]; eq_mask_s [m_s] marks shared equality rows.
    polish_guard_rows: the slack-nonnegativity rows, which the stiff rho
    phase scales and the polish keeps pinnable; polish_guard_groups: every
    row touching each slack column (the polish's coverage invariant; the
    groups must be disjoint, checked here).
    """

    #: the f32 ADMM bar is NOT an accuracy certificate; per-lane
    #: certification comes only from solve_polished (Solution.certified)
    certifies = False

    def __init__(self, P: np.ndarray, A_s: np.ndarray, eq_mask_s: np.ndarray,
                 m_d: int, cfg: StructuredConfig = StructuredConfig(), *,
                 device: torch.device | str, dtype: torch.dtype,
                 q_scale_hint: float = 0.0, polish_guard_rows=(), polish_guard_groups=()):
        n = P.shape[0]
        self.n, self.m_s, self.m_d = n, A_s.shape[0], m_d
        self.cfg = cfg
        # resolved ('cuda' -> 'cuda:0') so device checks compare like with like
        self.device, self.dtype = torch.empty(0, device=device).device, dtype

        # static Ruiz-style equilibration from the shared blocks (float64):
        # variable scaling d from [P; A_s] column norms, row scaling e_s.
        P64, A64 = np.asarray(P, np.float64), np.asarray(A_s, np.float64)
        d = np.ones(n)
        e = np.ones(self.m_s)
        for _ in range(10):
            col = np.maximum(np.abs(P64).max(axis=0), np.abs(A64).max(axis=0) if self.m_s else 0)
            dn = np.where(col > 1e-10, 1.0 / np.sqrt(col), 1.0)
            P64 = dn[:, None] * P64 * dn[None, :]
            A64 = A64 * dn[None, :]
            row = np.abs(A64).max(axis=1)
            en = np.where(row > 1e-10, 1.0 / np.sqrt(row), 1.0)
            A64 = en[:, None] * A64
            d, e = d * dn, e * en
        # cost normalization: callers pass the magnitude of the largest
        # expected linear-cost entry (e.g. the slack cost) as q_scale_hint
        q_hint_scaled = q_scale_hint * (np.median(d) if n else 1.0)
        gamma = 1.0 / max(np.abs(P64).max(axis=0).mean(), q_hint_scaled, 1e-12)
        P64 *= gamma
        self._guard_rows = tuple(int(i) for i in polish_guard_rows)
        # unscaled float64 copies for the polish (it re-equilibrates
        # internally) and the masks of its guard rows and groups
        self._P0 = torch.as_tensor(np.array(P, np.float64), device=self.device)
        self._A_s0 = torch.as_tensor(np.array(A_s, np.float64), device=self.device)
        self._n_eq = int(np.sum(eq_mask_s))
        self._guards = make_guards(self._guard_rows, polish_guard_groups, self.m_s + m_d,
                                   self.device)

        t = self._tensor
        self.D = t(d)
        self.E_s = t(e)
        self.gamma = float(gamma)
        self.Pb = t(P64)
        self.A_sb = t(A64)

        # phase schedule: (iters, Ms_inv, rho_s, rho_d) per phase — SOFT
        # first (cost/optimality progress), STIFF second (clamps
        # feasibility from the near-optimal warm state)
        iters_hi = (int(round(cfg.iters * cfg.hi_frac))
                    if cfg.rho_hi_scale != 1.0 else 0)
        iters_hi = min(iters_hi, cfg.iters, cfg.hi_iters_cap)
        # the stiff scale applies ONLY to the dynamic rows and the slack
        # nonnegativity rows they couple to
        slack_row = np.zeros(self.m_s, bool)
        if len(self._guard_rows):
            slack_row[list(self._guard_rows)] = True
        self.phases = []
        # each phase's M_s in float64, beside self.phases: the C form's product
        self.M_s = []
        for scale, n_it in ((1.0, cfg.iters - iters_hi),
                            (cfg.rho_hi_scale, iters_hi)):
            if n_it <= 0:
                continue
            rho_s = np.where(eq_mask_s, cfg.rho * cfg.rho_eq_scale,
                             cfg.rho) * np.where(slack_row, scale, 1.0)
            M_s = P64 + cfg.sigma * np.eye(n) + (A64.T * rho_s) @ A64
            self.phases.append((n_it, t(np.linalg.inv(M_s)), t(rho_s),
                                float(cfg.rho * scale)))
            self.M_s.append(torch.as_tensor(M_s, dtype=torch.float64, device=self.device))
        self.wk_form = takes_wk(n, self.m_s, m_d)
        # aliases for the entry phase
        _, self.Ms_inv, self.rho_s, self.rho_d = self.phases[0]

    def _tensor(self, a) -> Tensor:
        return torch.as_tensor(np.array(a), dtype=self.dtype, device=self.device)

    # ------------------------------------------------------------------
    def solve(self, q: Tensor, lb_s: Tensor, ub_s: Tensor,
              A_d: Tensor, lb_d: Tensor, ub_d: Tensor,
              x0: Optional[Tensor] = None,
              ys0: Optional[Tensor] = None,
              yd0: Optional[Tensor] = None) -> StructuredSolution:
        """q [B, n]; lb_s/ub_s [B, m_s]; A_d [B, m_d, n]; lb_d/ub_d [B, m_d].

        x0 / ys0 / yd0: optional primal / dual warm starts. Duals are in
        UNSCALED row coordinates (as returned in StructuredSolution.ys/yd
        by a previous solve of a nearby problem); they are rescaled into
        the current equilibration internally.

        Returns primal solutions in the ORIGINAL (unscaled) coordinates.
        """
        if q.dtype != self.dtype or q.device != self.device:
            raise ValueError(f"operator holds {self.dtype} on {self.device}, "
                             f"got q as {q.dtype} on {q.device}")
        chunk = self._lane_chunk(q.shape[0])
        if not chunk:
            return self._solve(q, lb_s, ub_s, A_d, lb_d, ub_d, x0, ys0, yd0)
        # lanes are independent, so the chunked solve equals the whole one
        split = lambda a: [None] * -(-q.shape[0] // chunk) if a is None \
            else torch.split(a, chunk)
        parts = [self._solve(*args) for args in zip(*map(
            split, (q, lb_s, ub_s, A_d, lb_d, ub_d, x0, ys0, yd0)))]
        return StructuredSolution(*(torch.cat(f) for f in zip(*parts)))

    #: device bytes the auto lane_chunk allows the per-lane tensors of
    #: ``folded_c`` (a tenth of an 80 GB card)
    LANE_CHUNK_BUDGET = 8_000_000_000

    def _lane_chunk(self, B: int) -> int:
        """Resolved lanes per chunk (0 = no chunking); see
        StructuredConfig.lane_chunk."""
        c = self.cfg.lane_chunk
        if c is None:
            if self.m_d < 128:
                return 0
            per_lane = 8 * (self.m_d * self.n + 4 * self.n * self.n)
            c = 1 << int(np.floor(np.log2(max(self.LANE_CHUNK_BUDGET // per_lane, 256))))
        return 0 if c <= 0 or B <= c else c

    def solve_polished(self, q: Tensor, lb_s: Tensor, ub_s: Tensor,
                       A_d: Tensor, lb_d: Tensor, ub_d: Tensor,
                       x0: Optional[Tensor] = None,
                       ys0: Optional[Tensor] = None,
                       yd0: Optional[Tensor] = None,
                       polish_cfg: Optional[PolishConfig] = None) -> StructuredSolution:
        """ADMM entry (``solve``: the kernel on the card) + f64 active-set
        polish on the same device.

        Each lane is either certified to f64 optimality (certified and
        converged True, pri_res = its exact relative violation) or falls
        back to its ADMM iterate with the ADMM residual and flag. This is
        the path matching the reference's exact-CPLEX semantics
        (qpcpp/src/solvers/CPLEX.cpp:35-178)."""
        sol = self.solve(q, lb_s, ub_s, A_d, lb_d, ub_d, x0=x0, ys0=ys0, yd0=yd0)
        res = polish_structured(
            self._P0, self._A_s0, q, lb_s, ub_s, A_d, lb_d, ub_d, sol.z,
            polish_cfg if polish_cfg is not None else PolishConfig(),
            max_eq=self._n_eq, guards=self._guards)
        z = torch.where(res.ok[:, None], res.z, sol.z.to(res.z.dtype))
        return StructuredSolution(
            z=z.to(sol.z.dtype),
            pri_res=torch.where(res.ok, res.viol.to(sol.pri_res.dtype), sol.pri_res),
            converged=sol.converged | res.ok,
            certified=res.ok,
            ys=sol.ys, yd=sol.yd)

    def scale(self, q: Tensor, lb_s: Tensor, ub_s: Tensor,
              A_d: Tensor, lb_d: Tensor, ub_d: Tensor):
        """Scale one batch of problems into equilibrated coordinates.

        Returns (qb, lbs, ubs, Ad, lbd, ubd, e_d, inactive_d)."""
        D, E_s = self.D, self.E_s
        qb = (q * D) * self.gamma                                # [B, n]
        lbs = torch.clamp_min(lb_s, -BIG) * E_s
        ubs = torch.clamp_max(ub_s, BIG) * E_s
        # per-row normalization of the dynamic rows (after column scaling)
        Ad = A_d * D
        row_norm = torch.amax(torch.abs(Ad), dim=-1)             # [B, m_d]
        e_d = torch.where(row_norm > 1e-10, 1.0 / torch.sqrt(row_norm),
                          torch.ones_like(row_norm))
        Ad = Ad * e_d[..., None]
        lbd = torch.clamp_min(lb_d, -BIG) * e_d
        ubd = torch.clamp_max(ub_d, BIG) * e_d
        inactive_d = (lb_d <= -BIG / 2) & (ub_d >= BIG / 2)
        return qb, lbs, ubs, Ad, lbd, ubd, e_d, inactive_d

    @staticmethod
    def woodbury(Ms_inv: Tensor, Ad: Tensor, rho_d: Tensor) -> Tensor:
        """The folded Woodbury correction of one rho phase,
        WK = Ms_inv Ad' (R^-1 + Ad Ms_inv Ad')^-1  [B, n, m_d].

        (R^-1 + AMA)^-1 = S (I + S AMA S)^-1 S with S = diag(sqrt(rho_d)):
        the scaled form stays well-conditioned even with the 1e-12 rho of
        masked rows."""
        W = torch.einsum("ij,bdj->bid", Ms_inv, Ad)              # [B, n, m_d]
        AMA = torch.einsum("bdj,bje->bde", Ad, W)
        sr = torch.sqrt(rho_d)                                   # [B, m_d]
        eye = torch.eye(Ad.shape[1], dtype=Ad.dtype, device=Ad.device)
        Cp = eye + sr[:, :, None] * AMA * sr[:, None, :]
        # inv_ex: no host sync and no raise, a singular lane gives non-finite
        # values that the converged flag catches (as jnp.linalg.inv does)
        Cp_inv, _ = torch.linalg.inv_ex(Cp)
        K = sr[:, :, None] * Cp_inv * sr[:, None, :]             # [B, m_d, m_d]
        return torch.einsum("bid,bde->bie", W, K)

    @staticmethod
    def folded_c(M_s: Tensor, Ad: Tensor, rho_d: Tensor) -> Tensor:
        """The x-update's operand of one rho phase in the C form,
        C = (M_s + Ad' diag(rho_d) Ad)^-1  [B, n, n] float64, from the
        phase's float64 M_s [n, n].

        The product is formed in float64 (one batched DGEMM of the rows
        scaled by sqrt(rho_d); the masked rows' rho of 1e-12 adds nothing),
        factored by ``cholesky_ex`` and inverted by two triangular solves
        against the identity, as ``linsolve.spd_solve`` solves (not
        ``cholesky_inverse``: MAGMA's batched potrs syncs). No host sync; a
        lane whose product is not positive definite comes out NaN alone."""
        B, _, n = Ad.shape
        hi = torch.float64
        Aw = Ad.to(hi, copy=True).mul_(torch.sqrt(rho_d.to(hi))[..., None])   # [B, m_d, n]
        L, info = torch.linalg.cholesky_ex(torch.baddbmm(M_s, Aw.mT, Aw))
        del Aw
        L.masked_fill_((info != 0)[:, None, None], float("nan"))
        eye = torch.eye(n, dtype=hi, device=Ad.device).expand(B, n, n)
        L_inv = torch.linalg.solve_triangular(L, eye, upper=False)
        return torch.linalg.solve_triangular(L.mT, L_inv, upper=True)

    def _solve(self, q: Tensor, lb_s: Tensor, ub_s: Tensor,
               A_d: Tensor, lb_d: Tensor, ub_d: Tensor,
               x0: Optional[Tensor] = None,
               ys0: Optional[Tensor] = None,
               yd0: Optional[Tensor] = None) -> StructuredSolution:
        cfg = self.cfg
        B = q.shape[0]
        D, E_s = self.D, self.E_s
        with profiling.span("admm.scale"):
            qb, lbs, ubs, Ad, lbd, ubd, e_d, inactive_d = self.scale(
                q, lb_s, ub_s, A_d, lb_d, ub_d)

            # initial state
            x = x0 / D if x0 is not None else torch.zeros_like(q)   # [B, n]
            zs = torch.clamp(x @ self.A_sb.T, lbs, ubs)              # [B, m_s]
            zd = torch.clamp(torch.einsum("bdj,bj->bd", Ad, x), lbd, ubd)
            # dual warm start: incoming duals are UNSCALED (y_u = e·ŷ/γ from a
            # previous solve, possibly under a different dynamic-row
            # equilibration) — map into the current scaled coordinates.
            ys = ys0 * self.gamma / E_s if ys0 is not None else torch.zeros_like(zs)
            yd = yd0 * self.gamma / e_d if yd0 is not None else torch.zeros_like(zd)

        # the raw y carries over unchanged at the phase switch (measured
        # better than rescaling, see mpc_cbf_tpu/ops/qp/structured.py)
        loop = structured_admm_iterations if cfg.use_kernel else structured_admm_iterations_ref
        for (n_it, Ms_inv, rho_s, rho_d_base), M_s in zip(self.phases, self.M_s):
            rho_d = torch.where(inactive_d, torch.full_like(e_d, 1e-12),
                                torch.full_like(e_d, rho_d_base))
            with profiling.span("admm.operand"):
                W = self.woodbury(Ms_inv, Ad, rho_d) if self.wk_form else \
                    self.folded_c(M_s, Ad, rho_d)
            with profiling.span("admm.kernel"):
                x, zs, zd, ys, yd = loop(
                    Ms_inv, self.A_sb, rho_s, qb, lbs, ubs, Ad, lbd, ubd, rho_d,
                    W.contiguous(), x.contiguous(), zs.contiguous(), zd.contiguous(),
                    ys.contiguous(), yd.contiguous(),
                    iters=n_it, sigma=cfg.sigma, alpha=cfg.alpha)

        with profiling.span("admm.unscale"):
            # unscale; primal residual in scaled (row-equilibrated) coordinates,
            # which is the meaningful relative measure
            x_out = D * x                                            # [B, n]
            As_x = x @ self.A_sb.T
            Ad_x = torch.einsum("bdj,bj->bd", Ad, x)
            viol_s = torch.abs(As_x - torch.clamp(As_x, lbs, ubs))
            viol_d = torch.abs(Ad_x - torch.clamp(Ad_x, lbd, ubd))
            # per-row relative violation: a 10 m/s^2 miss on a tight row must not
            # be excused by some other row's large magnitude
            rel_s = torch.amax(viol_s / torch.clamp_min(torch.abs(As_x), 1.0), dim=-1)
            rel_d = torch.amax(viol_d / torch.clamp_min(torch.abs(Ad_x), 1.0), dim=-1)
            pri = torch.maximum(torch.amax(viol_s, dim=-1), torch.amax(viol_d, dim=-1))
            rel = torch.maximum(rel_s, rel_d)
            return StructuredSolution(
                z=x_out,
                pri_res=pri,
                converged=(rel < cfg.eps_pri) & torch.all(torch.isfinite(x_out), dim=-1),
                certified=torch.zeros(B, dtype=torch.bool, device=q.device),
                # duals back to unscaled coordinates (y_u = e·ŷ/γ) so the next
                # solve can rescale them into ITS equilibration
                ys=ys * E_s / self.gamma,
                yd=yd * e_d / self.gamma,
            )
