"""Batched Mehrotra predictor-corrector interior-point method for the
structured MPC-CBF QP family (counterpart of ``mpc_cbf_tpu/ops/qp/ipm.py``).

Problem family (as ``ops/qp/structured.py``):

    min ½ xᵀPx + qᵀx
    s.t. lb_s ≤ A_s x ≤ ub_s     (shared rows; eq_mask marks lb == ub)
         lb_d ≤ A_d x ≤ ub_d     (per-lane rows: CBF / Voronoi)

- **Equality elimination by a static nullspace basis.** The equality rows
  share one coefficient matrix E; at build time E = U Σ Vᵀ is factored
  once (float64 numpy) and x = E⁺b + Z v with Z = null(E). The IPM runs in
  the reduced coordinate v (nz = 19 for fov, 6 for connectivity), so each
  Newton system is an [nz, nz] Cholesky.
- **Two-sided inequalities** with slack t and duals (z_l, z_u); absent
  sides are static masks, so one code path serves every neighbor count.
- **Fixed iteration count**: a Python loop of ``cfg.iters`` steps with no
  host synchronisation. Lanes that reach ``mu_freeze`` freeze (a mask, not
  a branch), and a lane whose Newton step is not finite, or whose KKT
  matrix is not positive definite (``cholesky_ex`` info ≠ 0), takes no
  step. Such a lane ends unconverged; nothing falls back to another route.
- **One CUDA graph per chunk shape.** Every shape in a chunk's solve is
  static and nothing in it waits for the host, so on the card the first
  chunk of each shape is captured whole (reduction, iterations, final
  diagnostics) and every chunk of that shape replays the graph: the same
  kernels in the same order, without the ~240 host launches an iteration.
  ``StructuredIPM.graph_counts`` counts captures, replays and eager chunk
  solves (the CPU's).

Profiles: ``IPMConfig()`` is the certified float64 solver (μ to ~1e-10);
``IPM_F32_ENTRY`` runs the same algorithm in float32 with loosened bars
(the production raw path of the fov flagship); ``HybridIPM`` runs the f32
entry and hands its interior state to a short warm-started f64 tail.

Left out on purpose (TPU workarounds in the JAX package): ``df32_gram``
and the ``df32_hform`` option (the card has native float64), the
fori-loop Cholesky behind ``hand_chol``, the backend gates and the
``B % chunk == 0`` condition on chunking (``chunk`` here takes a
remainder), and the ``trace`` debug print.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from mpc_cbf_torch.types import BIG
from mpc_cbf_torch.utils import profiling

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class IPMConfig:
    iters: int = 30
    tau: float = 0.995        # fraction-to-boundary
    eps_mu: float = 1e-10     # complementarity bar (relative to cost scale)
    eps_feas: float = 1e-9    # primal residual bar (relative)
    #: stationarity bar in scaled coordinates; calibrated against the exact
    #: oracle on the fov flagship (mpc_cbf_tpu/ops/qp/ipm.py has the data)
    eps_dual: float = 1e-6
    reg: float = 1e-11        # static Tikhonov term on the reduced Hessian
    #: lanes whose μ drops below this freeze (take no further step)
    mu_freeze: float = 1e-12
    #: lanes per chunk, a bound on the [chunk, m, nz] temporaries; the last
    #: chunk takes the remainder. 0 solves the whole batch at once. Lanes
    #: are independent, so the result does not depend on it.
    chunk: int = 2048
    #: warm start (state0): transferred slacks are pushed at least this far
    #: inside their bounds (the f32 -> f64 hybrid needs ~1e-6)
    warm_pad: float = 1e-10
    #: > 0: each transferred complementarity product g*z is clipped into
    #: [mu_t/width, width*mu_t], mu_t = max(lane mu, warm_mu_floor)
    warm_center_width: float = 0.0
    warm_mu_floor: float = 1e-4
    #: "f64" (the certified path) or "f32" (the entry profile: never
    #: certified by itself, its `converged` means "reached the f32 floor")
    dtype: str = "f64"


#: entry-profile configuration for the f32 IPM (see IPMConfig.dtype)
IPM_F32_ENTRY = IPMConfig(
    iters=22, eps_mu=1e-5, eps_feas=1e-5, eps_dual=1e-3,
    reg=1e-6, mu_freeze=1e-7, dtype="f32")


class IPMSolution(NamedTuple):
    z: Tensor          # [B, n] primal solution, original coordinates, compute dtype
    converged: Tensor  # [B] met the μ, primal AND dual feasibility bars
    mu: Tensor         # [B] final (scaled) complementarity measure
    pri_res: Tensor    # [B] relative bound violation of z
    dual_res: Tensor   # [B] stationarity residual (scaled coordinates)
    #: final interior state (v, t, zl, zu) in scaled coordinates; feed as
    #: ``state0`` to another StructuredIPM over the same lanes
    state: Tuple[Tensor, Tensor, Tensor, Tensor]


def _fields(sol: IPMSolution) -> tuple:
    """The solution's tensors: its five fields, then its state's four."""
    return tuple(sol[:5]) + tuple(sol.state)


def chol_factor(H: Tensor) -> Tuple[Tensor, Tensor]:
    """(L, ok) for a batch of symmetric matrices H [B, k, k]. ok [B] is
    False where H is not positive definite: there ``L`` is partly filled
    and a solve with it gives finite but meaningless numbers, so callers
    must mask the step with ok. No host synchronisation, no raise."""
    L, info = torch.linalg.cholesky_ex(H, check_errors=False)
    return L, info == 0


def chol_solve(L: Tensor, rhs: Tensor) -> Tensor:
    """Solve (L Lᵀ) x = rhs for rhs [B, k]: a forward and a backward batched
    triangular solve. Not ``torch.cholesky_solve``: on the card that is
    MAGMA's batched potrs, which takes its workspace with cudaMalloc, frees
    it and synchronises the stream in every call, so a solver loop that
    calls it waits for the device in every iteration
    (``scripts/dense_admm_parts.py`` times both on the card)."""
    y = torch.linalg.solve_triangular(L, rhs[..., None], upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True)[..., 0]


def _dtype_of(name: str) -> torch.dtype:
    if name not in ("f64", "f32"):
        raise ValueError(f"IPMConfig.dtype must be 'f64' or 'f32', got {name!r}")
    return torch.float64 if name == "f64" else torch.float32


class StructuredIPM:
    """Build-once operator for a fixed (P, A_s, eq_mask, m_d) family.

    Same ``solve`` interface as StructuredQPOperator, so StructuredIMPC can
    swap it in. The precompute is float64 numpy, written as in the JAX
    package, so both packages start from the same constants; the per-call
    tensors live on ``device`` in the compute dtype of ``cfg.dtype``.
    """

    def __init__(self, P: np.ndarray, A_s: np.ndarray, eq_mask_s: np.ndarray,
                 m_d: int, cfg: IPMConfig = IPMConfig(), *,
                 device: torch.device | str):
        #: only the f64 profiles' bars are deviation-calibrated certificates
        self.certifies = cfg.dtype == "f64"
        self.dtype = _dtype_of(cfg.dtype)
        # resolved ('cuda' -> 'cuda:0') so device checks compare like with like
        self.device = torch.empty(0, device=device).device
        n = P.shape[0]
        self.n, self.m_d = n, m_d
        self.cfg = cfg
        eq = np.asarray(eq_mask_s, bool)
        P64 = np.asarray(P, np.float64)
        A64 = np.asarray(A_s, np.float64)

        # nullspace factorization of the equality block (static)
        E = A64[eq]
        if E.shape[0]:
            U, s, Vt = np.linalg.svd(E, full_matrices=True)
            rank = int(np.sum(s > s[0] * 1e-12)) if s.size else 0
            self._Epinv = (Vt[:rank].T / s[:rank]) @ U[:, :rank].T  # [n, me]
            Z = Vt[rank:].T                                         # [n, nz]
        else:
            self._Epinv = np.zeros((n, 0))
            Z = np.eye(n)
        self.nz = Z.shape[1]
        self._Z = Z
        self._Pt = Z.T @ P64 @ Z                   # [nz, nz]
        self._PZ = P64 @ Z                         # [n, nz] (for q̃ = Zᵀ(q + P x_p))
        self._Gs = A64[~eq]                        # [m_si, n]
        self._GsZ = self._Gs @ Z                   # [m_si, nz]
        self.m_si = self._Gs.shape[0]

        # static row scaling for the shared inequality rows
        rs = np.abs(self._GsZ).max(axis=1)
        self._es = np.where(rs > 1e-12, 1.0 / np.maximum(rs, 1e-12), 1.0)
        GsZs = self._GsZ * self._es[:, None]

        t = self._tensor
        self.Zb = t(Z)
        self.Ptb = t(self._Pt)
        self.PZb = t(self._PZ)
        self.Epinvb = t(self._Epinv)
        self.GsZb = t(GsZs)
        self.esb = t(self._es)
        self.Gsb = t(self._Gs * self._es[:, None])  # row-scaled unreduced rows (x_p offset)
        # per-row outer products of the shared rows, [m_si, nz*nz]: the
        # shared part of H is one [B, m_si] x [m_si, nz*nz] matmul
        self.GsZ_outer = t((GsZs[:, :, None] * GsZs[:, None, :]).reshape(self.m_si, -1))
        self.eq_idx = torch.as_tensor(np.nonzero(eq)[0], device=self.device)
        self.ineq_idx = torch.as_tensor(np.nonzero(~eq)[0], device=self.device)
        self._pmax = float(max(np.abs(self._Pt).max(), 1e-12))
        #: on the card, each chunk shape's captured solve, keyed by its
        #: inputs' shapes (the lanes and m_d; a state0 adds four); None on
        #: the CPU, which solves every chunk eagerly
        self._graphs = {} if self.device.type == "cuda" else None

    #: chunk solves in this process: graphs captured ("capture"), chunks
    #: served by a replay ("replay") and chunks solved eagerly ("eager")
    graph_counts = {"capture": 0, "replay": 0, "eager": 0}

    def _tensor(self, a) -> Tensor:
        return torch.as_tensor(np.array(a), dtype=self.dtype, device=self.device)

    # ------------------------------------------------------------------
    def solve(self, q: Tensor, lb_s: Tensor, ub_s: Tensor,
              A_d: Tensor, lb_d: Tensor, ub_d: Tensor,
              x0: Optional[Tensor] = None,
              ys0: Optional[Tensor] = None,
              yd0: Optional[Tensor] = None,
              state0=None) -> IPMSolution:
        """q [B, n]; lb_s/ub_s [B, m_s]; A_d [B, m_d, n]; lb_d/ub_d [B, m_d],
        on the operator's device, in any float dtype (cast to the compute
        dtype).

        x0, ys0 and yd0 are accepted for interface parity with
        StructuredQPOperator and ignored: a primal-only warm start hurts an
        interior-point method (measured in the JAX package), and it keeps
        no ADMM duals. The cold central-path start is the production one.

        state0: (v, t, zl, zu) interior state from another StructuredIPM's
        IPMSolution.state over the same lanes (the hybrid's warm start)."""
        if q.device != self.device:
            raise ValueError(f"operator lives on {self.device}, got q on {q.device}")
        args = tuple(a.to(self.dtype) for a in (q, lb_s, ub_s, A_d, lb_d, ub_d))
        if state0 is not None:
            state0 = tuple(a.to(self.dtype) for a in state0)
        B = q.shape[0]
        chunk = self.cfg.chunk if 0 < self.cfg.chunk < B else B
        starts = range(0, B, chunk)
        pieces = [(tuple(a[s:s + chunk] for a in args),
                   tuple(a[s:s + chunk] for a in state0) if state0 is not None else None)
                  for s in starts]
        if self._graphs is None:
            StructuredIPM.graph_counts["eager"] += len(pieces)
            parts = [_fields(self._solve(*piece, st)) for piece, st in pieces]
            result = parts[0] if len(parts) == 1 else tuple(map(torch.cat, zip(*parts)))
        else:
            # each replay overwrites the graph's outputs: copy them into the
            # chunk's rows of the result before the next one
            result = None
            for s, (piece, st) in zip(starts, pieces):
                out = self._replay(piece, st)
                if result is None:
                    result = tuple(a.new_empty((B,) + a.shape[1:]) for a in out)
                for dst, src in zip(result, out):
                    dst[s:s + src.shape[0]].copy_(src)
        return IPMSolution(*result[:5], state=result[5:])

    def _replay(self, piece, state0) -> tuple:
        """One chunk through the graph of its shape, captured at the shape's
        first chunk: the graph's own outputs (``_fields`` order), valid until
        the next replay."""
        inputs = piece + (state0 or ())
        key = tuple(a.shape for a in inputs)
        entry = self._graphs.get(key)
        if entry is None:
            with profiling.span("ipm.capture"):
                entry = self._graphs[key] = self._capture(inputs, state0 is not None)
        graph, static_in, out = entry
        with profiling.span("ipm.replay"):
            for dst, src in zip(static_in, inputs):
                dst.copy_(src)
            graph.replay()
        StructuredIPM.graph_counts["replay"] += 1
        return out

    def _capture(self, inputs, warm: bool):
        """(graph, static inputs, static outputs) of one chunk shape. An
        eager run on a side stream first sets up cuBLAS's and cuSOLVER's
        handles and workspaces, which a capture may not create; the graph
        keeps its own memory pool. The static inputs live outside it."""
        static_in = tuple(a.clone() for a in inputs)
        run = lambda: self._solve(*static_in[:6], static_in[6:] if warm else None)
        with torch.cuda.device(self.device):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                run()
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = _fields(run())
        StructuredIPM.graph_counts["capture"] += 1
        return graph, static_in, out

    def _solve(self, q, lb_s, ub_s, A_d, lb_d, ub_d, state0) -> IPMSolution:
        cfg = self.cfg
        dt = self.dtype
        B = q.shape[0]
        nz, m_si = self.nz, self.m_si
        with profiling.span("ipm.reduce"):
            # scalars made on the device (a tensor copied from the host would
            # wait for the device)
            inf, zero, one = (torch.full((), v, dtype=dt, device=q.device)
                              for v in (float("inf"), 0.0, 1.0))

            # particular solution of the equality block, reduced cost
            b_e = lb_s[:, self.eq_idx]                          # [B, me]
            x_p = b_e @ self.Epinvb.T                           # [B, n]
            q_t = q @ self.Zb + x_p @ self.PZb                  # Zᵀq + ZᵀP x_p
            # per-lane cost normalization (primal-invariant): keeps μ and the
            # dual residual O(1) even with 5e4-scale slack weights
            gamma = 1.0 / torch.clamp_min(q_t.abs().amax(dim=1), self._pmax)  # [B]
            q_t = q_t * gamma[:, None]

            # reduced, row-scaled inequality system G v ∈ [l, u]
            GdZ = A_d @ self.Zb                                 # [B, m_d, nz]
            ed = 1.0 / torch.clamp_min(GdZ.abs().amax(dim=2), 1e-12)
            GdZ = GdZ * ed[:, :, None]
            GdZ_T = GdZ.transpose(1, 2)                         # [B, nz, m_d]
            Gxp_s = x_p @ self.Gsb.T                            # [B, m_si] (scaled rows)
            Gxp_d = (A_d @ x_p[:, :, None])[..., 0] * ed
            lb_si, ub_si = lb_s[:, self.ineq_idx], ub_s[:, self.ineq_idx]
            l = torch.cat([lb_si * self.esb - Gxp_s, lb_d * ed - Gxp_d], dim=1)   # [B, m]
            u = torch.cat([ub_si * self.esb - Gxp_s, ub_d * ed - Gxp_d], dim=1)
            # side masks: a bound beyond BIG/2 (pre-scaling) is absent
            has_l = torch.cat([lb_si > -BIG / 2, lb_d > -BIG / 2], dim=1)
            has_u = torch.cat([ub_si < BIG / 2, ub_d < BIG / 2], dim=1)
            hl, hu = has_l.to(dt), has_u.to(dt)
            n_comp = torch.clamp_min(has_l.sum(1) + has_u.sum(1), 1).to(dt)

            def matvec(V):                                      # [B, nz] -> [B, m]
                return torch.cat([V @ self.GsZb.T, (GdZ @ V[:, :, None])[..., 0]], dim=1)

            def rmatvec(Y):                                     # [B, m] -> [B, nz]
                return Y[:, :m_si] @ self.GsZb + (GdZ_T @ Y[:, m_si:, None])[..., 0]

            def clip(x, lo, hi):                                # jnp.clip: NaN stays NaN
                return torch.minimum(torch.maximum(x, lo), hi)

            def comp_mean(g_l, zl, g_u, zu):                    # mean complementarity
                return ((g_l * zl * hl).sum(1) + (g_u * zu * hu).sum(1)) / n_comp

            both = has_l & has_u
            if state0 is not None:
                # warm start from another dtype's run over the same lanes:
                # re-interiorize against THIS solve's (l, u) and bound the duals
                v, t, zl, zu = state0
                pad = torch.clamp_max(0.25 * torch.where(both, u - l, inf), cfg.warm_pad)
                t = clip(t, torch.where(has_l, l + pad, -inf), torch.where(has_u, u - pad, inf))
                # no lower floor on the duals: z = 0 is safe (D-contribution 0)
                zl = torch.where(has_l, clip(zl, zero, 1e12 * one), zero)
                zu = torch.where(has_u, clip(zu, zero, 1e12 * one), zero)
                if cfg.warm_center_width > 0:
                    g_lw = torch.where(has_l, t - l, one)
                    g_uw = torch.where(has_u, u - t, one)
                    mu_w = torch.clamp_min(comp_mean(g_lw, zl, g_uw, zu),
                                           cfg.warm_mu_floor)[:, None]
                    w = cfg.warm_center_width
                    zl = torch.where(has_l, clip(zl, mu_w / (w * g_lw), w * mu_w / g_lw), zero)
                    zu = torch.where(has_u, clip(zu, mu_w / (w * g_uw), w * mu_w / g_uw), zero)
            else:
                # strictly interior cold start on the central path (g∘z = μ0)
                v = q.new_zeros((B, nz))
                Gv = matvec(v)
                delta = torch.clamp_max(0.25 * torch.where(both, u - l, inf), 1.0)
                delta = torch.where(torch.isfinite(delta), delta, one)
                t = clip(Gv, torch.where(has_l, l + delta, -inf),
                         torch.where(has_u, u - delta, inf))
                mu0 = 1.0
                g_l0 = torch.where(has_l, t - l, one)
                g_u0 = torch.where(has_u, u - t, one)
                zl = torch.where(has_l, torch.clamp(mu0 / g_l0, 1e-10, 1e10), zero)
                zu = torch.where(has_u, torch.clamp(mu0 / g_u0, 1e-10, 1e10), zero)

            Pg = self.Ptb[None] * gamma[:, None, None]          # [B, nz, nz]
            Pg_reg = Pg + cfg.reg * torch.eye(nz, dtype=dt, device=q.device)
            tiny = torch.finfo(dt).tiny

            def ratio(x, dx, present):
                # largest step keeping x + a dx >= 0 on the present rows
                r = torch.where(present & (dx < 0), -x / torch.clamp_max(dx, -tiny), inf)
                return r.amin(dim=1)

            def max_step(g_l, g_u, zl, zu, dt_, dz_l, dz_u):
                a_p = torch.minimum(ratio(g_l, dt_, has_l), ratio(g_u, -dt_, has_u))
                a_d = torch.minimum(ratio(zl, dz_l, has_l), ratio(zu, dz_u, has_u))
                return torch.clamp_max(a_p, 1.0), torch.clamp_max(a_d, 1.0)

            frozen = torch.zeros(B, dtype=torch.bool, device=q.device)

        for _ in range(cfg.iters):
            with profiling.span("ipm.iteration"):
                Gv = matvec(v)
                g_l = torch.where(has_l, t - l, one)
                g_u = torch.where(has_u, u - t, one)
                r_d = (Pg @ v[:, :, None])[..., 0] + q_t - rmatvec(zl - zu)
                r_p = Gv - t
                mu = comp_mean(g_l, zl, g_u, zu)
                # freeze BEFORE stepping: at the μ floor D spans ~1e15 and
                # further steps can poison the state
                frozen = frozen | (mu < cfg.mu_freeze)

                D = torch.where(has_l, zl / g_l, zero) + torch.where(has_u, zu / g_u, zero)
                # H = Pγ + reg I + Gsᵀ diag(D_s) Gs + Gdᵀ diag(D_d) Gd: the shared
                # part is one matmul against the per-row outer products, the
                # per-lane part one bmm (never a [B, m_d, nz, nz] temporary)
                H = Pg_reg + (D[:, :m_si] @ self.GsZ_outer).view(B, nz, nz) \
                    + (GdZ_T * D[:, None, m_si:]) @ GdZ
                L, fact_ok = chol_factor(H)

                def kkt_solve(rc_l, rc_u):
                    rhs = -r_d - rmatvec(torch.where(has_l, rc_l / g_l, zero)
                                         - torch.where(has_u, rc_u / g_u, zero) + D * r_p)
                    dv = chol_solve(L, rhs)
                    dt_ = matvec(dv) + r_p
                    dz_l = torch.where(has_l, -(rc_l + zl * dt_) / g_l, zero)
                    dz_u = torch.where(has_u, -(rc_u - zu * dt_) / g_u, zero)
                    return dv, dt_, dz_l, dz_u

                # predictor
                dv_a, dt_a, dzl_a, dzu_a = kkt_solve(g_l * zl, g_u * zu)
                a_p, a_d = max_step(g_l, g_u, zl, zu, dt_a, dzl_a, dzu_a)
                a = torch.minimum(a_p, a_d)[:, None]
                mu_aff = comp_mean(g_l + a * dt_a, zl + a * dzl_a, g_u - a * dt_a, zu + a * dzu_a)
                sigma = torch.clamp(mu_aff / torch.clamp_min(mu, tiny), 0.0, 1.0) ** 3

                # corrector
                sm = (sigma * mu)[:, None]
                dv, dt_, dz_l, dz_u = kkt_solve(g_l * zl - sm + dt_a * dzl_a,
                                                g_u * zu - sm - dt_a * dzu_a)
                a_p, a_d = max_step(g_l, g_u, zl, zu, dt_, dz_l, dz_u)
                # equalize strongly asymmetric steps (keeps μ and r_d falling
                # together on degenerate lanes)
                a_eq = torch.minimum(a_p, a_d)
                asym = a_eq < 0.2 * torch.maximum(a_p, a_d)
                a_p = torch.where(asym, a_eq, a_p)
                a_d = torch.where(asym, a_eq, a_d)
                step_ok = torch.isfinite(torch.cat([dv, dt_, dz_l, dz_u], dim=1)).all(dim=1) \
                    & fact_ok & ~frozen
                a_p = torch.where(step_ok, cfg.tau * a_p, zero)[:, None]
                a_d = torch.where(step_ok, cfg.tau * a_d, zero)[:, None]

                # mask the deltas, not just the step: 0 * NaN = NaN
                ok = step_ok[:, None]
                v = v + torch.where(ok, a_p * dv, zero)
                t = t + torch.where(ok, a_p * dt_, zero)
                zl = torch.where(has_l, zl + torch.where(ok, a_d * dz_l, zero), zero)
                zu = torch.where(has_u, zu + torch.where(ok, a_d * dz_u, zero), zero)

        with profiling.span("ipm.final"):
            # final diagnostics in scaled coordinates
            Gv = matvec(v)
            g_l = torch.where(has_l, t - l, one)
            g_u = torch.where(has_u, u - t, one)
            mu = comp_mean(g_l, zl, g_u, zu)
            r_d = (Pg @ v[:, :, None])[..., 0] + q_t - rmatvec(zl - zu)
            bscale = torch.clamp_min(torch.maximum(torch.where(has_l, l.abs(), zero),
                                                   torch.where(has_u, u.abs(), zero)), 1.0)
            viol = torch.maximum(torch.where(has_l, l - Gv, zero),
                                 torch.where(has_u, Gv - u, zero)) / bscale
            pri = torch.clamp_min(viol, 0.0).amax(dim=1)
            # r_p (Gv - t) folds into pri via t's interiority; check it too
            pri = torch.maximum(pri, ((Gv - t).abs() / bscale).amax(dim=1))
            dual = r_d.abs().amax(dim=1)
            # a converged lane meets all three bars: complementarity, primal
            # feasibility and stationarity
            conv = (mu < cfg.eps_mu * 10) & (pri < cfg.eps_feas * 10) & (dual < cfg.eps_dual)

            x = x_p + v @ self.Zb.T
            return IPMSolution(z=x, converged=conv, mu=mu, pri_res=pri,
                               dual_res=dual, state=(v, t, zl, zu))


#: tail profile for the hybrid pipeline: a short f64 run warm-started from
#: the f32 entry state, with the interiorization pad and the neighborhood
#: centering the transfer needs
IPM_F64_TAIL = IPMConfig(iters=10, warm_pad=1e-6, warm_center_width=10.0)

#: production-calibrated tail: 12 iterations, with the loosest bars that
#: gave no false certificate in the JAX package's calibration (mu < 1e-8,
#: dual < 1e-5, against a cold 40-iteration f64 reference)
IPM_F64_TAIL_PROD = IPMConfig(iters=12, warm_pad=1e-6,
                              warm_center_width=10.0,
                              eps_mu=1e-9, eps_dual=1e-5)


@dataclasses.dataclass(frozen=True)
class HybridIPMConfig:
    """Configuration of the f32 -> f64 hybrid certified solver:
    StructuredIMPC builds a HybridIPM when given one of these.

    entry_only_first: IMPC iteration 0 runs ONLY the f32 entry (it seeds
    the predicted states that place iteration 1's CBF rows); iterations > 0
    run the entry and the f64 tail, and the tail's certificate applies to
    the flown curve.
    """
    entry: IPMConfig = IPM_F32_ENTRY
    tail: IPMConfig = IPM_F64_TAIL
    entry_only_first: bool = False


#: the shipping certified configuration: f32 entry alone on IMPC iteration
#: 0; entry + the calibrated 12-iteration f64 tail on iteration 1
HYBRID_PROD = HybridIPMConfig(tail=IPM_F64_TAIL_PROD, entry_only_first=True)


class HybridIPM:
    """f32 Mehrotra entry + short warm-started f64 tail.

    The f32 IPM does the bulk of the path following (μ to the f32 floor,
    ~1e-5); its final interior state is re-interiorized and centered
    (IPMConfig.warm_*) and the f64 tail finishes to the certificate's bars.
    Same ``solve`` interface and IPMSolution result as StructuredIPM.
    """

    #: a set `converged` flag meets the tail's calibrated bars
    certifies = True

    def __init__(self, P: np.ndarray, A_s: np.ndarray, eq_mask_s: np.ndarray,
                 m_d: int, cfg: HybridIPMConfig = HybridIPMConfig(), *,
                 device: torch.device | str):
        self.cfg = cfg
        self.entry = StructuredIPM(P, A_s, eq_mask_s, m_d,
                                   dataclasses.replace(cfg.entry, dtype="f32"),
                                   device=device)
        self.tail = StructuredIPM(P, A_s, eq_mask_s, m_d,
                                  dataclasses.replace(cfg.tail, dtype="f64"),
                                  device=device)
        self.n, self.m_d = self.tail.n, m_d

    def solve(self, q, lb_s, ub_s, A_d, lb_d, ub_d,
              x0=None, ys0=None, yd0=None) -> IPMSolution:
        ent = self.entry.solve(q, lb_s, ub_s, A_d, lb_d, ub_d)
        return self.tail.solve(q, lb_s, ub_s, A_d, lb_d, ub_d, state0=ent.state)
