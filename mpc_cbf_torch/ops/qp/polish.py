"""Mixed-precision active-set polish: float64 exactness on top of the
float32 ADMM (counterpart of ``mpc_cbf_tpu/ops/qp/polish.py``).

The reference solves every QP exactly with CPLEX's active-set simplex
(``qpcpp/src/solvers/CPLEX.cpp:35-178``). The float32 structured ADMM
cannot resolve the active set on a few per cent of binding rows, so this
module refines each lane with a batched primal-dual active-set iteration
(OSQP's "solution polish", Stellato et al. 2020 §5.6, with working-set
updates), entirely in float64:

  round:  pool   = top-k rows by (equality | active | proximity score)
          (x, y) = exact KKT solve with the pinned pool rows as equalities
          drop     pinned rows whose multiplier has the wrong sign
          add      rows the new x violates

Lanes that fail to certify (violation or stationarity above tolerance, or
a wrong-signed multiplier) fall back to their ADMM iterate, lane by lane.

Rows live in two blocks, A_s [m_s, n] shared across the batch and
A_d [B, m_d, n] per lane (the split of ``structured.py``); pool rows are
gathered from whichever block owns them.

As the JAX module, with PyTorch idiom:
- the rounds (``cfg.mass_rounds`` mass rounds, then ``cfg.rounds``
  single-change rounds) are fixed-count Python loops, and nothing in them
  reads back to the host;
- ``jax.lax.top_k`` puts the lower index first among equal keys, and the
  keys tie often (equality rows at 1e12, +-inf ranks, masked rows), so the
  selections sort stably (``torch.topk`` orders ties arbitrarily on CUDA);
- the per-group loops over the guard groups run vectorised over a
  [G, m] mask, which equals the sequential loop because the groups are
  disjoint and do not hold row 0 (``Guards`` asserts both);
- there is no x64 switch: the inputs are upcast to float64 on their own
  device.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from mpc_cbf_torch.types import BIG
from mpc_cbf_torch.ops.qp.linsolve import plu_factor, plu_solve, spd_solve

Tensor = torch.Tensor
F64 = torch.float64


@dataclasses.dataclass(frozen=True)
class PolishConfig:
    mass_rounds: int = 6     # bulk rederive-the-set rounds (fast, can zigzag)
    rounds: int = 10         # single-change cleanup rounds (drops first)
    pool_extra: int = 24     # pool width beyond the equality-row count
    sigma: float = 1e-9      # primal Tikhonov on the KKT (1,1) block
    # dual regularization on pinned rows. Must stay tiny: each pinned row is
    # violated by exactly delta*y_row*row_norm at the regularized optimum
    delta: float = 1e-13
    act_tol: float = 1e-3    # initial near-active band (relative, f32 scale)
    viol_tol: float = 1e-9   # row enters the working set beyond this
    # wrong-sign multiplier threshold for drops, RELATIVE to the lane's dual
    # scale max(1, |q|_inf) (the measurements are in the JAX module)
    y_tol: float = 1e-7
    ok_viol: float = 1e-6    # certification: max relative violation
    ok_stat: float = 1e-6    # certification: relative stationarity residual
    chunk: int = 4096        # lanes per KKT solve (bounds float64 memory)


class PolishResult(NamedTuple):
    z: Tensor     # [B, n] polished primal (per-lane fallback to the input)
    ok: Tensor    # [B] bool: lane certified to f64 optimality
    viol: Tensor  # [B] max relative constraint violation of the output
    stat: Tensor  # [B] relative stationarity residual of the output


@dataclasses.dataclass(frozen=True)
class Guards:
    """The guard rows and groups of a problem family on one device.

    rows: global row indices (shared rows first, then dynamic) of the
    bounds of zero-curvature slack columns; they enter the pool at
    near-equality priority. group_mask [G, m]: row r belongs to group g;
    each group lists every row touching one zero-curvature column, and the
    working set keeps >= 1 row of each group (None: no groups)."""
    rows: Tuple[int, ...]
    row_mask: Tensor
    group_mask: Optional[Tensor]


def make_guards(guard_rows: Sequence[int], guard_groups: Sequence[Sequence[int]], m: int,
                device) -> Guards:
    """Build the masks once (a host-to-device copy). Raises if two groups
    share a row or a group holds row 0: the vectorised cover steps equal the
    JAX package's sequential loop over groups only then."""
    rows = tuple(int(i) for i in guard_rows)
    groups = [tuple(int(i) for i in g) for g in guard_groups]
    flat = [i for g in groups for i in g]
    if len(set(flat)) != len(flat) or 0 in flat:
        raise ValueError("polish guard groups must be disjoint and must not hold row 0")
    row_mask = torch.zeros(m, dtype=torch.bool)
    row_mask[torch.tensor(rows, dtype=torch.long)] = True
    group_mask = None
    if groups:
        group_mask = torch.zeros(len(groups), m, dtype=torch.bool)
        for g, members in enumerate(groups):
            group_mask[g, torch.tensor(members, dtype=torch.long)] = True
        group_mask = group_mask.to(device)
    return Guards(rows, row_mask.to(device), group_mask)


def _top(key: Tensor, k: int) -> Tensor:
    """Positions of the k largest entries of each row, equal keys in index
    order (as ``jax.lax.top_k``)."""
    return torch.sort(key, dim=1, descending=True, stable=True).indices[:, :k]


def _polish_chunk(P, A_s, q, lb_s, ub_s, A_d, lb_d, ub_d, x0, cfg: PolishConfig,
                  pool: int, guards: Guards) -> PolishResult:
    """One chunk of lanes. All inputs float64 on one device.

    P [n,n]; A_s [m_s,n]; q/x0 [B,n]; lb_s/ub_s [B,m_s]; A_d [B,m_d,n];
    lb_d/ub_d [B,m_d]."""
    B, n = q.shape
    m_s, m_d = A_s.shape[0], A_d.shape[1]
    m = m_s + m_d
    dev = q.device
    inf = float("inf")

    lb = torch.cat([lb_s, lb_d], dim=1)                         # [B, m]
    ub = torch.cat([ub_s, ub_d], dim=1)

    # row infinity norms (scale-aware tolerances)
    rn_s = torch.amax(A_s.abs(), dim=1)                         # [m_s]
    rn_d = torch.amax(A_d.abs(), dim=2)                         # [B, m_d]
    rn1 = torch.cat([rn_s.expand(B, m_s), rn_d], dim=1).clamp_min(1e-12)

    # bound scale per row: violations are judged relative to this; an
    # infinite (BIG) side must not inflate it
    bscale = torch.maximum(torch.where(lb > -BIG / 2, lb.abs(), 0.0),
                           torch.where(ub < BIG / 2, ub.abs(), 0.0)).clamp_min(1.0)
    eq = (ub - lb) <= 1e-9 * bscale                             # [B, m]
    masked = (lb <= -BIG / 2) & (ub >= BIG / 2)                 # padding rows
    free = ~eq & ~masked

    def matvec(x):                                              # [B,n] -> [B,m]
        return torch.cat([x @ A_s.T, torch.einsum("bdj,bj->bd", A_d, x)], dim=1)

    def gather_rows(idx):                                       # [B,pool] -> [B,pool,n]
        def dyn():
            di = (idx - m_s).clamp(0, m_d - 1)
            return torch.gather(A_d, 1, di[..., None].expand(-1, -1, n))
        if m_s == 0:
            return dyn()
        shared = A_s[idx.clamp(0, m_s - 1)]
        return torch.where((idx < m_s)[..., None], shared, dyn()) if m_d else shared

    def take(a, idx):
        return torch.gather(a, 1, idx)

    P_reg = P + cfg.sigma * torch.eye(n, dtype=F64, device=dev)
    row_ids = torch.arange(m, device=dev)
    GM = guards.group_mask                                      # [G, m] or None

    # initial working set from the f32 solution: violated or within the f32
    # resolution band of a bound. Guard rows get near-equality POOL priority
    # so they are always pinnable; they are not pinned unconditionally
    Ax0 = matvec(x0)
    d0 = torch.minimum(Ax0 - lb, ub - Ax0)
    active0 = free & (d0 <= cfg.act_tol * bscale)
    guard_key = (guards.row_mask & free).to(F64) * 1e9          # [B, m]

    def ensure_cover(active_new, closeness):
        """Boundedness invariant: each zero-curvature (slack) column keeps
        >= 1 of its rows (its guard group) in the working set; an uncovered
        group gets the row of the group closest to (or deepest past) its
        bound."""
        if GM is None:
            return active_new
        sel = GM & free[:, None, :]                             # [B, G, m]
        covered = (active_new[:, None, :] & sel).any(-1)        # [B, G]
        best = torch.where(sel, closeness[:, None, :], -inf).argmax(-1)
        hit = (row_ids == best[..., None]) & ~covered[..., None]
        return active_new | hit.any(1)

    qscale = torch.amax(q.abs(), dim=1).clamp_min(1.0)          # [B] dual scale
    y_drop = cfg.y_tol * qscale[:, None]

    def pool_of(x, active):
        """(A x, scaled distance to the nearer bound, pool positions): the
        pool takes equalities first, then guard rows, then the current
        actives, then rows by proximity/violation at x."""
        Ax = matvec(x)
        d = torch.minimum(Ax - lb, ub - Ax) / bscale
        key = (eq & ~masked).to(F64) * 1e12 + guard_key \
            + active.to(F64) * 1e6 + torch.where(masked, -1e18, -d)
        return Ax, d, _top(key, pool)

    def round_body(x, active, side, mass: bool):
        _, d, idx = pool_of(x, active)
        rn_g = take(rn1, idx)
        G = gather_rows(idx) / rn_g[..., None]                  # row-normalized
        eq_g = take(eq & ~masked, idx)
        act_g = take(active, idx)
        pin = eq_g | act_g                                      # [B, pool]

        # Cap the PINNED set at n rows: priority equalities, then each guard
        # group's best covering row, then actives by proximity.
        if GM is not None:
            sel = GM & (active & free)[:, None, :]              # [B, G, m]
            best = torch.where(sel, -d[:, None, :], -inf).argmax(-1)
            cover_best = ((row_ids == best[..., None]) & sel.any(-1)[..., None]).any(1)
            cover_g = take(cover_best, idx)
        else:
            cover_g = torch.zeros_like(eq_g)
        d_g = take(d, idx)
        rank_key = torch.where(eq_g, inf, torch.where(
            act_g, cover_g.to(F64) * 1e9 - d_g, -inf))
        keep_pos = _top(rank_key, min(n, pool))
        pin = pin & torch.zeros_like(pin).scatter_(1, keep_pos, True)
        side_hi = take(side, idx)
        b_g = torch.where(side_hi, take(ub, idx), take(lb, idx)) / rn_g

        pinf = pin.to(F64)
        Gp = G * pinf[..., None]
        K = torch.cat([torch.cat([P_reg.expand(B, n, n), Gp.mT], dim=2),
                       torch.cat([Gp, torch.diag_embed(-cfg.delta * pinf - (1.0 - pinf))], dim=2)],
                      dim=1)
        rhs = torch.cat([-q, pinf * b_g], dim=1)
        # symmetric Jacobi scaling plus one iterative-refinement pass (the
        # flagship P spans ~15 orders of magnitude)
        s = 1.0 / torch.sqrt(torch.amax(K.abs(), dim=2).clamp_min(1e-12))
        Ks = s[:, :, None] * K * s[:, None, :]
        rs = s * rhs
        fac = plu_factor(Ks)
        sols = plu_solve(fac, rs)
        resid = rs - torch.einsum("bij,bj->bi", Ks, sols)
        sol = s * (sols + plu_solve(fac, resid))
        x_new, y_g = sol[:, :n], sol[:, n:]

        # reject non-finite AND runaway solutions; a rejected lane keeps its
        # point and set for this round
        xmag = torch.amax(x.abs(), dim=1)
        fin = torch.isfinite(x_new).all(1) \
            & (torch.amax(x_new.abs(), dim=1) <= 1e8 * xmag.clamp_min(1.0))
        x_new = torch.where(fin[:, None], x_new, x)

        Axn = matvec(x_new)
        v_lo = (lb - Axn) / bscale                              # >0: lb violated
        v_hi = (Axn - ub) / bscale
        viol_amt = torch.maximum(v_lo, v_hi)
        # KKT convention Px + q + G'y = 0: a row pinned at its upper bound
        # has y >= 0 at the optimum, one at its lower bound y <= 0
        wrongness = torch.where(side_hi, y_g, -y_g)             # <0 => wrong sign
        wrongness = torch.where(pin & ~eq_g & fin[:, None], wrongness, inf)

        if mass:
            # re-derive the whole working set: keep right-signed pins, drop
            # wrong-signed ones, add every violated row
            act_vals = pin & ~eq_g & ~(wrongness < -y_drop)
            active_new = torch.zeros_like(active).scatter_(1, idx, act_vals)
            active_new = active_new | ((viol_amt > cfg.viol_tol) & free)
            active_new = torch.where(fin[:, None], active_new, active)
            active_new = ensure_cover(active_new, viol_amt)
            side_new = torch.where(active_new & ~active, v_hi > v_lo, side)
        else:
            # one working-set change per lane and round, drops first, then
            # the most-violated row
            drop_pos = torch.argmin(wrongness, dim=1, keepdim=True)
            drop_any = (take(wrongness, drop_pos) < -y_drop)[:, 0] & fin
            drop_row = take(idx, drop_pos)[:, 0]
            viol_sel = torch.where(eq | masked | active, -inf, viol_amt)
            add_row = torch.argmax(viol_sel, dim=1, keepdim=True)
            add_any = fin & ~drop_any & (take(viol_sel, add_row)[:, 0] > cfg.viol_tol)
            add_side = take(v_hi, add_row)[:, 0] > 0.0
            hit_add = (row_ids == add_row) & add_any[:, None]
            hit_drop = (row_ids == drop_row[:, None]) & drop_any[:, None]
            active_new = ensure_cover((active | hit_add) & ~hit_drop, viol_amt)
            side_new = torch.where(active_new & ~active,
                                   torch.where(hit_add, add_side[:, None], v_hi > v_lo), side)
        return x_new, active_new, side_new

    # initial pin side: nearer bound at the entry point
    x, side = x0, (ub - Ax0) < (Ax0 - lb)
    active = ensure_cover(active0, torch.maximum(lb - Ax0, Ax0 - ub) / bscale)
    for r in range(cfg.mass_rounds + cfg.rounds):
        x, active, side = round_body(x, active, side, mass=r < cfg.mass_rounds)

    # certification: least-squares multipliers of the final set, violation
    # and stationarity of the final point
    Ax, d, idx = pool_of(x, active)
    viol = torch.amax(torch.where(masked, 0.0, (-d).clamp_min(0.0)), dim=1)
    G = gather_rows(idx) / take(rn1, idx)[..., None]
    pin = take((eq | active) & ~masked, idx)
    r0 = x @ P.T + q                                            # [B, n]
    Gp = G * pin[..., None].to(F64)
    GG = torch.einsum("bpj,bqj->bpq", Gp, Gp)
    gy = -torch.einsum("bpj,bj->bp", Gp, r0)
    y_ls = spd_solve(GG, gy, jitter=1e-12)
    stat = torch.amax((r0 + torch.einsum("bpj,bp->bj", Gp, y_ls)).abs(), dim=1) / qscale

    # dual-sign check: a feasible stationary point with a wrong-sign
    # multiplier on an inequality is the optimum of the wrong working set
    Ax_g = take(Ax, idx)
    side_fin = (take(ub, idx) - Ax_g) < (Ax_g - take(lb, idx))
    tol = 1e-6 * qscale[:, None]
    sign_bad = (pin & ~take(eq, idx)
                & torch.where(side_fin, y_ls < -tol, y_ls > tol)).any(1)

    ok = (viol <= cfg.ok_viol) & (stat <= cfg.ok_stat) & ~sign_bad & torch.isfinite(x).all(1)
    return PolishResult(z=torch.where(ok[:, None], x, x0), ok=ok, viol=viol, stat=stat)


def _polish(P, A_s, q, lb_s, ub_s, A_d, lb_d, ub_d, x0, cfg: PolishConfig, pool: int,
            guards: Guards) -> PolishResult:
    """Lane chunks of cfg.chunk; a batch that does not divide runs whole."""
    B = q.shape[0]
    chunk = min(cfg.chunk, B)
    if B % chunk != 0:
        chunk = B
    lanes = (q, lb_s, ub_s, A_d, lb_d, ub_d, x0)
    parts = [_polish_chunk(P, A_s, *(a[i:i + chunk] for a in lanes), cfg, pool, guards)
             for i in range(0, B, chunk)]
    if len(parts) == 1:
        return parts[0]
    return PolishResult(*(torch.cat(f) for f in zip(*parts)))


def polish_structured(P, A_s, q, lb_s, ub_s, A_d, lb_d, ub_d, x0,
                      cfg: PolishConfig = PolishConfig(),
                      max_eq: Optional[int] = None,
                      guard_rows=(), guard_groups=(),
                      guards: Optional[Guards] = None) -> PolishResult:
    """Polish a batch of structured QPs (shared A_s + per-lane A_d) in f64.

    P [n,n] and A_s [m_s,n] shared (tensors or numpy); q/x0 [B,n];
    lb_s/ub_s [B,m_s]; A_d [B,m_d,n]; lb_d/ub_d [B,m_d]. Inputs may be f32
    (the production entry path); everything is upcast to float64 on the
    device of q, and the result is float64.

    guard_rows / guard_groups: as in the JAX package (see ``Guards``);
    ``guards``: the same, built once by ``make_guards`` (a caller that
    polishes often passes it and skips the host-to-device copies).
    max_eq: the number of equality rows (default m_s, the worst case).
    """
    dev = q.device
    to64 = lambda a: torch.as_tensor(a, dtype=F64, device=dev)
    m_s, m_d = A_s.shape[0], A_d.shape[1]
    if guards is None:
        guards = make_guards(guard_rows, guard_groups, m_s + m_d, dev)
    if max_eq is None:
        max_eq = m_s
    # guard rows enter the pool at priority 1e9 (above actives): widen the
    # pool by their count so they never displace pinnable slots
    pool = min(max_eq + len(guards.rows) + cfg.pool_extra, m_s + m_d)
    return _polish(to64(P), to64(A_s), to64(q), to64(lb_s), to64(ub_s), to64(A_d),
                   to64(lb_d), to64(ub_d), to64(x0), cfg, pool, guards)


def polish_dense(qp, x0, cfg: PolishConfig = PolishConfig(),
                 max_eq: Optional[int] = None) -> PolishResult:
    """Polish a dense QPBatch. P must be shared across the batch (it is for
    every controller of the package: only q, A and the bounds vary per
    lane); a [B, n, n] P gives its first lane's."""
    P = qp.P[0] if qp.P.ndim == 3 else qp.P
    B, n = qp.q.shape
    dev = qp.q.device
    to64 = lambda a: torch.as_tensor(a, dtype=F64, device=dev)
    lb, ub = to64(qp.lb), to64(qp.ub)
    if max_eq is None:
        # the same RELATIVE equality test as _polish_chunk, counted on the
        # device; one integer comes back
        bscale = torch.maximum(torch.where(lb > -BIG / 2, lb.abs(), 0.0),
                               torch.where(ub < BIG / 2, ub.abs(), 0.0)).clamp_min(1.0)
        max_eq = int(((ub - lb) <= 1e-9 * bscale).sum(-1).max())
    pool = min(max_eq + cfg.pool_extra, qp.m)
    empty = torch.zeros((B, 0), dtype=F64, device=dev)
    return _polish(to64(P), torch.zeros((0, n), dtype=F64, device=dev), to64(qp.q), empty,
                   empty, to64(qp.A), lb, ub, to64(x0), cfg, pool,
                   make_guards((), (), qp.m, dev))
