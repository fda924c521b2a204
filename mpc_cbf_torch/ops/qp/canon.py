"""Canonicalization helpers for dense batched QPs (counterpart of
``mpc_cbf_tpu/ops/qp/canon.py``).

A QP is a fixed-shape tensor tuple (:class:`mpc_cbf_torch.types.QPBatch`):

- variable box bounds become identity rows (an ADMM projection treats all
  rows uniformly),
- a variable number of constraints becomes a *static* maximum number of rows
  with inactive rows masked by (lb, ub) = (-BIG, +BIG) and zero coefficients,
- equality constraints are rows with lb == ub.
"""

from __future__ import annotations

import numpy as np
import torch

from mpc_cbf_torch.types import BIG


def box_rows(n: int, lb, ub, *, dtype: torch.dtype, device: torch.device | str):
    """Identity rows encoding lb <= z <= ub."""
    A = torch.eye(n, dtype=dtype, device=device)
    return (A, torch.as_tensor(lb, dtype=dtype, device=device),
            torch.as_tensor(ub, dtype=dtype, device=device))


def pad_rows(A: torch.Tensor, lb: torch.Tensor, ub: torch.Tensor, m_total: int):
    """Pad (A, lb, ub) with inactive rows up to m_total."""
    m = A.shape[-2]
    if m > m_total:
        raise ValueError(f"{m} rows exceed budget {m_total}")
    pad = m_total - m
    A_p = torch.cat([A, A.new_zeros((*A.shape[:-2], pad, A.shape[-1]))], dim=-2)
    lb_p = torch.cat([lb, lb.new_full((*lb.shape[:-1], pad), -BIG)], dim=-1)
    ub_p = torch.cat([ub, ub.new_full((*ub.shape[:-1], pad), BIG)], dim=-1)
    return A_p, lb_p, ub_p


def stack_qp(rows):
    """Concatenate a list of (A, lb, ub) row groups along the row axis."""
    As, lbs, ubs = zip(*rows)
    return torch.cat(As, dim=-2), torch.cat(lbs, dim=-1), torch.cat(ubs, dim=-1)


def np_pad_rows(A: np.ndarray, lb: np.ndarray, ub: np.ndarray, m_total: int):
    """numpy variant of pad_rows for build-time constant blocks."""
    m, n = A.shape
    out_A = np.zeros((m_total, n))
    out_lb = np.full(m_total, -BIG)
    out_ub = np.full(m_total, BIG)
    out_A[:m] = A
    out_lb[:m] = lb
    out_ub[:m] = ub
    return out_A, out_lb, out_ub
