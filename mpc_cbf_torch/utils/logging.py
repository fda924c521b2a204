"""Logging setup and array formatting (counterpart of
``mpc_cbf_tpu/utils/logging.py``).

Reference parity: ``common/include/common/logging.hpp``:
initializeLogging (spdlog pattern + SPDLOG_LEVEL/LOG_LEVEL env, :64-101),
matrix/vector toString + logMatrix/logVector (:106-178).
"""

from __future__ import annotations

import logging
import os

import numpy as np

_FMT = "[%(asctime)s] [%(name)s] [%(levelname)s] %(message)s"


def initialize_logging(name: str = "mpc_cbf_torch") -> logging.Logger:
    """Logger with the reference's pattern; level from SPDLOG_LEVEL or
    LOG_LEVEL env (logging.hpp:64-101), default INFO."""
    level_name = (os.environ.get("SPDLOG_LEVEL")
                  or os.environ.get("LOG_LEVEL") or "info").upper()
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(_FMT, datefmt="%Y-%m-%d %H:%M:%S"))
        logger.addHandler(h)
    logger.setLevel(getattr(logging, level_name, logging.INFO))
    return logger


def matrix_to_string(m, precision: int = 6) -> str:
    """Eigen-style row-per-line rendering (logging.hpp:106-150); takes
    numpy arrays and CPU tensors."""
    a = np.asarray(m)
    if a.ndim == 1:
        a = a[None, :]
    return "\n".join(" ".join(f"{v:.{precision}g}" for v in row) for row in a)


def log_matrix(logger: logging.Logger, name: str, m, level=logging.INFO):
    logger.log(level, "%s =\n%s", name, matrix_to_string(m))


def log_vector(logger: logging.Logger, name: str, v, level=logging.INFO):
    logger.log(level, "%s = [%s]", name, " ".join(f"{x:.6g}" for x in np.asarray(v).ravel()))
