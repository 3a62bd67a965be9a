"""R-style CSV loading for the OWL-QN regression fixtures.

The reference test loader (``tests/owlqn.rs:66-83``): skip the header row
and the first (row-name) column, and parse the rest as float64.  The
package's own copy of ``lbfgs_tpu/utils/csvio.py``.
"""

from __future__ import annotations

import numpy as np


def read_r_csv(path: str) -> np.ndarray:
    """Read an R ``write.csv`` file, dropping the header row and the first
    column."""
    rows = []
    with open(path) as f:
        next(f)  # header
        for line in f:
            cols = line.strip().split(",")[1:]
            rows.append([float(c.strip('"')) for c in cols])
    return np.asarray(rows, dtype=np.float64)
