"""Lennard-Jones cluster energy and gradient (the geometry relaxation
workload behind the reference's gradient-only and damped modes,
``examples/lj.rs:3-129``).

The reference loops over atom pairs; here the whole [N, N] pair matrix
is computed at once with torch ops on the positions' device, as the JAX
package does (``lbfgs_tpu/models/lennard_jones.py``), with the diagonal
masked the same way.  Positions are a flat [3N] vector, so the solver
treats them like any parameter vector; the gradient is minus the forces.
The objective is a generic one: it carries no fused-kernel protocol, so
the solver takes its composed branch (under damping, ``update_pair``)
and the direction combine (K3).

Pair potential (epsilon = sigma = 1 by default):
    v(r)  = 4 eps ((s/r)^12 - (s/r)^6)
    v'(r) = 24 eps ((s/r)^6 - 2 (s/r)^12) / r
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class LennardJones:
    epsilon: float = 1.0
    sigma: float = 1.0

    def value_and_grad(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        n = x.shape[0] // 3
        pos = x.reshape(n, 3)
        diff = pos[:, None, :] - pos[None, :, :]            # [N, N, 3]
        r2 = torch.sum(diff * diff, dim=-1)                  # [N, N]
        eye = torch.eye(n, dtype=torch.bool, device=x.device)
        r2_safe = torch.where(eye, 1.0, r2)
        inv_r2 = (self.sigma * self.sigma) / r2_safe
        s6 = inv_r2 * inv_r2 * inv_r2
        s12 = s6 * s6
        pair_e = torch.where(eye, 0.0, 4.0 * self.epsilon * (s12 - s6))
        energy = 0.5 * torch.sum(pair_e)
        # dv/dr / r, so that force_ij = -(dv/dr)/r * diff_ij
        dvdr_over_r = torch.where(eye, 0.0, 24.0 * self.epsilon * (s6 - 2.0 * s12) / r2_safe)
        # gradient of the energy in pos_i: sum_j (dv/dr)/r * (pos_i - pos_j)
        grad = torch.sum(dvdr_over_r[:, :, None] * diff, dim=1)
        return energy, grad.reshape(-1)


#: The reference example's 38-atom start geometry (``examples/lj.rs:70-109``),
#: flat [x0, y0, z0, x1, ...], the same numbers as the JAX package's
LJ38_START = np.array([
    50.27754123, 50.04898929, 50.13164926,
    49.54021264, 50.20208324, 49.33142540,
    50.36795885, 50.91366213, 49.53932153,
    49.71004612, 49.12254218, 50.30950773,
    51.59992702, 50.93225616, 49.75465016,
    49.54096326, 50.01499737, 50.89785480,
    49.27589571, 49.40276757, 51.78288271,
    50.84293978, 51.39416756, 50.37578558,
    50.85011555, 49.18468518, 49.88733738,
    50.48954837, 48.31866393, 50.39752223,
    49.54570033, 50.99619360, 50.39370291,
    50.83198382, 49.97838559, 49.15111253,
    48.68259959, 51.76333286, 50.71665986,
    48.78703201, 50.74137148, 48.70964574,
    50.46846546, 50.64822201, 51.05913458,
    50.32617974, 51.72202742, 51.25600177,
    48.98719425, 48.57072315, 50.86630469,
    49.41532317, 48.01960200, 49.86479222,
    50.33160898, 51.97929717, 49.55667898,
    50.05747126, 48.65423592, 51.34871762,
    49.47506697, 52.40222682, 50.09998700,
    50.08941533, 50.76191893, 48.51033008,
    49.66096522, 52.51096459, 51.72590563,
    49.26806275, 51.61276429, 49.24438196,
    51.33222714, 48.66903395, 51.03264292,
    48.82443599, 48.10619401, 51.83279474,
    49.32661434, 51.45251656, 51.52447147,
    48.60626152, 50.67040668, 51.00622736,
    48.66876297, 50.02851267, 49.95976353,
    48.45421774, 49.58111803, 50.93806524,
    49.23169585, 49.11782673, 49.33972073,
    50.51551634, 47.49882067, 49.67074204,
    50.53443706, 49.65001264, 51.43455000,
    51.64327906, 48.46431354, 49.94896031,
    51.54629763, 49.42747135, 51.83066872,
    49.51504504, 50.47172337, 51.84485663,
    49.10265035, 52.00399992, 52.61150826,
    49.66462610, 47.60012985, 50.93620680,
])


def lj38_positions(dtype=torch.float64, device="cuda") -> torch.Tensor:
    """The reference LJ38 example's start geometry (``examples/lj.rs:70-109``)
    as a flat [114] vector, on the card unless ``device`` names another."""
    return torch.tensor(LJ38_START, dtype=dtype, device=device)


def lj38_grid_start(dtype=torch.float64, device="cuda") -> torch.Tensor:
    """A synthetic 38-atom start: a 4x4x4 grid of spacing 1.1 around
    (50, 50, 50), its first 38 points perturbed by numpy's RandomState(38)
    (the JAX package's numbers; a harder start, kept for stress tests), on
    the card unless ``device`` names another."""
    rng = np.random.RandomState(38)
    ijk = np.array([(i, j, k) for i in range(4) for j in range(4) for k in range(4)])
    pts = 50.0 + 1.1 * ijk[:38].astype(np.float64)
    pts += 0.05 * rng.randn(*pts.shape)
    return torch.tensor(pts.reshape(-1), dtype=dtype, device=device)


def make_objective(epsilon: float = 1.0, sigma: float = 1.0):
    """The LJ cluster as a generic value-and-grad objective."""
    lj = LennardJones(epsilon, sigma)

    def vag(x):
        return lj.value_and_grad(x)

    vag.__lbfgs_value_and_grad__ = True
    return vag
