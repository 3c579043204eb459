"""The conservative clocking bound of the paper (S4), as
``repro.core.commcost`` gives it; the port may not import that module.

  C_max = max_{a<b} b_ab * d_ab / P_ab          (Eq. S.3)
  f_p-bit <= f_comm / (2 * N_color * C_max)     (Eq. 2 / S.6)
  eta_threshold = 2 * N_color * C_max

Only the threshold is here: :class:`repro_torch.obs.timing.EtaMeter` is
its one caller.  The partition costs (``boundary_matrix``, the chain and
ring topologies, ``comm_cost``) come with the engines that compute a
``C_max`` (ROADMAP.md queue A item 7).
"""

from __future__ import annotations

__all__ = ["eta_threshold"]


def eta_threshold(n_color: int, c_max: float) -> float:
    """Eq. 2: the ratio above which the distributed machine matches monolithic."""
    return 2.0 * n_color * c_max
