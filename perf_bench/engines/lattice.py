"""The system under test for the lattice configurations: the port's
``make_engine("lattice", L=..., seed=...)``, one brick on one device
(``LatticeDSIM``), behind the registry handle.

A job's state goes in through the engine's own entry for a state in the
reference's global shapes (``LatticeDSIM.shard_state``): the W spin word
planes and the R lanes' xorshift32 states of the bit-plane path; the
halos of one brick are its own opposite z faces (the periodic seam) and
zero x and y planes (the open faces, whose couplings are zero).
"""

from __future__ import annotations

import torch

from repro_torch import make_engine
from repro_torch.core.lattice_dsim import BitplaneLatticeState
from repro_torch.core.pbit import FixedPoint

from perf_bench.engines import base
from perf_bench.reference.ea3d import lanes_to_spins


class System(base.System):
    """One engine of configuration ``config`` for traffic ``traffic``,
    its instance drawn from ``seed``, on ``device``."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        super().__init__(config, traffic)
        self.handle = make_engine(
            "lattice", L=self.L, seed=seed, replicas=self.lanes,
            precision=self.precision, fmt=FixedPoint(*config["format"]),
            device=device)

    def program_state(self, words: torch.Tensor, states: torch.Tensor):
        """The reference's global shapes of a drawn job: words (W, X, Y, Z)
        and states (R, X, Y, Z) int32 on the device."""
        W, X, Y, Z = (int(d) for d in words.shape)
        zx = words.new_zeros((W, 1, Y, Z))
        zy = words.new_zeros((W, X, 1, Z))
        halos = (zx, zx.clone(), zy, zy.clone(),
                 words[..., Z - 1:].contiguous(), words[..., :1].contiguous())
        return BitplaneLatticeState(
            m=words.view(torch.uint32), s=states.view(torch.uint32),
            halos=tuple(h.view(torch.uint32) for h in halos),
            sweep=torch.zeros((), dtype=torch.int32, device=words.device),
            flips=torch.zeros((self.lanes,), dtype=torch.int32,
                              device=words.device))

    def keep(self, state, lanes) -> dict:
        """A job's final word planes and the states of lanes ``lanes``, as
        they lie, copied to the host (the raw int32 views: the window pays
        for the copy alone)."""
        st = self.handle.eng.global_state(state)
        idx = torch.tensor(lanes, device=st.s.device)
        return {"m": st.m.view(torch.int32).cpu(),
                "s": st.s.view(torch.int32).index_select(0, idx).cpu()}

    def lattice_form(self, kept: dict, lanes) -> dict:
        """:meth:`keep`'s copy as the spins (len(lanes), X, Y, Z) int8 and
        states (the same shape) int64 of lanes ``lanes``."""
        return {"m": lanes_to_spins(kept["m"], self.lanes)[list(lanes)],
                "s": kept["s"].to(torch.int64) & 0xFFFFFFFF}
