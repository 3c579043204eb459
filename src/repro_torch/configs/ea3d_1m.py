"""ea3d-1m [ising]: the paper's own workload — 10^6 p-bit 3D EA spin glass
(L=100, x/y padded to 112 for the mesh), brick-partitioned over the whole
pod; it runs the lattice DSIM (``make_engine("lattice", L=100)``) instead
of an LM step.  N_color=2 (even L), s{4}{1} fixed point, LFSR RNG."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="ea3d-1m", family="ising",
    n_layers=0, d_model=0, n_heads=0, n_kv_heads=0, d_ff=0, vocab=0,
    group=(),
    notes="paper production config: 100^3 EA, 1-bit halo exchange, eta=1/S",
))
