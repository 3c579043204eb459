"""roofline_share.bitplane_sweep (%): kernel #2, the bit-plane colour phase
of the lattice (``kernels/csrc/pbit_bitplane.cu``): the frozen model's
bound of every ``pbit_bitplane_sweep`` call the program noted in the
traced jobs, over the device time of its launches there.  Layer: the
kernels.  Moves updates_per_s."""

from perf_bench.timeline import roofline_share

# the name its wrapper notes a call under, and its CUDA kernel's symbol
NOTE = "pbit_bitplane_sweep"
KERNEL = "bitplane_color_kernel"


def read(tl):
    return roofline_share(tl, NOTE, KERNEL)
