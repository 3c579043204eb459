"""The ELL word gather-count (``bitplane_gather_count``) against the JAX
reference's ``bitplane_gather_count_ref``.

The port's op carries a partition axis (one call covers the K partitions
of a one-process mesh); at each partition k it must equal the reference's
op on that partition's pool and rows, bit for bit: the same number of
bit-slice planes, ``ceil(log2(D+1))``, in the same order.  Inputs are
numpy, from a seed: random words, ELL rows with repeated neighbours, and
sign and nonzero planes with zero couplings among them.  The planes are
also held to an independent per-lane count.
"""

import numpy as np
import pytest
import torch

from repro.core import packing as j_pack
from repro.kernels import ref as j_ref
from repro_torch.core import packing as t_pack
from repro_torch.core.bits import u32_from_numpy, u32_to_numpy
from repro_torch.kernels import ops
from repro_torch.kernels import ref as t_ref
from repro_torch.kernels.bitplane_gather import (MAX_DEGREE,
                                                 bitplane_gather_count,
                                                 n_slices)


def inputs(seed, K, W, D, nc=37, n_ext=53):
    rng = np.random.default_rng(seed)
    words = lambda *sh: rng.integers(0, 2 ** 32, size=sh,  # noqa: E731
                                     dtype=np.uint32)
    mext = words(K, W, n_ext)
    idx = rng.integers(0, n_ext, size=(K, nc, D), dtype=np.int32)
    ones = np.uint32(0xFFFFFFFF)
    signs = np.where(rng.random((K, nc, D)) < 0.5, ones, 0).astype(np.uint32)
    nz = np.where(rng.random((K, nc, D)) < 0.8, ones, 0).astype(np.uint32)
    return mext, idx, signs, nz


def torch_inputs(*arrays):
    return tuple(u32_from_numpy(a, "cpu") if a.dtype == np.uint32
                 else torch.from_numpy(a) for a in arrays)


@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("W", [1, 2, 3])
@pytest.mark.parametrize("D", [1, 3, 4, 6, 7, 12])
def test_gather_count_matches_jax_per_partition(D, W, K):
    mext, idx, signs, nz = inputs(D * 100 + W * 10 + K, K, W, D)
    got = ops.bitplane_gather_count_op(*torch_inputs(mext, idx, signs, nz))
    assert len(got) == n_slices(D) == int(np.ceil(np.log2(D + 1)))
    for k in range(K):
        want = j_ref.bitplane_gather_count_ref(mext[k], idx[k], signs[k],
                                               nz[k])
        assert len(want) == len(got)
        for g, w in zip(got, want):
            assert g.dtype == torch.uint32 and g.shape == (K, W, 37)
            np.testing.assert_array_equal(u32_to_numpy(g)[k], np.asarray(w))


@pytest.mark.parametrize("D", [1, 6, 12, 31])
def test_gather_count_planes_count_every_lane(D):
    """sum_i 2^i bit_l(plane_i) is lane l's number of neighbours d with
    (word_d ^ sign_d) & nz_d set at bit l."""
    K, W = 2, 2
    mext, idx, signs, nz = inputs(D, K, W, D)
    planes = bitplane_gather_count(*torch_inputs(mext, idx, signs, nz))
    lanes = np.arange(32, dtype=np.uint32)
    count = sum(((u32_to_numpy(p)[..., None] >> lanes) & 1).astype(np.int64)
                << i for i, p in enumerate(planes))
    nbr = mext[np.arange(K)[:, None, None, None],
               np.arange(W)[None, :, None, None], idx[:, None]]
    t = (nbr ^ signs[:, None]) & nz[:, None]               # (K, W, nc, D)
    want = ((t[..., None] >> lanes) & 1).astype(np.int64).sum(axis=-2)
    np.testing.assert_array_equal(count, want)


def test_count_planes_ripple_rule():
    """A new slice is appended only when the count can reach the next
    power of two: D planes give ceil(log2(D+1)) slices, as the
    reference's ``bitplane_count_planes_ref``."""
    for D in range(1, MAX_DEGREE + 1):
        planes = [torch.full((3,), -1, dtype=torch.int32)] * D
        got = t_ref.bitplane_count_planes_ref(planes)
        want = j_ref.bitplane_count_planes_ref(
            [np.full((3,), 0xFFFFFFFF, np.uint32)] * D)
        assert len(got) == len(want) == n_slices(D)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy().view(np.uint32),
                                          np.asarray(w))


def test_gather_count_dispatch_on_the_cpu():
    """On CPU tensors "auto" and "ref" run the plain version; "cuda"
    raises; the wrapper takes the plain version only for a CPU tensor."""
    args = torch_inputs(*inputs(0, 2, 1, 6))
    a = ops.bitplane_gather_count_op(*args, impl="auto")
    b = ops.bitplane_gather_count_op(*args, impl="ref")
    c = bitplane_gather_count(*args)
    for x, y, z in zip(a, b, c):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))
        assert torch.equal(x.view(torch.int32), z.view(torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        ops.bitplane_gather_count_op(*args, impl="cuda")


@pytest.mark.parametrize("n_lanes,ndim", [(1, 1), (5, 2), (32, 1),
                                          (40, 1), (256, 3)])
def test_lane_coords_match_jax(n_lanes, ndim):
    """The lane of each replica: word l // 32 at bit l % 32, shaped to
    broadcast over ``ndim`` trailing dims, and so reading every lane of
    packed words back."""
    jw, jb = j_pack.lane_coords(n_lanes, ndim)
    tw, tb = t_pack.lane_coords(n_lanes, ndim)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    assert tb.shape == np.asarray(jb).shape
    rng = np.random.default_rng(n_lanes)
    x = torch.from_numpy(rng.choice(np.array([-1, 1], np.int8),
                                    (n_lanes,) + (3,) * ndim))
    words = t_pack.pack_lanes(x).view(torch.int32).to(torch.int64)
    bits = (words[tw] >> tb) & 1
    assert torch.equal(bits, (x > 0).to(torch.int64))
