"""The port's ``core.packing`` against the reference's: the 1-bit
wire/site format and the multi-word lane fabric (W stacked uint32 word
planes, 32 lanes each).

The port of ``tests/test_packing.py``, case by case, on the CPU.  Every
case that packs, unpacks or permutes also runs the reference's function
on the same numpy inputs and holds the port's words or spins to it
bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packing as J
from repro_torch.core.packing import (LANE_WIDTH, MAX_LANE_WORDS,
                                      lane_permute, lane_swap, lane_words,
                                      pack_lanes, pack_pm1, pad_to_multiple,
                                      unpack_lanes, unpack_pm1)

RNG = np.random.default_rng(5)


def same(port, ref):
    """Bitwise equality of a port tensor and a reference array."""
    got, want = port.numpy(), np.asarray(ref)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# -- site packing (pack_pm1 / unpack_pm1) -------------------------------------

@pytest.mark.parametrize("n", [1, 5, 7, 8, 9, 24, 31, 33, 100, 257])
def test_pack_pm1_round_trip_any_length(n):
    """Non-multiple-of-8 (and of-32) lengths round-trip through the
    pad-pack-unpack pipeline the halo exchange uses."""
    x = RNG.choice([-1, 1], size=n).astype(np.int8)
    npad = pad_to_multiple(n, 8)
    assert npad == J.pad_to_multiple(n, 8)
    padded = np.pad(x, (0, npad - n), constant_values=1)
    packed = pack_pm1(torch.from_numpy(padded))
    assert packed.dtype == torch.uint8
    assert packed.shape == (npad // 8,)
    same(packed, J.pack_pm1(jnp.asarray(padded)))
    out = unpack_pm1(packed, n)
    assert out.dtype == torch.int8
    np.testing.assert_array_equal(out.numpy(), x)


def test_pack_pm1_empty():
    packed = pack_pm1(torch.zeros((0,), dtype=torch.int8))
    assert packed.shape == (0,) and packed.dtype == torch.uint8
    out = unpack_pm1(packed, 0)
    assert out.shape == (0,) and out.dtype == torch.int8


def test_pack_pm1_leading_dims_and_reject_ragged():
    x = RNG.choice([-1, 1], size=(3, 2, 16)).astype(np.int8)
    packed = pack_pm1(torch.from_numpy(x))
    same(packed, J.pack_pm1(jnp.asarray(x)))
    np.testing.assert_array_equal(unpack_pm1(packed, 16).numpy(), x)
    with pytest.raises(ValueError):
        pack_pm1(torch.zeros((4, 13), dtype=torch.int8))


def test_pack_pm1_dtype_stability():
    """int32 +-1 input still packs to uint8 and unpacks to int8 — the
    wire dtypes never follow the caller's."""
    x = RNG.choice([-1, 1], size=24).astype(np.int32)
    packed = pack_pm1(torch.from_numpy(x))
    assert packed.dtype == torch.uint8
    same(packed, J.pack_pm1(jnp.asarray(x)))
    assert unpack_pm1(packed, 24).dtype == torch.int8


# -- lane packing (pack_lanes / unpack_lanes) ---------------------------------

@pytest.mark.parametrize("R", [1, 2, 7, 31, 32, 33, 64, 100])
def test_pack_lanes_round_trip(R):
    """Round trip at every word-boundary regime: sub-word, exactly one
    word, straddling into a second word, exactly two, and a ragged
    four-word count."""
    x = RNG.choice([-1, 1], size=(R, 4, 3, 5)).astype(np.int8)
    w = pack_lanes(torch.from_numpy(x))
    assert w.dtype == torch.uint32
    assert w.shape == (lane_words(R), 4, 3, 5)
    same(w, J.pack_lanes(jnp.asarray(x)))
    out = unpack_lanes(w, R)
    assert out.dtype == torch.int8
    np.testing.assert_array_equal(out.numpy(), x)


def test_pack_lanes_empty_sites():
    w = pack_lanes(torch.zeros((4, 0), dtype=torch.int8))
    assert w.shape == (1, 0) and w.dtype == torch.uint32
    out = unpack_lanes(w, 4)
    assert out.shape == (4, 0) and out.dtype == torch.int8


def test_pack_lanes_unused_lanes_zero():
    """Lanes >= R pack to 0 bits — confined to the LAST word plane, so the
    word tail is inert and growing the lane count later never reinterprets
    old words."""
    w = pack_lanes(torch.ones((3, 8), dtype=torch.int8)).numpy()
    assert w.shape == (1, 8) and (w == 0b111).all()
    w2 = pack_lanes(torch.ones((35, 8), dtype=torch.int8)).numpy()
    assert w2.shape == (2, 8)
    assert (w2[0] == 0xFFFFFFFF).all()      # full word: every lane live
    assert (w2[1] == 0b111).all()           # tail word: 3 live lanes only
    np.testing.assert_array_equal(
        w2, np.asarray(J.pack_lanes(jnp.ones((35, 8), jnp.int8))))


def test_pack_lanes_rejects_too_many():
    cap = MAX_LANE_WORDS * LANE_WIDTH
    with pytest.raises(ValueError):
        pack_lanes(torch.ones((cap + 1, 4), dtype=torch.int8))
    with pytest.raises(ValueError):
        unpack_lanes(torch.zeros((MAX_LANE_WORDS + 1, 4),
                                 dtype=torch.uint32), cap + 1)


def test_unpack_lanes_rejects_word_count_mismatch():
    """The word axis is load-bearing: unpacking R lanes from the wrong
    number of word planes is a contract violation, not a silent
    truncation."""
    with pytest.raises(ValueError):
        unpack_lanes(torch.zeros((1, 4), dtype=torch.uint32), 33)
    with pytest.raises(ValueError):
        unpack_lanes(torch.zeros((2, 4), dtype=torch.uint32), 32)


def test_pack_lanes_lane_bit_identity():
    """Bit r%32 of word plane r//32 is exactly lane r's spin sign — at a
    word-straddling lane count."""
    R = 41
    x = RNG.choice([-1, 1], size=(R, 17)).astype(np.int8)
    w = pack_lanes(torch.from_numpy(x)).numpy()
    for r in range(R):
        np.testing.assert_array_equal(
            (w[r // LANE_WIDTH] >> (r % LANE_WIDTH)) & 1, (x[r] > 0))


def test_pack_lanes_prefix_stability_across_word_counts():
    """The first R lanes pack identically whether or not more lanes (and
    more word planes) follow — the property that lets the scheduler pad a
    pack up to a word multiple without touching tenant chains."""
    x = RNG.choice([-1, 1], size=(100, 6)).astype(np.int8)
    w_all = pack_lanes(torch.from_numpy(x)).numpy()
    for R in (31, 32, 33, 64):
        w_r = pack_lanes(torch.from_numpy(x[:R])).numpy()
        np.testing.assert_array_equal(
            w_r, np.asarray(J.pack_lanes(jnp.asarray(x[:R]))))
        W = lane_words(R)
        full = (R // LANE_WIDTH)        # word planes with every lane live
        np.testing.assert_array_equal(w_r[:full], w_all[:full])
        if full < W:                    # tail word: live-lane bits only
            tail_mask = np.uint32((1 << (R - full * LANE_WIDTH)) - 1)
            np.testing.assert_array_equal(w_r[full],
                                          w_all[full] & tail_mask)


# -- lane permutation (lane_permute / lane_swap) ------------------------------

@pytest.mark.parametrize("L", [1, 2, 7, 31, 32, 33, 64, 100])
def test_lane_permute_matches_unpacked_gather(L):
    """lane_permute on word planes == the same permutation on unpacked
    lanes, including permutations that move lanes across word planes."""
    x = RNG.choice([-1, 1], size=(L, 5, 3)).astype(np.int8)
    perm = RNG.permutation(L)
    w = pack_lanes(torch.from_numpy(x))
    got = lane_permute(w, perm)
    same(got, J.lane_permute(J.pack_lanes(jnp.asarray(x)), perm))
    np.testing.assert_array_equal(unpack_lanes(got, L).numpy(), x[perm])


@pytest.mark.parametrize("L", [1, 6, 32, 65])
def test_lane_permute_inverse_round_trip(L):
    """Applying a permutation then its inverse restores every word plane
    (on the live lanes; lanes >= L are cleared by convention)."""
    x = RNG.choice([-1, 1], size=(L, 11)).astype(np.int8)
    w = pack_lanes(torch.from_numpy(x))
    perm = RNG.permutation(L)
    inv = np.argsort(perm)
    back = lane_permute(lane_permute(w, perm), inv)
    np.testing.assert_array_equal(back.numpy(), w.numpy())


def test_lane_permute_identity_clears_dead_lanes():
    """The identity permutation of L lanes zeroes bits >= L in the last
    word plane — the packed convention that keeps unused lanes inert."""
    full = np.full((1, 4), 0xFFFFFFFF, np.uint32)
    out = lane_permute(torch.from_numpy(full), np.arange(5))
    assert (out.numpy() == 0b11111).all()
    same(out, J.lane_permute(jnp.asarray(full), np.arange(5)))
    # multi-word: dead lanes live only in the LAST plane's tail
    full2 = np.full((2, 4), 0xFFFFFFFF, np.uint32)
    out2 = lane_permute(torch.from_numpy(full2), np.arange(40)).numpy()
    assert (out2[0] == 0xFFFFFFFF).all()
    assert (out2[1] == 0xFF).all()


def test_lane_permute_rejects_bad_width():
    cap = MAX_LANE_WORDS * LANE_WIDTH
    with pytest.raises(ValueError):
        lane_permute(torch.zeros((1, 3), dtype=torch.uint32),
                     np.arange(cap + 1))
    with pytest.raises(ValueError):
        lane_permute(torch.zeros((1, 3), dtype=torch.uint32), np.arange(0))


@pytest.mark.parametrize("L,i,j", [(16, 3, 12), (40, 3, 36), (64, 0, 63)])
def test_lane_swap_is_transposition(L, i, j):
    """lane_swap(i, j) == lane_permute with the (i j) transposition on the
    live lanes, and is an involution (swap twice = identity) — including
    transpositions across word planes."""
    x = RNG.choice([-1, 1], size=(L, 9)).astype(np.int8)
    w = pack_lanes(torch.from_numpy(x))
    perm = np.arange(L)
    perm[[i, j]] = perm[[j, i]]
    got = lane_swap(w, i, j)
    np.testing.assert_array_equal(got.numpy(), lane_permute(w, perm).numpy())
    same(got, J.lane_swap(J.pack_lanes(jnp.asarray(x)), i, j))
    np.testing.assert_array_equal(lane_swap(got, i, j).numpy(), w.numpy())


@pytest.mark.parametrize("L,i,j", [(8, 1, 5), (48, 1, 37)])
def test_lane_swap_accept_gated(L, i, j):
    """A False accept is a no-op; a per-site accept vector swaps exactly
    the accepted sites (the Metropolis gate of a packed exchange pass) —
    cross-word pairs included."""
    x = RNG.choice([-1, 1], size=(L, 10)).astype(np.int8)
    w = pack_lanes(torch.from_numpy(x))
    np.testing.assert_array_equal(
        lane_swap(w, i, j, accept=torch.tensor(False)).numpy(), w.numpy())
    accn = RNG.random(10) < 0.5
    got = lane_swap(w, i, j, accept=torch.from_numpy(accn))
    same(got, J.lane_swap(J.pack_lanes(jnp.asarray(x)), i, j,
                          accept=jnp.asarray(accn)))
    want = x.copy()
    want[i, accn], want[j, accn] = x[j, accn], x[i, accn]
    np.testing.assert_array_equal(unpack_lanes(got, L).numpy(), want)
