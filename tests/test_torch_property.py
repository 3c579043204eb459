"""Property-based tests (hypothesis) on the port's sampler invariants.

The port of the sampler cases of ``tests/test_property.py`` on the CPU:
gauge and global-flip invariance of the energy, the 1-bit packing round
trip, chunk planning, the fixed-point grid and greedy colouring.  Each
example also runs the reference's function on the same numpy inputs and
holds the port to it.  The ``q8_*`` case tests the optimizer's int8
moments (``repro_torch.train.optimizer``), its codes and scales bitwise to
the reference's.  The HLO-parser case's counterpart is in
``tests/test_torch_roofline.py``: the port's roofline reads recorded
calls, not HLO text.
"""

import jax.numpy as jnp
import numpy as np
import torch
from hypothesis import HealthCheck, given, settings, strategies as st

from repro.core import coloring as jcol, energy as jen, graph as jgraph
from repro.core import packing as jpack, pbit as jpbit
from repro.engines.base import chunk_plan as j_chunk_plan
from repro_torch.core.coloring import greedy_coloring, validate_coloring
from repro_torch.core.energy import energy
from repro_torch.core.gibbs import chunk_plan
from repro_torch.core.graph import from_edges, random_regular
from repro_torch.core.packing import pack_pm1, unpack_pm1
from repro_torch.core.pbit import FixedPoint, quantize
from repro_torch.train.optimizer import q8_decode, q8_encode

SET = dict(deadline=None, max_examples=20,
           suppress_health_check=[HealthCheck.too_slow])
CPU = dict(device="cpu")


def _to_edges(idx, w, n):
    src = np.repeat(np.arange(n), idx.shape[1])
    dst = idx.ravel()
    wt = w.ravel()
    mask = (wt != 0) & (src < dst)
    return n, src[mask], dst[mask], wt[mask].astype(np.float32)


@given(st.integers(2, 40), st.integers(0, 10 ** 6))
@settings(**SET)
def test_energy_gauge_invariance(n, seed):
    """E is invariant under J_ij -> J_ij s_i s_j, m -> m*s (gauge symmetry)."""
    rng = np.random.default_rng(seed)
    d = 3 if (n * 3) % 2 == 0 else 4
    try:
        g = random_regular(max(n, d + 1), d, seed=seed, **CPU)
    except (RuntimeError, ValueError):
        return
    m = rng.choice([-1, 1], g.n).astype(np.int8)
    s = rng.choice([-1, 1], g.n).astype(np.int8)
    idx = g.idx.numpy()
    w = g.w.numpy() * s[:, None] * s[idx]
    g2 = from_edges(*_to_edges(idx, w, g.n), **CPU)
    e1 = float(energy(g, torch.from_numpy(m)))
    e2 = float(energy(g2, torch.from_numpy((m * s).astype(np.int8))))
    assert abs(e1 - e2) < 1e-3
    jg = jgraph.random_regular(max(n, d + 1), d, seed=seed)
    assert e1 == float(jen.energy(jg, jnp.asarray(m)))


@given(st.integers(0, 10 ** 6))
@settings(**SET)
def test_energy_global_flip_invariance(seed):
    g = random_regular(20, 3, seed=seed % 100, **CPU)
    m = np.random.default_rng(seed).choice([-1, 1], g.n).astype(np.int8)
    e1 = float(energy(g, torch.from_numpy(m)))
    e2 = float(energy(g, torch.from_numpy((-m).astype(np.int8))))
    assert abs(e1 - e2) < 1e-3   # h = 0: Z2 symmetry
    jg = jgraph.random_regular(20, 3, seed=seed % 100)
    assert e1 == float(jen.energy(jg, jnp.asarray(m)))


@given(st.integers(1, 64), st.integers(1, 8), st.integers(0, 10 ** 6))
@settings(**SET)
def test_pack_unpack_roundtrip(words, rows, seed):
    n = words * 8
    x = np.random.default_rng(seed).choice([-1, 1], (rows, n)).astype(np.int8)
    p = pack_pm1(torch.from_numpy(x))
    assert (unpack_pm1(p, n).numpy() == x).all()
    np.testing.assert_array_equal(p.numpy(),
                                  np.asarray(jpack.pack_pm1(jnp.asarray(x))))


@given(st.lists(st.integers(1, 5000), min_size=1, max_size=12))
@settings(**SET)
def test_chunk_plan_hits_every_point(raw):
    pts = sorted(set(raw))
    plan = chunk_plan(pts)
    assert plan == j_chunk_plan(pts)
    acc, hits = 0, set()
    for c in plan:
        assert c & (c - 1) == 0
        acc += c
        hits.add(acc)
    assert set(pts) <= hits
    assert acc == pts[-1]


@given(st.integers(1, 6), st.integers(0, 6),
       st.floats(-100, 100, allow_nan=False))
@settings(**SET)
def test_fixedpoint_properties(ib, fb, x):
    fmt = FixedPoint(ib, fb)
    xt = torch.tensor(x, dtype=torch.float32)
    q = float(quantize(xt, fmt))
    assert q == float(jpbit.quantize(jnp.asarray(x, jnp.float32),
                                     jpbit.FixedPoint(ib, fb)))
    assert fmt.lo <= q <= fmt.hi
    # idempotent & on-grid
    assert abs(float(quantize(torch.tensor(q), fmt)) - q) < 1e-9
    assert abs(q / fmt.step - round(q / fmt.step)) < 1e-6
    # within half a step when in range (x as the f32 it is quantized as)
    if fmt.lo <= float(xt) <= fmt.hi:
        assert abs(q - float(xt)) <= fmt.step / 2 + 1e-9


@given(st.integers(2, 30), st.integers(3, 6), st.integers(0, 10 ** 5))
@settings(**SET)
def test_greedy_coloring_always_valid(n, d, seed):
    if (n * d) % 2 != 0 or n <= d:
        return
    try:
        g = random_regular(n, d, seed=seed, **CPU)
    except (RuntimeError, ValueError):
        return
    col = greedy_coloring(g.idx, g.w)
    assert validate_coloring(g.idx, g.w, col.colors)
    assert col.n_colors <= d + 1
    jg = jgraph.random_regular(n, d, seed=seed)
    np.testing.assert_array_equal(
        col.colors, jcol.greedy_coloring(np.asarray(jg.idx),
                                         np.asarray(jg.w)).colors)


@given(st.integers(1, 400), st.integers(0, 10 ** 6))
@settings(**SET)
def test_q8_error_bound(n, seed):
    from repro.train.optimizer import q8_decode as j_decode
    from repro.train.optimizer import q8_encode as j_encode
    x = np.random.default_rng(seed).normal(0, 3, n).astype(np.float32)
    q, s = q8_encode(torch.from_numpy(x))
    y = q8_decode(q, s, (n,)).numpy()
    # blockwise absmax: per-block error <= blockmax/127 (+eps)
    pad = (-n) % 128
    xp = np.pad(x, (0, pad)).reshape(-1, 128)
    bm = np.abs(xp).max(axis=1)
    err = np.abs(np.pad(x, (0, pad)).reshape(-1, 128) -
                 np.pad(y, (0, pad)).reshape(-1, 128))
    assert (err <= bm[:, None] / 127.0 + 1e-5).all()
    jq, js = j_encode(jnp.asarray(x))
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(s.numpy(), np.asarray(js))
    assert np.array_equal(y, np.asarray(j_decode(jq, js, (n,))))
