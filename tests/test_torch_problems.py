"""The port's problem suite: EA grounds, Max-Cut, the 3SAT encoding,
planting, and the multi-word packed APT ladder.

The port of ``tests/test_problems.py``, case by case, on the CPU, for the
cases ``tests/test_torch_apt_icm.py`` does not already mirror (it holds
``apt_icm_invariants``, ``apt_packed_guards``,
``apt_packed_bitwise_matches_unpacked_lfsr``,
``apt_packed_t64_ladder_end_to_end``,
``apt_packed_incremental_energy_exact``,
``apt_accept_rows_narrow_and_wide_agree_with_gather``,
``apt_icm_move_invariants`` and
``apt_beats_plain_annealing_on_hard_instance``).  Where the reference
case compares numbers, the port's are held to the reference's on the same
inputs: instances, encodings, cuts, energies and hex strings exactly; the
packed multi-word ladder bitwise to the reference's run with the same
uniforms (``HostDraws``, as ``tests/test_torch_apt_icm.py`` feeds them).
The annealing runs use ``rng="philox"``, as the reference's do, which
PyTorch cannot reproduce: those hold the port to the reference's own
thresholds.
"""

import json

import numpy as np
import torch

from repro.core import energy as j_en
from repro.core import graph as j_graph
from repro.core.apt_icm import APTICM as JAPT
from repro.problems import ea3d as j_ea
from repro.problems import maxcut as j_mc
from repro.problems import sat as j_sat
from repro_torch.core.annealing import Schedule, sat_schedule
from repro_torch.core.apt_icm import APTICM, HostDraws
from repro_torch.core.coloring import greedy_coloring, lattice3d_coloring
from repro_torch.core.energy import energy
from repro_torch.core.gibbs import GibbsEngine
from repro_torch.core.graph import ea3d
from repro_torch.interop import state_to_numpy
from repro_torch.problems.ea3d import (GroundStore, establish_grounds,
                                       instance_set)
from repro_torch.problems.maxcut import (cut_of, gset_like_toroidal,
                                         hex_to_spins, maxcut_to_ising,
                                         parse_gset, spins_to_hex)
from repro_torch.problems.planting import plant_frustrated_loops
from repro_torch.problems.sat import (count_satisfied, decode_assignment,
                                      encode_3sat, random_3sat)
from test_torch_apt_icm import DRAW_SEED, ref_fields, ref_state, run_ref

CPU = dict(device="cpu")


def same_graph(tg, jg):
    for f in ("idx", "w", "h"):
        np.testing.assert_array_equal(getattr(tg, f).numpy(),
                                      np.asarray(getattr(jg, f)))


def test_instance_set_protocol():
    graphs = instance_set(4, n_instances=3, **CPU)
    assert len(graphs) == 3
    seeds = [g.meta["seed"] for g in graphs]
    assert len(set(seeds)) == 3
    ref = j_ea.instance_set(4, n_instances=3)
    assert seeds == [g.meta["seed"] for g in ref]
    for tg, jg in zip(graphs, ref):
        same_graph(tg, jg)


def test_ground_store(tmp_path):
    store = GroundStore(str(tmp_path / "g.json"))
    ref = j_ea.GroundStore(str(tmp_path / "j.json"))
    assert store.get(5, 1) is None and ref.get(5, 1) is None
    for e, want in ((-100.0, -100.0), (-90.0, -100.0), (-120.0, -120.0)):
        assert store.update(5, 1, e) == ref.update(5, 1, e) == want
    store2 = GroundStore(str(tmp_path / "g.json"))
    assert store2.get(5, 1) == -120.0
    # the same file as the reference's store writes
    assert json.loads((tmp_path / "g.json").read_text()) == \
        json.loads((tmp_path / "j.json").read_text())


def test_establish_grounds(tmp_path):
    graphs = instance_set(4, n_instances=2, **CPU)
    store = GroundStore(str(tmp_path / "g.json"))
    grounds = establish_grounds(graphs, store, sweeps=200, runs=1, **CPU)
    assert len(grounds) == 2
    assert all(g < 0 for g in grounds)
    # each is stored, and no lower than the instance's energy floor (-3
    # per spin on +-J with degree 6)
    assert [store.get(4, g.meta["seed"]) for g in graphs] == grounds
    assert all(g >= -3 * 4 ** 3 for g in grounds)


def test_gset_parser():
    text = "3 2\n1 2 1\n2 3 -1\n"
    g = parse_gset(text, **CPU)
    assert g.n == 3 and g.num_edges == 2
    m = torch.tensor([1, -1, -1], dtype=torch.int8)
    assert cut_of(g, m) == 1.0  # edge (1,2) cut w=+1; (2,3) uncut
    jg = j_mc.parse_gset(text)
    same_graph(g, jg)
    assert j_mc.cut_of(jg, m.numpy()) == 1.0


def test_maxcut_mapping_consistency():
    g = gset_like_toroidal(6, 8, seed=0, **CPU)
    gi = maxcut_to_ising(g)
    jg = j_mc.gset_like_toroidal(6, 8, seed=0)
    jgi = j_mc.maxcut_to_ising(jg)
    same_graph(gi, jgi)
    rng = np.random.default_rng(0)
    W = float(g.w.numpy().sum()) / 2
    for _ in range(4):
        m = rng.choice([-1, 1], g.n).astype(np.int8)
        # with J = -w:  E_ising = -sum J m m = +sum w m m, so
        # cut = (W_tot - sum w m m) / 2 = (W_tot - E_ising) / 2
        cut = cut_of(g, torch.from_numpy(m))
        E = float(energy(gi, torch.from_numpy(m)))
        assert abs(cut - (W - E) / 2) < 1e-3
        assert cut == j_mc.cut_of(jg, m)
        assert E == float(j_en.energy(jgi, m))


def test_hex_roundtrip():
    rng = np.random.default_rng(1)
    m = rng.choice([-1, 1], 101).astype(np.int8)
    assert (hex_to_spins(spins_to_hex(m), 101) == m).all()
    assert spins_to_hex(m) == j_mc.spins_to_hex(m)


def test_sat_encoding_ground_states():
    """Satisfying assignments of the formula must be ground states of the
    Ising encoding (gate Hamiltonian correctness); every energy of the
    brute force equals the reference's on its own encoding."""
    clauses = np.array([[1, 2, 3], [-1, 2, -3], [1, -2, 3]])
    enc = encode_3sat(clauses, 3, max_fanout=10, **CPU)
    jenc = j_sat.encode_3sat(clauses, 3, max_fanout=10)
    g = enc.graph
    same_graph(g, jenc.graph)
    assert enc.n_aux == jenc.n_aux

    def configs(assign):
        """Every full configuration of a variable assignment: the
        auxiliary spins brute-forced."""
        n_aux = enc.n_aux
        out = np.ones((2 ** n_aux, g.n), dtype=np.int8)
        for v in range(3):
            out[:, enc.copies_of[v]] = assign[v]
        for a in range(n_aux):
            out[:, g.n - n_aux + a] = np.where(
                (np.arange(2 ** n_aux) >> a) & 1, 1, -1)
        return out

    energies = {}
    for bits in range(8):
        assign = np.asarray([(bits >> i) & 1 for i in range(3)]) * 2 - 1
        nsat = count_satisfied(clauses, assign)
        assert nsat == j_sat.count_satisfied(clauses, assign)
        full = configs(assign)
        e = energy(g, torch.from_numpy(full)).numpy()
        np.testing.assert_array_equal(
            e, [float(j_en.energy(jenc.graph, x)) for x in full])
        energies.setdefault(nsat, []).append(float(e.min()))
    # all-satisfying assignments reach the global minimum
    emin = min(min(v) for v in energies.values())
    assert min(energies[3]) == emin
    assert min(energies[2]) > emin - 1e-6


def test_sat_pipeline_end_to_end():
    clauses = random_3sat(25, 100, seed=3)
    np.testing.assert_array_equal(clauses, j_sat.random_3sat(25, 100,
                                                             seed=3))
    enc = encode_3sat(clauses, 25, **CPU)
    same_graph(enc.graph, j_sat.encode_3sat(clauses, 25).graph)
    col = greedy_coloring(enc.graph.idx, enc.graph.w)
    eng = GibbsEngine(enc.graph, col, **CPU)
    st = eng.init_state(seed=0)
    st, _ = eng.run_dense(st, sat_schedule(2500).beta_array())
    assign = decode_assignment(enc, st.m)
    np.testing.assert_array_equal(
        assign, j_sat.decode_assignment(enc, st.m.numpy()))
    assert count_satisfied(clauses, assign) >= 95  # >= 95% on easy-ish alpha=4


def test_copy_chain_fanout():
    clauses = random_3sat(10, 80, seed=0)
    enc = encode_3sat(clauses, 10, max_fanout=4, **CPU)
    jenc = j_sat.encode_3sat(clauses, 10, max_fanout=4)
    # high-occupancy variables got split
    occ = np.zeros(10)
    for c in clauses:
        for lit in c:
            occ[abs(lit) - 1] += 1
    for v in range(10):
        assert len(enc.copies_of[v]) == max(1, int(np.ceil(occ[v] / 4)))
        np.testing.assert_array_equal(enc.copies_of[v], jenc.copies_of[v])


def test_planted_instance():
    from repro.problems.planting import plant_frustrated_loops as j_plant
    host = ea3d(5, seed=2, **CPU)
    inst = plant_frustrated_loops(host, n_loops=40, seed=1)
    jinst = j_plant(j_graph.ea3d(5, seed=2), n_loops=40, seed=1)
    same_graph(inst.graph, jinst.graph)
    np.testing.assert_array_equal(inst.ground_state, jinst.ground_state)
    assert inst.ground_energy == jinst.ground_energy
    E_check = float(energy(inst.graph, torch.from_numpy(inst.ground_state)))
    assert abs(E_check - inst.ground_energy) < 1e-4
    # annealing reaches the planted ground energy (paper S11 protocol)
    col = greedy_coloring(inst.graph.idx, inst.graph.w)
    eng = GibbsEngine(inst.graph, col, **CPU)
    st = eng.init_state(seed=0)
    st, (Etr, _) = eng.run_dense(
        st, Schedule(np.arange(0.5, 5.01, 0.5), 1500).beta_array())
    assert float(Etr.min()) <= inst.ground_energy + 1e-4


def test_apt_packed_multiword_bitwise_matches_unpacked_lfsr(monkeypatch):
    """The multi-word ladder (4 chains x 10 temperatures = 40 lanes across
    W=2 word planes) stays bit-identical to the unpacked fixed-point run,
    and to the reference's packed run with the same uniforms: spins,
    energies, LFSR states, swap and ICM counters, the best-energy
    trace."""
    g, col = ea3d(4, seed=1, **CPU), lattice3d_coloring(4)
    betas = np.linspace(0.4, 2.8, 10)
    kw = dict(chains=4, rng="lfsr", draws=HostDraws(DRAW_SEED), **CPU)
    un = APTICM(g, col, betas, **kw)
    pk = APTICM(g, col, betas, packed=True, **dict(
        kw, draws=HostDraws(DRAW_SEED)))
    assert pk.words == 2
    su, sp = un.init_state(seed=2), pk.init_state(seed=2)
    assert torch.equal(un.spins(su), pk.spins(sp))
    je = JAPT(j_graph.ea3d(4, seed=1), col, betas, chains=4, rng="lfsr",
              packed=True)
    js, (_, jb) = run_ref(je, ref_state(state_to_numpy(sp)), monkeypatch,
                          12, 4, 4)
    su, (_, bu) = un.run(su, 12, icm_every=4, record_every=4)
    sp, (_, bp) = pk.run(sp, 12, icm_every=4, record_every=4)
    np.testing.assert_array_equal(bu, bp)
    np.testing.assert_array_equal(bp, jb)
    assert torch.equal(un.spins(su), pk.spins(sp))
    np.testing.assert_array_equal(pk.spins(sp).numpy(),
                                  np.asarray(je.spins(js)))
    assert torch.equal(su.E, sp.E)
    got, want = state_to_numpy(sp), ref_fields(js)
    for f in ("m", "E", "lfsr", "swaps", "icms"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    assert int(su.swaps) == int(sp.swaps) > 0
    assert int(su.icms) == int(sp.icms) > 0


def test_instance_energies_match_the_reference():
    """Every instance of the set: the port's energy of random states
    equals the reference's."""
    rng = np.random.default_rng(3)
    for tg, jg in zip(instance_set(4, n_instances=2, **CPU),
                      j_ea.instance_set(4, n_instances=2)):
        m = rng.choice([-1, 1], (3, tg.n)).astype(np.int8)
        e = energy(tg, torch.from_numpy(m)).numpy()
        np.testing.assert_array_equal(
            e, [float(j_en.energy(jg, x)) for x in m])
