"""The port's public names against the reference's.

A caller of ``repro`` should run unchanged with ``repro_torch`` in its
place.  For every reference module that has a counterpart in the port,
each name in the reference's ``__all__`` must exist there.  The reference
is read with ``ast``, so this file needs no JAX for those checks; the
behaviour checks at the end compare the aliases with the reference on the
CPU.
"""

import ast
import importlib
import os

import numpy as np
import pytest

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
REF = os.path.join(SRC, "repro")
PORT = os.path.join(SRC, "repro_torch")

# reference names the port leaves out on purpose, with the reason
WAIVED = {
    ("kernels/ops.py", "default_impl"):
        "the port picks the implementation from each tensor's device "
        "(ops.resolve_impl), not from a process-wide backend",
    ("core/lattice_dsim.py", "fused_working_set_bytes"):
        "the 16 MiB VMEM model is a TPU fact (ROADMAP, deliberate "
        "differences: kernel_path)",
    ("core/lattice_dsim.py", "fused_brick_ceiling"):
        "the 16 MiB VMEM model is a TPU fact (ROADMAP, deliberate "
        "differences: kernel_path)",
}

# reference modules with no port counterpart, with the reason
NO_COUNTERPART = {
    "compat.py": "jax-version shim",
    "analyze/jaxpr_utils.py": "replaced by analyze/ops_trace.py",
}


def _ref_modules():
    out = []
    for root, _, files in os.walk(REF):
        for f in sorted(files):
            if f.endswith(".py"):
                out.append(os.path.relpath(os.path.join(root, f), REF)
                           .replace(os.sep, "/"))
    return sorted(out)


def _ref_all(rel):
    tree = ast.parse(open(os.path.join(REF, rel)).read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return list(ast.literal_eval(node.value))
    return None


def _port_module(rel):
    name = "repro_torch." + rel[:-3].replace("/", ".")
    if name.endswith(".__init__"):
        name = name[:-len(".__init__")]
    return importlib.import_module(name)


REF_MODULES = _ref_modules()
PORTED = [r for r in REF_MODULES
          if os.path.exists(os.path.join(PORT, r)) and _ref_all(r)]


def test_every_reference_module_has_a_counterpart_or_a_reason():
    missing = [r for r in REF_MODULES
               if not os.path.exists(os.path.join(PORT, r))
               and r not in NO_COUNTERPART]
    assert missing == []
    # a waiver for a module that has since been ported is stale
    assert all(not os.path.exists(os.path.join(PORT, r))
               for r in NO_COUNTERPART)


@pytest.mark.parametrize("rel", PORTED)
def test_port_exports_the_reference_names(rel):
    mod = _port_module(rel)
    missing = [n for n in _ref_all(rel)
               if not hasattr(mod, n) and (rel, n) not in WAIVED]
    assert missing == [], f"{rel}: {missing}"


def _ref_classes(rel):
    tree = ast.parse(open(os.path.join(REF, rel)).read())
    return {n.name: sorted(m.name for m in n.body
                           if isinstance(m, ast.FunctionDef)
                           and not m.name.startswith("_"))
            for n in tree.body if isinstance(n, ast.ClassDef)}


CLASSES = [(r, c) for r in REF_MODULES
           if os.path.exists(os.path.join(PORT, r))
           for c in _ref_classes(r)]


@pytest.mark.parametrize("rel,cls", CLASSES,
                         ids=[f"{r}::{c}" for r, c in CLASSES])
def test_port_classes_have_the_reference_methods(rel, cls):
    port_cls = getattr(_port_module(rel), cls, None)
    assert port_cls is not None, f"{rel}: no class {cls}"
    missing = [m for m in _ref_classes(rel)[cls]
               if not hasattr(port_cls, m)]
    assert missing == [], f"{rel}::{cls}: {missing}"


def test_waivers_are_live():
    for rel, name in WAIVED:
        assert name in _ref_all(rel), (rel, name)
        assert not hasattr(_port_module(rel), name), (rel, name)


def test_engines_package_all_matches_reference():
    import repro_torch.engines as E
    ref = _ref_all("engines/__init__.py")
    assert set(ref) <= set(E.__all__)
    assert set(E.__all__) - set(ref) == {"HandleCursor"}
    from repro_torch.engines import (Engine, RecordedCursor, RunRecord,  # noqa: F401
                                     chunk_plan, run_recorded_driver,
                                     spawn_seeds, stack_states)
    from repro_torch.engines import base
    assert E.chunk_plan is base.chunk_plan
    assert E.run_recorded_driver is base.run_recorded_driver


def test_gibbs_reexports_chunk_plan():
    from repro_torch.core.gibbs import chunk_plan
    from repro_torch.engines.base import chunk_plan as base_plan
    import repro_torch.core.gibbs as G
    assert chunk_plan is base_plan and "chunk_plan" in G.__all__


@pytest.mark.parametrize("n", [1, 31, 32, 33, 64, 100, 256])
def test_lane_words_is_packing_lane_words(n):
    from repro.engines.base import lane_words as ref_lane_words
    from repro_torch.core.packing import lane_words
    from repro_torch.engines.base import lane_words as base_lane_words
    assert base_lane_words is lane_words
    assert base_lane_words(n) == ref_lane_words(n)


@pytest.mark.parametrize("replicas", [1, 3])
def test_gibbs_direct_energy_matches_reference(replicas):
    import torch
    from repro.core.coloring import lattice3d_coloring as rcol
    from repro.core.gibbs import GibbsEngine as RGibbs
    from repro.core.graph import ea3d as rea3d
    from repro_torch.core.coloring import lattice3d_coloring
    from repro_torch.core.gibbs import GibbsEngine
    from repro_torch.core.graph import ea3d

    L = 4
    eng = GibbsEngine(ea3d(L, seed=5, device="cpu"), lattice3d_coloring(L),
                      rng="lfsr", device="cpu")
    ref = RGibbs(rea3d(L, seed=5), rcol(L), rng="lfsr")
    assert GibbsEngine.direct_energy is GibbsEngine.energy
    m0 = np.random.default_rng(0).choice(
        np.array([-1, 1], np.int8), size=(replicas, L ** 3))
    if replicas == 1:
        st = eng.init_state(seed=0, m0=m0[0])
        rs = ref.init_state(seed=0, m0=m0[0])
    else:
        from repro.engines import stack_states as rstack
        from repro_torch.engines import stack_states
        st = stack_states([eng.init_state(seed=r, m0=m0[r])
                           for r in range(replicas)])
        rs = rstack([ref.init_state(seed=r, m0=m0[r])
                     for r in range(replicas)])
    got = eng.direct_energy(st)
    assert isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(ref.direct_energy(rs)))


@pytest.mark.parametrize("total", [1, 7, 100, 2048])
def test_schedule_beta_at_matches_reference(total):
    import torch
    from repro.core.annealing import ea_schedule as rea, sat_schedule as rsat
    from repro_torch.core.annealing import ea_schedule, sat_schedule
    sweeps = np.arange(total, dtype=np.int32)
    for mk, rmk in ((ea_schedule, rea), (sat_schedule, rsat)):
        got = mk(total).beta_at(torch.as_tensor(sweeps))
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        want = np.asarray(rmk(total).beta_at(sweeps))
        np.testing.assert_array_equal(got.numpy(), want)
        # a plain int gives a 0-d tensor, the same value
        assert float(mk(total).beta_at(total - 1)) == float(want[-1])
        np.testing.assert_array_equal(got.numpy(),
                                      mk(total).beta_array())


def test_schedule_rescale_matches_reference():
    from repro.core.annealing import ea_schedule as rea
    from repro_torch.core.annealing import ea_schedule
    np.testing.assert_array_equal(ea_schedule(64).rescale(100).beta_array(),
                                  rea(64).rescale(100).beta_array())


def test_lfsr_init_is_the_host_seed_expansion():
    """A deliberate difference (ROADMAP): the port returns the host
    numpy array; the reference wraps the same values in a jax array."""
    from repro.core.pbit import lfsr_init as ref_lfsr_init
    from repro_torch.core.pbit import lfsr_init
    got = lfsr_init(257, seed=11)
    assert isinstance(got, np.ndarray) and got.dtype == np.uint32
    np.testing.assert_array_equal(got, np.asarray(ref_lfsr_init(257, 11)))
