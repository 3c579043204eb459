"""Per-rank residency: over a process group each rank's engine holds only
its own share of the problem, as each device of the reference holds its
shard.

``LatticeDSIM`` on a mesh cuts the problem and the initial state where
they were built and moves only the bricks held here; ``DistDSIMEngine``
over a group moves only its partition's coupling and colour tables.  On
the CPU the engine's device is the host, so the check is structural:
every tensor reachable from the engine (:func:`held_tensors`) apart from
the caller's problem (``eng.p``, which stays where the caller built it)
and, on ``dsim_dist``, the whole index tables ROADMAP section C lists
(:data:`WHOLE_TABLES`) is of the rank's share.  Each rank is rank 17 of a
"fake" ``torch.distributed`` group of 256 (the dry run's 16 x 16 layout
of the padded L=100 instance, 112 x 112 x 100 sites) or a rank of a fake
group of 4 on a small partitioned graph; the fake group's collectives
return at once and carry nothing.  The gloo ranks of
``tests/test_torch_dist.py`` hold the same shares bitwise to the
one-process mesh's.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.annealing import ea_schedule
from repro_torch.core.lattice import build_ea3d_lattice
from repro_torch.core.lattice_dsim import LatticeDSIM
from repro_torch.core.mesh import make_mesh
from repro_torch.launch.dryrun import resident_problem_bytes

PAD, L = (112, 112), 100
WHOLE_SITES = 112 * 112 * 100                     # 1,254,400
BRICK_SITES = 7 * 7 * 100
# bytes a site of a brick holds per precision: masks (2 colours, int8),
# h and w6 (f32), active (int8); int8 adds h_q and w6_q (int8); bit-plane
# adds one uint32 masks_w word per colour, six sign and six nonzero words
# and the int32 base
SITE_BYTES = {"f32": 31, "int8": 38, "bitplane": 98}
# dsim_dist's whole tables: the ghosts' source slots and their gather
# index (on the host over a group), the global slot ids and the graph
WHOLE_TABLES = ("_ghost_src", "_ghost_idx", "_global_ids", "_graph")


def held_tensors(obj, path="eng", skip=("p",), seen=None):
    """Every (path, tensor) reachable from ``obj`` through attributes,
    dataclass fields, tuples, lists and dict values, into objects of the
    port's own classes only; the attributes named in ``skip`` are not
    followed."""
    seen = set() if seen is None else seen
    if id(obj) in seen:
        return
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        yield path, obj
    elif isinstance(obj, (tuple, list)):
        for i, x in enumerate(obj):
            yield from held_tensors(x, f"{path}[{i}]", skip, seen)
    elif isinstance(obj, dict):
        for k, x in obj.items():
            yield from held_tensors(x, f"{path}[{k!r}]", skip, seen)
    elif type(obj).__module__.startswith("repro_torch") and \
            hasattr(obj, "__dict__"):
        for k, x in vars(obj).items():
            if k not in skip:
                yield from held_tensors(x, f"{path}.{k}", skip, seen)


def whole_in_trailing(shape, n: int) -> bool:
    """Whether the trailing dims of ``shape`` hold ``n`` sites: the
    product of some suffix of it is n."""
    acc = 1
    for e in reversed(tuple(int(x) for x in shape)):
        acc *= e
        if acc == n:
            return True
    return False


@pytest.fixture(scope="module")
def padded():
    """The dry run's instance, built on the host."""
    return build_ea3d_lattice(L, seed=0, pad_xy=PAD, device="cpu")


@pytest.fixture
def fake_group():
    """This process as one rank of a "fake" group (the dry run's)."""
    import torch.distributed as dist
    from repro_torch.launch.dryrun import _fake_group

    def start(world, rank):
        _fake_group(world, rank)
        return dist.group.WORLD
    yield start
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("precision", ["f32", "int8", "bitplane"])
def test_lattice_rank_holds_only_its_brick(padded, fake_group, precision):
    """Rank 17 of the 16 x 16 layout: no tensor of the engine or of its
    state has the whole padded lattice's 1,254,400 sites in its trailing
    dims, its bricks are the one 7 x 7 x 100 brick with each constant
    equal to the problem's block there, and one chunk runs."""
    group = fake_group(256, 17)
    mesh = make_mesh((16, 16), ("data", "model"), group=group)
    eng = LatticeDSIM(padded, mesh=mesh, dim_axes=("data", "model", None),
                      precision=precision, device="cpu")
    st = eng.init_state(seed=0)
    st, rec = eng.run_recorded(st, ea_schedule(4), [4], sync_every=4)
    assert eng.p is padded            # the caller's, where it was built
    assert eng.coords == [(1, 1, 0)] and eng.brick == (7, 7, 100)
    assert len(eng._bricks) == 1
    held = list(held_tensors(eng)) + list(held_tensors(st, "state"))
    wide = [p for p, t in held if whole_in_trailing(t.shape, WHOLE_SITES)]
    assert not wide, wide
    assert resident_problem_bytes(eng) == \
        BRICK_SITES * SITE_BYTES[precision]
    b = eng._bricks[0]
    block = (slice(7, 14), slice(7, 14), slice(None))
    np.testing.assert_array_equal(b.h.numpy(), padded.h[block].numpy())
    np.testing.assert_array_equal(b.masks.numpy(),
                                  padded.masks[(slice(None),) + block])
    for w, pw in zip(b.w6, padded.w6):
        np.testing.assert_array_equal(w.numpy(), pw[block].numpy())
    if precision != "f32":
        # the whole problem's quantization, cut: the same scale on every
        # rank, and the brick's block of the host arrays
        assert eng.q_scale == 1.0 and eng.f_max == 6
        for w, hw in zip(b.w6_q, eng.w6_q):
            assert isinstance(hw, np.ndarray)
            np.testing.assert_array_equal(w.numpy(), hw[block])
    assert rec.flips > 0
    # the walk sees the whole lattice where it is: in the caller's problem
    assert any(whole_in_trailing(t.shape, WHOLE_SITES)
               for _, t in held_tensors(eng, skip=()))


def test_lattice_without_a_mesh_is_its_one_brick(padded):
    """With no mesh the brick is the problem: the engine's problem, its
    brick's constants and its fixed-point attributes are one set of
    tensors on its device."""
    eng = LatticeDSIM(padded, precision="int8", device="cpu")
    b = eng._bricks[0]
    assert b.h is eng.p.h and b.masks is eng.p.masks
    assert b.h_q is eng.h_q and all(
        x is y for x, y in zip(b.w6_q, eng.w6_q))
    assert isinstance(eng.h_q, torch.Tensor)


def dist_problem(kind, K):
    """A random regular graph cut by the greedy partitioner, or an L=6
    EA3D lattice cut into K slabs (at K=4 of 2, 1, 2 and 1 planes): both
    pad colour slot lists."""
    from repro_torch.core import graph
    from repro_torch.core.coloring import greedy_coloring, lattice3d_coloring
    from repro_torch.core.dsim import build_partitioned
    from repro_torch.core.partition import greedy_partition, slab_partition
    if kind == "regular":
        g = graph.random_regular(48, 4, seed=3, device="cpu")
        col = greedy_coloring(g.idx, g.w)
        labels = greedy_partition(g.idx, g.w, K, seed=0)
    else:
        g, col = graph.ea3d(6, seed=1, device="cpu"), lattice3d_coloring(6)
        labels = slab_partition(6, K)
    return build_partitioned(g, col, labels, K)


def same(a, b) -> bool:
    """Bitwise equality (uint32 through its int32 view)."""
    i32 = lambda t: t.view(torch.int32) if t.dtype == torch.uint32 \
        else t  # noqa: E731
    return a.shape == b.shape and torch.equal(i32(a), i32(b))


def partition_tensors(eng):
    """(path, tensor) of everything a ``DistDSIMEngine`` holds but the
    caller's problem, its LUTs and the whole tables."""
    return [(p, t) for p, t in held_tensors(
        eng, skip=("p", "_lut_cache") + WHOLE_TABLES)]


@pytest.mark.parametrize("precision,kind", [("f32", "regular"),
                                            ("int8", "regular"),
                                            ("bitplane", "ea3d")])
def test_dsim_dist_rank_holds_only_its_partition(fake_group, precision,
                                                 kind):
    """Rank 1 of a fake group of 4: every constant it holds is one
    partition's (leading extent 1) and equals the one-process engine's
    row 1; its state is partition 1's."""
    from repro_torch.core.dsim_dist import DistDSIMEngine
    prob = dist_problem(kind, 4)
    kw = dict(rng="lfsr", precision=precision, replicas=3, device="cpu")
    one = DistDSIMEngine(prob, **kw)
    group = fake_group(4, 1)
    eng = DistDSIMEngine(prob, mesh=make_mesh((4,), ("data",), group=group),
                         **kw)
    assert eng.p is prob and eng._held == slice(1, 2)
    mine = partition_tensors(eng)
    assert mine and all(t.dim() and t.shape[0] == 1 for _, t in mine), \
        [(p, tuple(t.shape)) for p, t in mine]
    ref = dict(partition_tensors(one))
    for path, t in mine:
        want = ref[path]
        assert t.dtype == want.dtype, path
        assert same(t, want[1:2] if want.shape[0] == 4 else want), path
    st = eng.init_state(seed=2)
    st1 = one.init_state(seed=2)
    for f in ("m", "ghosts", "macc", "rng"):
        assert same(getattr(st, f), getattr(st1, f)[1:2]), f
    # the same rows a whole engine holds K of
    assert any(t.shape[0] == 4 for _, t in partition_tensors(one))
    if precision != "f32":
        assert eng.q_scale == one.q_scale and eng.f_max == one.f_max
