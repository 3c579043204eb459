"""Multi-pod dry run of the port: one rank's sampling chunk of the paper's
1M-p-bit workload at the production brick layout, recorded and held
against an H100 roofline; port of ``repro.launch.dryrun``.

The reference lowers and compiles the chunk for 256 or 512 placeholder
devices and reads its memory and costs from XLA.  Eager PyTorch has no
program to lower, so this process becomes one rank of a
``torch.distributed`` "fake" process group of the production mesh's size
(every collective returns at once and writes nothing), builds the engine
at that rank's brick, runs one warm chunk and records the next
(``LatticeDSIM.trace_chunk``): its aten ops, collectives and hand-kernel
launches, costed by ``launch/roofline.py``.  The chunk's numbers are work
and bytes, not a trajectory: no halo arrives.

The reference's program is the same on every chip; the port's depends on
where its rank sits (an edge rank of an open x or y chain sends fewer
faces), so the record is of a rank with every neighbour (``--rank``
picks another).  The instance is built on the host and the engine moves
only the rank's brick to its device, as the reference places each chip's
shard: the record states the bytes of the problem constants the rank
holds there (``resident_problem_bytes``, its brick's) beside the peak the
chunk allocates.

MUST be run as its own process: it initialises the default process group
(once per cell, torn down after it).  It runs on the CUDA device unless
``--device cpu`` is given, and raises when there is none.

Usage:
  python -m repro_torch.launch.dryrun --all [--device cpu]
  python -m repro_torch.launch.dryrun --arch ea3d-1m --multi-pod
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import numpy as np
import torch

from repro_torch.configs import get_config, list_configs
from repro_torch.configs.base import ShapeCell
from repro_torch.core.device import resolve_device
from repro_torch.launch.mesh import make_mesh_shape
from repro_torch.launch.roofline import HW, roofline

__all__ = ["lower_ising_cell", "run_cell", "all_cells", "main", "REPORT_DIR",
           "interior_rank", "resident_problem_bytes"]

REPORT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                          "reports", "dryrun_torch")


def interior_rank(multi_pod: bool) -> int:
    """The rank at coordinate 1 of the data and model axes (0 of pod): x
    and y neighbours on both sides (z is a ring)."""
    shape, axes = make_mesh_shape(multi_pod)
    at = {"pod": 0, "data": 1, "model": 1}
    return int(np.ravel_multi_index([at[a] for a in axes], shape))


def _fake_group(world: int, rank: int):
    """Make this process rank ``rank`` of a "fake" group of ``world``."""
    import torch.distributed as dist
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            "the dry run runs as one rank of torch.distributed's 'fake' "
            "process group (torch.testing._internal.distributed.fake_pg), "
            f"which this torch {torch.__version__} lacks") from e
    dist.init_process_group("fake", rank=rank, world_size=world,
                            store=FakeStore())


def _nbytes(*ts) -> int:
    out = 0
    for t in ts:
        if isinstance(t, (tuple, list)):
            out += _nbytes(*t)
        elif isinstance(t, torch.Tensor):
            out += int(t.numel()) * int(t.element_size())
    return out


def resident_problem_bytes(eng) -> int:
    """Bytes of the problem constants a ``LatticeDSIM`` holds on its
    device: every field of the bricks it holds (at f32 their masks, h, w6
    and active; the fixed-point paths add their quantized planes)."""
    return sum(_nbytes(*(getattr(b, f.name) for f in dataclasses.fields(b)))
               for b in eng._bricks)


def _state_bytes(st) -> int:
    return _nbytes(st.m, st.s, st.halos, st.sweep, st.flips)


def lower_ising_cell(mesh, multi_pod: bool, L: int = 100, iters: int = 2,
                     S: int = 4, device=None):
    """The paper's 1M-p-bit production workload on the production mesh
    (over the default process group): returns (engine, ``ChunkTrace`` of
    one recorded chunk after a warm one, extras, the memory it reads and
    allocates)."""
    from repro_torch.core.lattice import build_ea3d_lattice
    from repro_torch.core.lattice_dsim import LatticeDSIM
    if multi_pod:
        dim_axes = ("data", "model", "pod")      # z (periodic) -> pod (2 | 100)
    else:
        dim_axes = ("data", "model", None)
    pad = (112, 112)                              # x,y padded to 16*7
    dev = resolve_device(device)
    # staged on the host: the engine cuts the rank's brick and moves it
    prob = build_ea3d_lattice(L, seed=0, pad_xy=pad, device="cpu")
    eng = LatticeDSIM(prob, mesh=mesh, dim_axes=dim_axes, device=dev)
    cuda = dev.type == "cuda"
    held = {}

    def before(st):
        held["state"] = _state_bytes(st)
        if cuda:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            held["allocated"] = torch.cuda.memory_allocated(dev)

    trace = eng.trace_chunk(iters, S, before=before)
    b = eng._bricks[0]
    mem = {
        # what the chunk reads: the state, its brick's f32 constants (the
        # default precision's sweep reads masks, h, w6) and the betas
        "argument_size_in_bytes": held["state"] + _nbytes(b.masks, b.h, b.w6)
        + 4 * iters * S,
        "output_size_in_bytes": _state_bytes(trace.out),
        "temp_size_in_bytes": None,
        "alias_size_in_bytes": None,
        "peak_allocated_bytes": None,
        # the problem constants this rank holds on its device: its brick's
        "resident_problem_bytes": resident_problem_bytes(eng),
    }
    if cuda:
        peak = torch.cuda.max_memory_allocated(dev)
        mem["peak_allocated_bytes"] = int(peak)
        mem["temp_size_in_bytes"] = int(peak - held["allocated"])
    extras = {"p_bits": L ** 3, "padded_sites": int(np.prod(prob.dims)),
              "n_colors": prob.n_colors, "sync_every": S}
    return eng, trace, extras, mem


def _hw(dev) -> HW:
    if dev.type != "cuda":
        return HW()
    return HW(sms=torch.cuda.get_device_properties(dev).multi_processor_count)


def run_cell(arch: str, multi_pod: bool, report_dir: str = REPORT_DIR,
             device=None, rank=None) -> dict:
    """Record one rank's chunk (default :func:`interior_rank`) of
    ``arch`` on the production mesh and write its record as JSON."""
    import torch.distributed as dist
    from repro_torch.core.mesh import make_mesh
    dev = resolve_device(device)
    shape, axes = make_mesh_shape(multi_pod)
    chips = int(np.prod(shape))
    rank = interior_rank(multi_pod) if rank is None else int(rank)
    cfg = get_config(arch)
    if cfg.family != "ising":
        raise ValueError(f"{arch!r} is not an ising config; the dry-run "
                         "covers the p-bit production workload")
    cell = ShapeCell("sample_chunk", 0, 0, "sample")
    t0 = time.time()
    _fake_group(chips, rank)
    try:
        mesh = make_mesh(shape, axes, group=dist.group.WORLD)
        eng, trace, extras, mem = lower_ising_cell(mesh, multi_pod,
                                                   device=dev)
    finally:
        dist.destroy_process_group()
    hw = _hw(dev)
    mem["hbm_bytes"] = hw.hbm_bytes
    mem["fits"] = max(mem["peak_allocated_bytes"] or 0,
                      mem["resident_problem_bytes"]
                      + mem["argument_size_in_bytes"]) <= hw.hbm_bytes
    rep = roofline(trace, chips, hw=hw, model_flops=None)
    launches = {}
    for ln in trace.launches:
        launches[ln.name] = launches.get(ln.name, 0) + ln.launches
    rec = {
        "arch": arch, "shape": cell.name,
        "mesh": "multi_pod_2x16x16" if multi_pod else "single_pod_16x16",
        "chips": chips, "ok": True,
        "build_s": round(time.time() - t0 - trace.seconds, 2),
        "chunk_s": trace.seconds,
        "memory_analysis": mem, "extras": extras,
        "roofline": rep.as_dict(), "model_flops_global": None,
        "bound_s": rep.bound_s, "device": str(dev), "rank": rank,
        "coords": {a: int(c) for a, c in zip(
            axes, np.unravel_index(rank, shape))},
        "brick": list(eng.brick), "launches": launches,
        "kernels": [{"name": ln.name, "launches": ln.launches,
                     "shape": dict(ln.shape), "bytes": ln.bytes,
                     "int32": ln.int32, "fp32": ln.fp32}
                    for ln in trace.launches],
        "ops": len(trace.ops), "syncs": list(trace.syncs),
    }
    os.makedirs(report_dir, exist_ok=True)
    tail = "" if rank == interior_rank(multi_pod) else f"__rank{rank}"
    fn = f"{arch}__{cell.name}__{rec['mesh']}{tail}.json"
    with open(os.path.join(report_dir, fn), "w") as f:
        json.dump(rec, f, indent=1, default=str)
    return rec


def all_cells():
    for arch, cfg in list_configs().items():
        if cfg.family == "ising":
            yield arch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--report-dir", default=REPORT_DIR)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (the plain versions)")
    ap.add_argument("--rank", type=int, default=None,
                    help="the rank to record (default: one with every "
                         "neighbour)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cells = list(all_cells()) if args.all else [args.arch]
    meshes = [False, True] if (args.all or args.both_meshes) \
        else [args.multi_pod]
    failures = 0
    for arch in cells:
        for mp in meshes:
            mesh_tag = "multi_pod_2x16x16" if mp else "single_pod_16x16"
            tag = f"{arch:22s} sample_chunk   {'2x16x16' if mp else '16x16  '}"
            if args.skip_existing and os.path.exists(os.path.join(
                    args.report_dir,
                    f"{arch}__sample_chunk__{mesh_tag}.json")):
                print(f"SKIP {tag}")
                continue
            try:
                rec = run_cell(arch, mp, args.report_dir, dev, args.rank)
                r = rec["roofline"]
                print(f"OK   {tag} rank={rec['rank']} "
                      f"chunk={rec['chunk_s']:.6f}s "
                      f"bound={rec['bound_s']:.3e}s "
                      f"bytes={r['bytes_accessed']:.3e} "
                      f"wire={r['wire_bytes']:.3e} "
                      f"bottleneck={r['bottleneck']}", flush=True)
            except Exception as e:
                failures += 1
                print(f"FAIL {tag} {type(e).__name__}: {e}")
                traceback.print_exc()
    if failures:
        raise SystemExit(f"{failures} cells failed")


if __name__ == "__main__":
    main()
