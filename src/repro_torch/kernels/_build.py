"""Build and load the CUDA kernels, and count their launches.

The sources under ``csrc/`` are compiled at first use by ``nvcc`` for
``sm_90a`` (one process per source, all started together, then one link)
into a shared library with a plain C interface, loaded with ``ctypes``.
The library lands in ``build/kernels/`` at the repository root, named by
a digest of the sources and flags, so a changed source is rebuilt and an
unchanged one is reused.  There is no fallback: a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["SOURCES", "NVCC_FLAGS", "build", "library", "launch_counts",
           "KernelError", "note_launch",
           "reset_launch_counts", "check_launch", "ptrs6", "plain_device",
           "stream_of", "check_bx", "check_sites", "require"]

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("pbit_lattice.cu", "pbit_bitplane.cu", "lattice_energy.cu",
           "bitplane_phase.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas=-v", "-Xcompiler", "-fPIC")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

# Launches per kernel, one per kernel launch by its wrapper and nowhere
# else; a run resets them and reads them to show which kernels it used.
# Keys are the TPU functions the kernels replace.
launch_counts = {"pbit_brick_sweep_int": 0, "pbit_bitplane_sweep": 0,
                 "brick_energy": 0, "pbit_brick_sweep": 0,
                 "pbit_brick_update_int": 0, "pbit_brick_update": 0,
                 # the persistent sweeps' launches by LFSR mode
                 "pbit_brick_sweep_int:lfsr_smem": 0,
                 "pbit_brick_sweep_int:lfsr_global": 0,
                 "pbit_brick_sweep:lfsr_smem": 0,
                 "pbit_brick_sweep:lfsr_global": 0,
                 # the phases' and the energy's launches by z-sites per
                 # thread (a word of 4, or one site)
                 "pbit_brick_update:word": 0,
                 "pbit_brick_update:site": 0,
                 "pbit_brick_update_int:word": 0,
                 "pbit_brick_update_int:site": 0,
                 "brick_energy:word": 0,
                 "brick_energy:site": 0,
                 # the energy's launches on bit-plane word planes
                 "brick_energy:bitplane": 0,
                 # the ELL word gather-count of the general-graph
                 # bit-plane path (no Pallas original), launched as the
                 # fused colour phase that redesigns it (":phase")
                 "bitplane_gather_count": 0,
                 "bitplane_gather_count:phase": 0,
                 # no launch: each permutation of a brick's bit-plane LFSR
                 # columns into or out of #2's colour-major order
                 "pbit_bitplane_sweep:lfsr_permute": 0,
                 # #2's launches by where they read the LUT: a table
                 # staged in shared memory, or global memory (wide rows)
                 "pbit_bitplane_sweep:lut_shared": 0,
                 "pbit_bitplane_sweep:lut_global": 0,
                 # #2's launches whose grid splits the word planes (a
                 # phase too small to fill the card)
                 "pbit_bitplane_sweep:plane_groups": 0}


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


# Set by a recording (``analyze.ops_trace.LaunchRecorder``) to a list: each
# wrapper then also notes its launches there with the shapes and operands
# their work depends on (``kernels/work.py``).  None otherwise: noting
# costs nothing.
launch_log = None


def note_launch(name: str, launches: int = 1, **operands):
    """Note ``launches`` launches of kernel ``name`` (its key in
    ``work.MODELS``) for a recording in progress."""
    if launch_log is not None:
        launch_log.append((name, int(launches), operands))


class KernelError(RuntimeError):
    """A hand kernel failed to build (``nvcc``) or to launch: a property
    of the code, the toolkit or the card, never worth a retry."""


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise KernelError("nvcc not found (set CUDA_HOME); the repro_torch "
                           "CUDA kernels are built from source at first use")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC)):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile (if needed) and return the path of the kernel library."""
    lib = BUILD_DIR / f"librepro_torch_kernels_{_digest()}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src in SOURCES:
        obj = BUILD_DIR / (Path(src).stem + f".{os.getpid()}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = [], []
    for src, _, p in procs:
        out, _ = p.communicate()
        log.append(f"== {src}\n{out}")
        if p.returncode != 0:
            failed.append(src)
    (BUILD_DIR / "build.log").write_text("\n".join(log))
    if failed:
        raise KernelError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    tmp = BUILD_DIR / f"{lib.name}.{os.getpid()}.tmp"
    res = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
         *(str(obj) for _, obj, _ in procs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if res.returncode != 0:
        raise KernelError(f"nvcc link failed:\n{res.stdout}")
    os.replace(tmp, lib)
    for _, obj, _ in procs:
        obj.unlink()
    return lib


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_P6 = ctypes.c_void_p * 6
_SIGNATURES = {
    # m_in, m_out, s_in, s_out, rows_t, mask, h_q, w6, halos, lut,
    # lw, R, X, Y, Z, width, flips, stream
    "pbit_update_int_phase": (_P, _P, _P, _P, _P, _P, _P, _P6, _P6, _P,
                              _I, _I, _I, _I, _I, _I, _P, _P),
    # m_in, m_out, s_in, s_out, betas_t, mask, h, w6, halos,
    # fmt_on, step, lo, hi, R, X, Y, Z, width, flips, stream
    "pbit_update_f32_phase": (_P, _P, _P, _P, _P, _P, _P, _P6, _P6,
                              _I, _F, _F, _F, _I, _I, _I, _I, _I, _P, _P),
    # out[2]: SM count, opt-in shared memory per block
    "pbit_device_limits": (_P,),
    # kind, resident, smem, out[1]: blocks per SM
    "pbit_persistent_occupancy": (_I, _I, _I, _P),
    # m0, buf0, buf1, s_in, s_out, betas, masks, h, w6, halos, fmt_on,
    # step, lo, hi, S, n_colors, R, X, Y, Z, resident, grid, tile, smem,
    # lists, flips, stream
    "pbit_sweep_f32_persistent": (_P, _P, _P, _P, _P, _P, _P, _P, _P6, _P6,
                                  _I, _F, _F, _F, _I, _I, _I, _I, _I, _I,
                                  _I, _I, _I, _I, _P, _P, _P),
    # m0, buf0, buf1, s_in, s_out, rows, masks, h_q, w6, halos, lut, lw,
    # S, n_colors, R, X, Y, Z, resident, grid, tile, smem, lists, flips,
    # stream
    "pbit_sweep_int_persistent": (_P, _P, _P, _P, _P, _P, _P, _P, _P6, _P6,
                                  _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                  _I, _I, _P, _P, _P),
    # mw, s_src, s_dst, perm, rows_t, mask_cm, packed, halos, lut, lw, W,
    # R, X, Y, Z, lo, hi, decide_lo, color, n_colors, idx_lo, span, groups,
    # flips, stream
    "pbit_bitplane_color_phase": (_P, _P, _P, _P, _P, _P, _P, _P6, _P, _I,
                                  _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                  _I, _I, _I, _P, _P),
    # m, active, h, w6, halos, R, X, Y, Z, width, blocks, partials, out,
    # stream
    "brick_energy": (_P, _P, _P, _P6, _P6, _I, _I, _I, _I, _I, _I, _P, _P,
                     _P),
    # mw, active, h, w6, halos, W, R, X, Y, Z, width, blocks, partials,
    # out, stream
    "brick_energy_words": (_P, _P, _P, _P6, _P6, _I, _I, _I, _I, _I, _I,
                           _I, _P, _P, _P),
    # mw, ghosts, s, slots, flags, base, idx, signs, nz, thr, lw, f_max, K,
    # W, R, n_max, g_max, nc, D, wpt, flips, stream
    "bitplane_phase_dist": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                            _I, _I, _I, _I, _I, _I, _I, _I, _P, _P),
    # mw, s, slots, base, idx, signs, nz, thr, lw, f_max, W, R, n, nc, D,
    # scratch, E, scale, stream
    "bitplane_phase_apt": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                           _I, _I, _I, _P, _P, _F, _P),
}


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call in this process)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check_launch(name: str, err: int):
    """Raise on a non-zero cudaError_t returned right after a launch."""
    if err != 0:
        raise KernelError(f"CUDA launch of {name} failed: cudaError_t "
                           f"{err}")


def ptrs6(tensors) -> "ctypes.Array":
    return _P6(*(t.data_ptr() for t in tensors))


def plain_device(t) -> bool:
    """True for a CPU tensor (the wrapper then runs the plain version);
    False for a CUDA tensor (the kernel launches); raises otherwise."""
    if t.device.type == "cpu":
        return True
    if t.is_cuda:
        return False
    raise ValueError(f"repro_torch kernels run on CUDA or CPU tensors, "
                     f"got {t.device}")


def stream_of(t) -> int:
    """PyTorch's current CUDA stream on ``t``'s device, as a pointer."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def check_bx(X: int, bx):
    """The reference's x-tile check.  The Pallas per-phase kernels tile x
    by ``bx`` to fit VMEM; a CUDA grid tiles the brick anyway, so ``bx``
    only has to divide X and changes no result."""
    if bx is not None and X % int(bx) != 0:
        raise ValueError(f"Bx={X} not divisible by tile bx={bx}")


def check_sites(X: int, Y: int, Z: int):
    """The kernels index the sites of a brick with 32-bit integers (and
    round the grid up past the last site)."""
    if X * Y * Z >= 1 << 30:
        raise ValueError(f"brick {(X, Y, Z)} has 2^30 sites or more; the "
                         f"kernels index a brick's sites with int32")


def require(name: str, t, dtype, shape, device):
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device`` — what the kernel reads through a raw pointer."""
    if t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got "
                         f"{t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
