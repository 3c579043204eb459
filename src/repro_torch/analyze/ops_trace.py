"""What one chunk of an engine does, recorded: the counterpart of
``repro.analyze.jaxpr_utils``.

The reference audits the jaxpr its chunks trace to.  Eager PyTorch has no
program to trace, so the port runs one chunk and records it:

* :class:`OpRecorder`, a ``TorchDispatchMode``, records every aten op with
  the dtypes of its tensor operands and results, and the host syncs:
  ``_local_scalar_dense`` (``.item()``, ``bool``/``int``/``float`` of a
  tensor, a 0-d index tensor), ``equal`` (a Python bool), and a copy from
  a device to the host.  A host read that dispatches nothing on the CPU
  (``Tensor.tolist``, ``Tensor.numpy``) is caught by wrapping those
  methods for the recording; ``Tensor.cpu`` counts where it leaves a
  device (on a CPU tensor it is a no-op), and ``.numpy()`` of the copy
  it made is the same read, counted once.
* :class:`CommRecorder` wraps the ``torch.distributed`` calls the port
  makes (``all_gather``, ``all_reduce`` and ``batch_isend_irecv`` with
  each of its ``isend``/``irecv``) and records (op, dtype, shape, bytes)
  per call.
* :func:`record_published` wraps ``flips_publish`` where the engines
  import it, so the counter rule can ask whether a chunk's flip counter
  came out of it.
* :class:`LaunchRecorder` takes the notes the kernel wrappers make of
  each launch (``kernels/_build.note_launch``) and costs them with the
  kernels' work model (``kernels/work.py``), since on the card the hand
  kernels launch through ``ctypes`` and dispatch nothing: the other
  recorders see only the glue around them.

:func:`trace_call` runs a call under all four and returns a
:class:`ChunkTrace`; each op also carries its operand and result bytes
and its matrix-product FLOPs, each collective its group size, for the
roofline (``launch/roofline.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
import weakref
from typing import Any, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["OpRecord", "CommRecord", "LaunchRecord", "OpRecorder",
           "CommRecorder", "LaunchRecorder", "ChunkTrace", "trace_call",
           "record_published", "FLOAT_ARITH_OPS", "SYNC_OPS", "is_float",
           "PUBLISHERS"]

# float arithmetic the int8 and bit-plane chunk bodies must not do (aten
# op names, in-place forms folded); data movement, comparisons, casts and
# bit views are allowed: they move or reinterpret values
FLOAT_ARITH_OPS = frozenset({
    "add", "sub", "rsub", "mul", "div", "neg", "exp", "log", "log1p",
    "expm1", "tanh", "sigmoid", "erf", "sqrt", "rsqrt", "reciprocal", "pow",
    "abs", "sign", "maximum", "minimum", "max", "min", "amax", "amin",
    "clamp", "clamp_min", "clamp_max", "round", "floor", "ceil", "trunc",
    "sum", "mean", "prod", "cumsum", "cumprod", "mm", "bmm", "matmul",
    "dot", "addmm", "addcmul", "addcdiv", "lerp", "fmod", "remainder",
    "logsumexp", "std", "var", "norm", "sin", "cos", "atan2",
})

# aten ops that read a value to the host
SYNC_OPS = frozenset({"_local_scalar_dense", "equal"})

_FLOATS = ("float16", "bfloat16", "float32", "float64")


def is_float(dtype: str) -> bool:
    return dtype in _FLOATS


@dataclasses.dataclass(frozen=True)
class OpRecord:
    name: str                  # aten op, in-place suffix dropped
    dtypes: Tuple[str, ...]    # tensor operand and result dtypes
    nbytes: int = 0            # operand and result bytes
    flops: int = 0             # of a matrix product, else 0


@dataclasses.dataclass(frozen=True)
class CommRecord:
    op: str                    # all_gather | all_reduce | isend | ...
    dtype: str
    shape: Tuple[int, ...]
    nbytes: int
    group: int = 1             # ranks in the call's group; 2 point-to-point


@dataclasses.dataclass(frozen=True)
class LaunchRecord:
    name: str                  # the kernel's key in kernels.work.MODELS
    launches: int
    shape: Tuple[Tuple[str, int], ...]   # the integers its wrapper noted
    bytes: int                 # its work (kernels.work.Work) in all
    int32: int
    fp32: int


def _dtype(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


class OpRecorder(TorchDispatchMode):
    """Record the aten ops and host syncs of the code run inside it."""

    def __init__(self):
        super().__init__()
        self.ops: List[OpRecord] = []
        self.syncs: List[str] = []
        self._quiet = threading.local()     # inside a wrapped host read
        self._saved = {}
        # host copies already counted, by id (a tensor's == is elementwise)
        self._copies = weakref.WeakValueDictionary()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._overloadpacket.__name__.rstrip("_") or \
            func._overloadpacket.__name__
        ins = list(_tensors(args)) + list(_tensors(kwargs))
        outs = list(_tensors(out))
        self.ops.append(OpRecord(
            name, tuple(_dtype(t) for t in ins + outs),
            sum(_nbytes(t) for t in ins + outs), _matmul_flops(name, ins,
                                                               outs)))
        if not getattr(self._quiet, "on", False):
            to_host = name in ("_to_copy", "copy") and any(
                t.device.type != "cpu" for t in ins) and any(
                t.device.type == "cpu" for t in outs + ins[:1])
            if name in SYNC_OPS or to_host:
                self.syncs.append(name)
            if to_host:
                for t in outs:
                    self._copies[id(t)] = t
        return out

    def _wrap(self, meth: str, counts):
        orig = getattr(torch.Tensor, meth)
        rec = self

        def wrapped(t, *a, **k):
            if counts(t) and rec._copies.get(id(t)) is not t and \
                    not getattr(rec._quiet, "on", False):
                rec.syncs.append(f"Tensor.{meth}")
            was = getattr(rec._quiet, "on", False)
            rec._quiet.on = True
            try:
                out = orig(t, *a, **k)
            finally:
                rec._quiet.on = was
            if meth == "cpu" and t.device.type != "cpu":
                rec._copies[id(out)] = out
            return out
        self._saved[meth] = orig
        setattr(torch.Tensor, meth, wrapped)

    def __enter__(self):
        self._wrap("tolist", lambda t: True)
        self._wrap("numpy", lambda t: True)
        self._wrap("cpu", lambda t: t.device.type != "cpu")
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            for meth, orig in self._saved.items():
                setattr(torch.Tensor, meth, orig)
            self._saved.clear()


def _nbytes(t: torch.Tensor) -> int:
    return int(t.numel()) * int(t.element_size())


# matrix products: the operand whose last dimension is contracted
_MATMULS = {"mm": 0, "bmm": 0, "addmm": 1, "baddbmm": 1}


def _matmul_flops(name: str, ins, outs) -> int:
    """2 x result elements x contracted length of a matrix product."""
    k = _MATMULS.get(name)
    if k is None or not outs or len(ins) <= k:
        return 0
    return 2 * int(outs[0].numel()) * int(ins[k].shape[-1])


def _group_size(group) -> int:
    import torch.distributed as dist
    return int(dist.get_world_size(group))


class CommRecorder:
    """Wrap the ``torch.distributed`` calls the port makes and record each
    one (a ``batch_isend_irecv`` as itself and as each of its ops)."""

    def __init__(self):
        self.calls: List[CommRecord] = []
        self._saved = {}

    def _rec(self, op, t, group: int):
        self.calls.append(CommRecord(op, _dtype(t), tuple(t.shape),
                                     _nbytes(t), group))

    def __enter__(self):
        import torch.distributed as dist
        rec = self
        orig = {n: getattr(dist, n) for n in
                ("all_gather", "all_reduce", "batch_isend_irecv")}
        self._saved = orig

        def all_gather(tensor_list, tensor, group=None, *a, **k):
            rec._rec("all_gather", tensor, _group_size(group))
            return orig["all_gather"](tensor_list, tensor, group, *a, **k)

        def all_reduce(tensor, *a, **k):
            group = k.get("group", a[1] if len(a) > 1 else None)
            rec._rec("all_reduce", tensor, _group_size(group))
            return orig["all_reduce"](tensor, *a, **k)

        def batch_isend_irecv(p2p_op_list):
            t = p2p_op_list[0].tensor
            rec.calls.append(CommRecord(
                "batch_isend_irecv", _dtype(t), (len(p2p_op_list),),
                sum(_nbytes(p.tensor) for p in p2p_op_list), 2))
            for p in p2p_op_list:
                rec._rec(p.op.__name__, p.tensor, 2)
            return orig["batch_isend_irecv"](p2p_op_list)

        for name, fn in (("all_gather", all_gather),
                         ("all_reduce", all_reduce),
                         ("batch_isend_irecv", batch_isend_irecv)):
            setattr(dist, name, fn)
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist
        for name, fn in self._saved.items():
            setattr(dist, name, fn)
        self._saved = {}
        return False

    def counts(self) -> dict:
        out: dict = {}
        for c in self.calls:
            out[c.op] = out.get(c.op, 0) + 1
        return out


class LaunchRecorder:
    """Take the kernel wrappers' notes of their launches within the block
    (``kernels/_build.note_launch``) and, on leaving it, cost each with
    the work model (``kernels/work.launch_work``) into
    :class:`LaunchRecord` s.  Raises where a launch counted in
    ``_build.launch_counts`` went unnoted, or where a noted kernel has no
    model: no launch is costed at zero."""

    def __init__(self):
        self.launches: List[LaunchRecord] = []

    def __enter__(self):
        from repro_torch.kernels import _build
        self._saved = _build.launch_log
        self._before = dict(_build.launch_counts)
        self._log = _build.launch_log = []
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import _build, work
        _build.launch_log = self._saved
        if exc[0] is not None:
            return False
        for key, count in _build.launch_counts.items():
            if ":" in key:
                continue
            parts = [m for m in work.MODELS
                     if m == key or m.startswith(key + ":")]
            noted = sum(n for name, n, _ in self._log if name in parts)
            if count - self._before[key] != noted:
                raise ValueError(
                    f"{count - self._before[key] - noted} launches of "
                    f"{key} were not noted for their work model")
        for name, n, operands in self._log:
            w = work.launch_work(name, dict(operands))
            shape = tuple((k, int(v)) for k, v in operands.items()
                          if isinstance(v, int))
            self.launches.append(LaunchRecord(name, n, shape, w.bytes,
                                              w.int32, w.fp32))
        return False


@dataclasses.dataclass
class ChunkTrace:
    """What :func:`trace_call` recorded of one call."""
    ops: List[OpRecord]
    syncs: List[str]
    comms: List[CommRecord]
    launches: List[LaunchRecord]
    published: list           # what flips_publish returned within it
    seconds: float            # its wall time, ended by a synchronise
    out: Any                  # what the call returned


def trace_call(fn, *args, device=None) -> ChunkTrace:
    """Run ``fn(*args)`` once under every recorder of this module and
    time it; on a CUDA ``device`` the time starts and ends with a
    synchronise of the card."""
    # the first op under a dispatch mode imports torch._dynamo (seconds):
    # import it here, outside the timing
    import torch._dynamo  # noqa: F401
    cuda = device is not None and torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    published: list = []
    with LaunchRecorder() as launches, OpRecorder() as ops, \
            CommRecorder() as comms, record_published(published):
        t0 = time.perf_counter()
        out = fn(*args)
        if cuda:
            torch.cuda.synchronize(device)
        seconds = time.perf_counter() - t0
    return ChunkTrace(ops.ops, list(ops.syncs), comms.calls,
                      launches.launches, published, seconds, out)


# the modules that publish a chunk's flip counter through flips_publish
PUBLISHERS = ("repro_torch.core.gibbs", "repro_torch.core.dsim",
              "repro_torch.core.dsim_dist", "repro_torch.core.lattice_dsim")


@contextlib.contextmanager
def record_published(out: list):
    """Within the block, every tensor ``flips_publish`` returns in the
    engine modules is appended to ``out``."""
    import importlib
    mods = [importlib.import_module(m) for m in PUBLISHERS]
    saved = [(m, m.flips_publish) for m in mods if hasattr(m,
                                                            "flips_publish")]

    def wrap(fn):
        def published(*a, **k):
            r = fn(*a, **k)
            out.append(r)
            return r
        return published
    for m, fn in saved:
        m.flips_publish = wrap(fn)
    try:
        yield out
    finally:
        for m, fn in saved:
            m.flips_publish = fn
