"""Parameters across packages: numpy arrays in, the port's objects out.

The reference's ``IsingGraph``, ``LatticeProblem``, and its ``LatticeState``
/ ``BitplaneLatticeState`` / ``GibbsState`` / ``DSIMState`` / ``APTState``
fields, given
as numpy arrays, become the port's graph, problem and states (and back),
so both packages can compute the same thing from the same data.  A
``rng="philox"`` state cannot cross: a ``jax.random`` key and a
``torch.Generator`` are different streams, and an ``APTState`` crosses
with the port's generator state bytes as its ``key``.  States cross in the reference's global shapes: a
mesh engine's ``shard_state`` cuts one into its bricks, and a
``BrickState`` of a one-process mesh is joined back (a distributed DSIM
over a process group gives its global state through ``global_state``).  The dtypes are the reference's: int8 spins, uint32
LFSR states and words, f32 couplings, int32 counters.

An LM's parameter tree crosses too (``lm_params_from_numpy``,
``lm_params_to_numpy``): the reference stacks each group's leaves on a
leading axis, the port keeps a list of per-group trees.  Caches go out
the same way (``lm_cache_to_numpy``), and a training state crosses both
ways (``train_state_from_numpy``, ``train_state_to_numpy``): its
parameters, and its optimizer's step, moments (f32, or int8 codes) and
block scales.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.apt_icm import APTState
from repro_torch.core.device import resolve_device
from repro_torch.core.dsim import DSIMState
from repro_torch.core.gibbs import GibbsState
from repro_torch.core.graph import IsingGraph
from repro_torch.core.lattice import LatticeProblem
from repro_torch.core.lattice_dsim import (BitplaneLatticeState, BrickState,
                                           LatticeState, join_bricks)
from repro_torch.core.snapshot import restore_state, snapshot_state
from repro_torch.models.layers import KVCache
from repro_torch.models.mamba2 import Mamba2Cache
from repro_torch.train.optimizer import OptState
from repro_torch.train.train_step import TrainState
from repro_torch.train.tree import tree_leaves, tree_map

__all__ = ["graph_from_numpy", "problem_from_numpy", "state_from_numpy",
           "state_to_numpy", "lm_params_from_numpy", "lm_params_to_numpy",
           "lm_cache_to_numpy", "train_state_from_numpy",
           "train_state_to_numpy"]

_PHILOX = ("a rng='philox' state cannot cross between the packages: a "
           "jax.random key and a torch.Generator are different streams; "
           "use rng='lfsr'")
_APT_KEY = ("an APTState's key crosses only as the port's generator state "
            "bytes (uint8); a jax.random key is another stream: pass the "
            "key of the port's init_state(seed)")
_APT_FIELDS = {"m", "E", "key", "sweep", "swaps", "icms", "lfsr"}


def graph_from_numpy(idx, w, h, meta=None, device=None) -> IsingGraph:
    """The reference ``IsingGraph``'s ELL arrays (numpy) -> the port's
    graph on ``device`` (CUDA unless ``device="cpu"``)."""
    dev = resolve_device(device)
    as_t = lambda a, dt: torch.from_numpy(np.array(a, dt)).to(dev)  # noqa: E731
    return IsingGraph(idx=as_t(idx, np.int32), w=as_t(w, np.float32),
                      h=as_t(h, np.float32), meta=dict(meta or {}))


def problem_from_numpy(*, L, dims, seed, n_colors, h, w6, masks, active,
                       device=None) -> LatticeProblem:
    """The reference ``LatticeProblem``'s fields (arrays as numpy) -> the
    port's problem on ``device`` (CUDA unless ``device="cpu"``)."""
    dev = resolve_device(device)
    as_t = lambda a, dt: torch.from_numpy(np.array(a, dt)).to(dev)  # noqa: E731
    return LatticeProblem(
        L=int(L), dims=tuple(int(d) for d in dims), seed=int(seed),
        n_colors=int(n_colors), h=as_t(h, np.float32),
        w6=tuple(as_t(w, np.float32) for w in w6),
        masks=as_t(masks, np.int8), active=as_t(active, np.int8))


def state_from_numpy(*, device=None, **fields):
    """A reference state's fields (numpy) -> the port's state on
    ``device``.  The field names pick the state: ``m, s, halos, sweep,
    flips`` a lattice state (uint32 words in ``m`` a
    ``BitplaneLatticeState``, int8 spins a ``LatticeState``); ``m, rng, E,
    sweep, flips`` a ``GibbsState``; ``m, ghosts, macc, rng, sweep,
    flips`` a ``DSIMState`` of the stacked or the distributed DSIM (uint32
    words in ``m``: the distributed bit-plane state); ``m, E, key, sweep,
    swaps, icms, lfsr`` an ``APTState`` (uint32 words in ``m``: packed;
    ``lfsr`` None with rng="philox"; ``key`` the port's uint8 generator
    state).  An ``rng`` that is not one uint32 LFSR state per spin or lane
    (a philox key) raises, as does an APT ``key`` that is not uint8."""
    keys = set(fields)
    m = np.asarray(fields["m"])
    if keys == _APT_FIELDS:
        key = np.asarray(fields["key"])
        if key.dtype != np.uint8:
            raise ValueError(_APT_KEY)
        lfsr = fields["lfsr"]
        snap = APTState(
            m=m if m.dtype == np.uint32 else np.asarray(m, np.int8),
            E=np.asarray(fields["E"], np.float32), key=key,
            sweep=np.asarray(fields["sweep"], np.int32),
            swaps=np.asarray(fields["swaps"], np.int32),
            icms=np.asarray(fields["icms"], np.int32),
            lfsr=None if lfsr is None else np.asarray(lfsr, np.uint32))
        return restore_state(snap, resolve_device(device))
    if keys == {"m", "s", "halos", "sweep", "flips"}:
        if m.dtype == np.uint32:
            cls = BitplaneLatticeState
        elif m.dtype == np.int8:
            cls = LatticeState
        else:
            raise TypeError(
                f"m must be int8 spins or uint32 words, got {m.dtype}")
        snap = cls(m=m, s=np.asarray(fields["s"], np.uint32),
                   halos=tuple(np.asarray(h, m.dtype)
                               for h in fields["halos"]),
                   sweep=np.asarray(fields["sweep"], np.int32),
                   flips=np.asarray(fields["flips"], np.int32))
        return restore_state(snap, resolve_device(device))
    # the distributed DSIM's bit-plane state: (K, W, n_max) uint32 words
    # and word ghosts beside (K, R, n_max) LFSR states
    words = m.dtype == np.uint32
    if keys == {"m", "rng", "E", "sweep", "flips"}:
        cls, extra = GibbsState, {"E": np.asarray(fields["E"], np.float32)}
    elif keys == {"m", "ghosts", "macc", "rng", "sweep", "flips"}:
        cls, extra = DSIMState, {
            "ghosts": np.asarray(fields["ghosts"],
                                 np.uint32 if words else np.float32),
            "macc": np.asarray(fields["macc"], np.float32)}
    else:
        raise TypeError(f"no state of the port has the fields {sorted(keys)}")
    rng = np.asarray(fields["rng"])
    one_per_spin = rng.shape == m.shape or (
        words and cls is DSIMState and rng.ndim == m.ndim == 3
        and rng.shape[::2] == m.shape[::2])
    if rng.dtype != np.uint32 or not one_per_spin:
        raise ValueError(_PHILOX)
    snap = cls(m=m if words else np.asarray(m, np.int8), rng=rng,
               sweep=np.asarray(fields["sweep"], np.int32),
               flips=np.asarray(fields["flips"], np.int32), **extra)
    return restore_state(snap, resolve_device(device))


def state_to_numpy(state) -> dict:
    """The port's state -> a dict of the reference field names with owned
    numpy arrays (``halos`` a tuple), in the reference's global shapes."""
    if isinstance(state, (GibbsState, DSIMState)) and \
            state.rng.dtype == torch.uint8:
        raise ValueError(_PHILOX)
    if isinstance(state, BrickState):
        state = join_bricks(state)
    snap = snapshot_state(state)
    return {f.name: getattr(snap, f.name) for f in dataclasses.fields(snap)}


# the parameter trees' keys whose values are stacked block groups
_LM_GROUPS = ("groups", "enc_groups", "dec_groups")


def _tensor(a, dev):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":       # ml_dtypes' bfloat16 from JAX
        return torch.from_numpy(a.astype(np.float32)).to(dev, torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(dev)


def lm_params_from_numpy(cfg, tree, device=None) -> dict:
    """The reference's LM parameter tree (numpy leaves; each of
    ``groups``/``enc_groups``/``dec_groups`` a tuple of block trees whose
    leaves carry the group axis first) -> the port's tree on ``device``
    (CUDA unless ``device="cpu"``): those values become a list with one
    tuple of block trees per group.  bf16 leaves stay bf16."""
    dev = resolve_device(device)
    want = {"groups": cfg.n_groups, "enc_groups": cfg.enc_layers,
            "dec_groups": cfg.n_groups}
    out = {}
    for key, val in tree.items():
        if key in _LM_GROUPS:
            n = int(np.shape(tree_leaves(val)[0])[0])
            if n != want[key]:
                raise ValueError(f"{cfg.name}: {n} {key}, the config has "
                                 f"{want[key]}")
            out[key] = [tree_map(lambda a, g=g: _tensor(np.asarray(a)[g], dev),
                                  tuple(val)) for g in range(n)]
        else:
            out[key] = tree_map(lambda a: _tensor(a, dev), val)
    return out


def _numpy(t) -> np.ndarray:
    """Owned host copy; bf16 as f32 (numpy has no bf16)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy().copy()


def _stack_groups(groups):
    """A list of per-group trees -> one tree of numpy leaves stacked on
    a leading group axis (the reference's layout)."""
    flat = [tree_leaves(g) for g in groups]
    stacked = iter([np.stack(xs) for xs in zip(*flat)])
    return tree_map(lambda _: next(stacked), groups[0])


def lm_params_to_numpy(params) -> dict:
    """The port's LM parameter tree -> the reference's, with numpy leaves
    (bf16 as f32) and each group list stacked on a leading axis."""
    out = {}
    for key, val in params.items():
        if key in _LM_GROUPS:
            out[key] = _stack_groups(tree_map(_numpy, val))
        else:
            out[key] = tree_map(_numpy, val)
    return out


def _cache_fields(tree):
    if isinstance(tree, (KVCache, Mamba2Cache)):
        return {f.name: _numpy(getattr(tree, f.name))
                for f in dataclasses.fields(tree)}
    if isinstance(tree, dict):
        return {k: _cache_fields(v) for k, v in tree.items()}
    return type(tree)(_cache_fields(v) for v in tree)


def lm_cache_to_numpy(caches) -> dict:
    """The port's LM caches (``init_cache`` or a step's result) -> the
    reference's shapes: each ``KVCache``/``Mamba2Cache`` a dict of its
    fields as numpy, the group list stacked on a leading axis (so every
    ``pos`` of the groups is one (n_groups,) array)."""
    out = {}
    for key, val in caches.items():
        fields = _cache_fields(val)
        out[key] = _stack_groups(fields) if isinstance(val, list) and val \
            else fields
    return out


_OPT_TREES = ("m", "v", "m_scale", "v_scale")


def _field(tree, name):
    return tree[name] if isinstance(tree, dict) else getattr(tree, name)


def train_state_from_numpy(cfg, tree, device=None) -> TrainState:
    """The reference's ``TrainState`` with numpy leaves (or a dict
    ``{"params": ..., "opt": {"step", "m", "v", "m_scale", "v_scale"}}``
    of them) -> the port's on ``device`` (CUDA unless ``device="cpu"``):
    every tree of the parameters' structure goes through
    ``lm_params_from_numpy``; ``m_scale``/``v_scale`` are ``None`` for
    f32 moments."""
    dev = resolve_device(device)
    opt = _field(tree, "opt")
    trees = {k: (None if _field(opt, k) is None else
                 lm_params_from_numpy(cfg, _field(opt, k), dev))
             for k in _OPT_TREES}
    step = torch.tensor(int(np.asarray(_field(opt, "step"))),
                        dtype=torch.int32, device=dev)
    return TrainState(
        params=lm_params_from_numpy(cfg, _field(tree, "params"), dev),
        opt=OptState(step=step, **trees))


def train_state_to_numpy(state: TrainState) -> dict:
    """The port's ``TrainState`` -> ``{"params": ..., "opt": {"step", "m",
    "v", "m_scale", "v_scale"}}`` in the reference's layout (numpy
    leaves, groups stacked; bf16 as f32)."""
    opt = state.opt
    return {"params": lm_params_to_numpy(state.params),
            "opt": dict({"step": _numpy(opt.step)}, **{
                k: (None if getattr(opt, k) is None else
                    lm_params_to_numpy(getattr(opt, k)))
                for k in _OPT_TREES})}
