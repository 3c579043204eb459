"""Sharding rules: logical tensor roles -> mesh partition specs -> DTensor
placements; port of ``repro.sharding.rules``.

Axes: 'model' = tensor parallel, 'data' (+ 'pod' when present) = batch /
FSDP.  Rules, per tensor role:

  embed (V, D)            V->model (vocab padded to 128), D->data if fsdp
  lm_head (D, V)          V->model, D->data if fsdp
  attn wq/wk/wv (D, HDh)  dim1->model, dim0->data if fsdp (column parallel)
  attn wo (HDh, D)        dim0->model, dim1->data if fsdp (row parallel)
  mlp wi/wg (D, F)        F->model, D fsdp;  mlp wo (F, D) F->model, D fsdp
  moe wi/wg (E, D, F)     F->model, D fsdp;  moe wo (E, F, D) same
  moe router              replicated
  mamba in/out proj       fsdp over D only
  norms / scalar vectors  replicated

Activations: batch dims -> ('pod','data'); KV caches: batch->data,
kv-length->model; Mamba states: batch->data.  Every dim is sharded only
if divisible by the axis size (else replicated on that axis), so one rule
set serves every arch and any mesh.

A spec (:class:`PartitionSpec`, ``P``) names one mesh axis, a tuple of
axes, or ``None`` per dimension, as JAX's does; it is a pure function of
the leaf's path, its shape and the mesh's axis sizes (``_param_spec``).
The port's parameter trees keep one tree per group (no leading group
axis), so a port leaf's spec is the reference's for the same leaf with its
leading ``None`` removed.  :class:`NamedSharding` pairs a spec with a
``torch.distributed`` ``DeviceMesh`` and gives its DTensor placements
(``Shard(d)`` on each mesh dimension a tensor dimension names,
``Replicate()`` elsewhere), PyTorch's counterpart of JAX's
``NamedSharding``; ``device_put`` places a tensor so.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np

from repro_torch.train.tree import tree_map, tree_paths

__all__ = ["batch_axes", "params_shardings", "batch_shardings",
           "cache_shardings", "opt_shardings", "train_state_shardings",
           "spec_to_sharding", "PartitionSpec", "P", "NamedSharding",
           "device_put", "mesh_sizes"]


class PartitionSpec(tuple):
    """One mesh axis name, tuple of names or ``None`` per dimension (a
    tuple of one name is that name, as in JAX's)."""

    def __new__(cls, *axes):
        return super().__new__(cls, tuple(
            a[0] if isinstance(a, tuple) and len(a) == 1 else a
            for a in axes))

    def __repr__(self):
        return "P" + tuple.__repr__(self)


P = PartitionSpec


def mesh_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size of a ``DeviceMesh``, a ``core.mesh.BrickMesh`` or
    a plain mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return {n: int(mesh.size(i)) for i, n in enumerate(names)}
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(mesh.shape)


class NamedSharding:
    """A partition spec on a ``DeviceMesh`` with named dimensions."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = P(*spec)

    @property
    def placements(self) -> tuple:
        from torch.distributed.tensor import Replicate, Shard
        out = []
        for name in self.mesh.mesh_dim_names:
            dims = [i for i, a in enumerate(self.spec)
                    if a == name or (isinstance(a, tuple) and name in a)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)

    def __repr__(self):
        return f"NamedSharding({self.spec!r})"


def device_put(x, sharding: NamedSharding):
    """``x`` (a tensor holding the whole array on every rank) as a DTensor
    laid out by ``sharding``; ``None`` stays ``None``."""
    if x is None or sharding is None:
        return x
    from torch.distributed.tensor import DTensor, distribute_tensor
    if isinstance(x, DTensor):
        return x.redistribute(sharding.mesh, sharding.placements)
    return distribute_tensor(x.detach(), sharding.mesh, sharding.placements)


def batch_axes(mesh):
    return ("pod", "data") if "pod" in mesh_sizes(mesh) else ("data",)


def _div(dim: int, sizes: Dict[str, int], axis) -> bool:
    if axis is None:
        return True
    k = int(np.prod([sizes[a] for a in
                     ((axis,) if isinstance(axis, str) else axis)]))
    return dim % k == 0


def _maybe(dim, sizes, axis):
    return axis if _div(dim, sizes, axis) else None


def _param_spec(pathstr: str, shape: Tuple[int, ...], sizes: Dict[str, int],
                fsdp: bool) -> P:
    """The spec of one parameter leaf: its path (``train.tree`` form), its
    shape, the mesh's axis sizes and whether FSDP shards over 'data'."""
    dax = "data" if fsdp else None

    def sp(*axes):
        return P(*(_maybe(shape[i], sizes, a) for i, a in enumerate(axes)))

    if "embed" in pathstr:
        return sp("model", dax)
    if "lm_head" in pathstr:
        return sp(dax, "model")
    if any(k in pathstr for k in ("'wq'", "'wk'", "'wv'")):
        return sp(dax, "model")
    if "'wo'" in pathstr and "attn" in pathstr:
        return sp("model", dax)
    if "moe" in pathstr and "shared" not in pathstr:
        if "router" in pathstr:
            return P(*((None,) * len(shape)))
        if any(k in pathstr for k in ("'wi'", "'wg'")):
            return sp(None, dax, "model")     # (E, D, F)
        if "'wo'" in pathstr:
            return sp(None, "model", dax)     # (E, F, D)
    if any(k in pathstr for k in ("'wi'", "'wg'")):   # dense mlp (D, F)
        return sp(dax, "model")
    if "'wo'" in pathstr:                              # dense mlp (F, D)
        return sp("model", dax)
    if "mamba" in pathstr and any(k in pathstr for k in
                                  ("in_proj", "out_proj")):
        return sp(dax, None)
    # norms, conv, A_log, dt_bias, router etc: replicate
    return P(*((None,) * len(shape)))


def _map_paths(fn, tree):
    """``fn(path, leaf)`` over ``tree``'s leaves, in its structure."""
    results = iter([fn(path, leaf) for path, leaf in tree_paths(tree)])
    return tree_map(lambda _: next(results), tree)


def params_shardings(params: Any, mesh, fsdp: bool):
    sizes = mesh_sizes(mesh)
    return _map_paths(lambda ps, leaf: NamedSharding(
        mesh, _param_spec(ps, tuple(leaf.shape), sizes, fsdp)), params)


def batch_shardings(batch_tree: Any, mesh):
    sizes, baxes = mesh_sizes(mesh), batch_axes(mesh)

    def one(ps, leaf):
        if "positions3" in ps:
            spec = P(None, _maybe(leaf.shape[1], sizes, baxes))
        else:
            spec = P(_maybe(leaf.shape[0], sizes, baxes))
        return NamedSharding(mesh, spec)
    return _map_paths(one, batch_tree)


def cache_shardings(caches: Any, mesh):
    """KV k/v (B, Hkv, S, Dh): B->data, S->model (split-KV decode).
    Mamba conv (B, w, ch) / ssm (B, h, p, n): B->data."""
    sizes = mesh_sizes(mesh)

    def one(ps, leaf):
        if ".pos" in ps or leaf.dim() == 0:
            return NamedSharding(mesh, P())
        shape = tuple(leaf.shape)
        b_ax = _maybe(shape[0], sizes, "data")
        if ".k" in ps or ".v" in ps:
            s_ax = _maybe(shape[2], sizes, "model")
            return NamedSharding(mesh, P(b_ax, None, s_ax, None))
        return NamedSharding(mesh, P(*((b_ax,) + (None,) * (len(shape) - 1))))

    return _map_paths(one, caches)


def _norm_spec(sh: NamedSharding, ndim: int):
    spec = tuple(sh.spec) + (None,) * (ndim - len(sh.spec))
    return spec[:ndim]


def opt_shardings(opt_state: Any, param_sharding_tree: Any, mesh,
                  int8: bool):
    """m/v shard like their parameter; int8 codes (..., L/128, 128) and
    scales (..., L/128) inherit the param spec — the last param-dim spec
    entry lands on the block-count dim (divisibility permitting)."""
    sizes = mesh_sizes(mesh)
    repl = NamedSharding(mesh, P())
    if not int8:
        return dataclasses.replace(
            opt_state, step=repl,
            m=param_sharding_tree, v=param_sharding_tree,
            m_scale=None, v_scale=None)

    def codes(sh, leaf):
        spec = _norm_spec(sh, leaf.dim() - 1)
        spec = tuple(a if _div(leaf.shape[i], sizes, a) else None
                     for i, a in enumerate(spec))
        return NamedSharding(mesh, P(*(spec + (None,))))

    def scales(sh, leaf):
        spec = _norm_spec(sh, leaf.dim())
        spec = tuple(a if _div(leaf.shape[i], sizes, a) else None
                     for i, a in enumerate(spec))
        return NamedSharding(mesh, P(*spec))

    return dataclasses.replace(
        opt_state, step=repl,
        m=tree_map(codes, param_sharding_tree, opt_state.m),
        v=tree_map(codes, param_sharding_tree, opt_state.v),
        m_scale=tree_map(scales, param_sharding_tree, opt_state.m_scale),
        v_scale=tree_map(scales, param_sharding_tree, opt_state.v_scale))


def train_state_shardings(state, mesh, fsdp: bool, int8: bool):
    pss = params_shardings(state.params, mesh, fsdp)
    oss = opt_shardings(state.opt, pss, mesh, int8)
    return dataclasses.replace(state, params=pss, opt=oss)


def spec_to_sharding(mesh, tree_of_specs):
    """Every :class:`PartitionSpec` of a dict/list/tuple tree as a
    :class:`NamedSharding` on ``mesh``."""
    if isinstance(tree_of_specs, PartitionSpec):
        return NamedSharding(mesh, tree_of_specs)
    if isinstance(tree_of_specs, dict):
        return {k: spec_to_sharding(mesh, v) for k, v in tree_of_specs.items()}
    if isinstance(tree_of_specs, (list, tuple)):
        return type(tree_of_specs)(spec_to_sharding(mesh, v)
                                   for v in tree_of_specs)
    return tree_of_specs

