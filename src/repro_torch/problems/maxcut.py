"""Max-Cut problems (the Gset / G81 family of the paper's Sec. S9).

Max-Cut on weights w maps to the Ising model J = -w (minimizing
E = -sum J_ij m_i m_j maximizes the cut).  cut(m) = (W_tot - sum w m m)/2.
The true G81 file is not bundled offline; :func:`gset_like_toroidal`
generates instances of the same family (toroidal grid, +-1 weights) and
:func:`parse_gset` reads standard Gset files when available.  Port of
``repro.problems.maxcut``.
"""

from __future__ import annotations

import io
from typing import Union

import numpy as np
import torch

from repro_torch.core.energy import cut_value
from repro_torch.core.graph import IsingGraph, from_edges, toroidal_grid

__all__ = ["parse_gset", "gset_like_toroidal", "maxcut_to_ising", "cut_of",
           "spins_to_hex", "hex_to_spins"]


def parse_gset(text_or_path: Union[str, io.TextIOBase],
               device=None) -> IsingGraph:
    """Parse the Gset format: 'n m' header then 'i j w' (1-based) lines."""
    if isinstance(text_or_path, str) and "\n" not in text_or_path:
        with open(text_or_path) as f:
            text = f.read()
    elif isinstance(text_or_path, str):
        text = text_or_path
    else:
        text = text_or_path.read()
    lines = [l for l in text.strip().splitlines() if l.strip()]
    n, m = map(int, lines[0].split()[:2])
    ei, ej, ew = [], [], []
    for l in lines[1:m + 1]:
        a, b, w = l.split()[:3]
        ei.append(int(a) - 1)
        ej.append(int(b) - 1)
        ew.append(float(w))
    return from_edges(n, np.asarray(ei), np.asarray(ej),
                      np.asarray(ew, dtype=np.float32), meta={"kind": "gset"},
                      device=device)


def gset_like_toroidal(rows: int = 100, cols: int = 200, seed: int = 0,
                       device=None) -> IsingGraph:
    """A G81-shaped instance: 100x200 toroidal grid, +-1 weights (20k nodes)."""
    return toroidal_grid(rows, cols, seed=seed, weights="pm1", device=device)


def maxcut_to_ising(g: IsingGraph) -> IsingGraph:
    """J = -w; biases zero."""
    return IsingGraph(idx=g.idx, w=-g.w, h=torch.zeros_like(g.h),
                      meta={**g.meta, "mapped": "maxcut"})


def cut_of(g_orig: IsingGraph, m) -> float:
    """Cut value of spins m (N,) on the ORIGINAL (unmapped) weighted graph."""
    m = torch.as_tensor(np.asarray(m) if not isinstance(m, torch.Tensor)
                        else m).to(g_orig.device)
    return float(cut_value(g_orig, m))


def spins_to_hex(m: np.ndarray) -> str:
    """The paper's verification encoding: {-1,+1} -> {0,1} bits -> hex."""
    bits = (np.asarray(m) > 0).astype(np.uint8)
    pad = (-len(bits)) % 4
    bits = np.concatenate([bits, np.zeros(pad, np.uint8)])
    nibbles = bits.reshape(-1, 4)
    vals = nibbles @ np.array([8, 4, 2, 1], np.uint8)
    return "".join(f"{v:X}" for v in vals)


def hex_to_spins(hx: str, n: int) -> np.ndarray:
    bits = []
    for ch in hx.strip():
        v = int(ch, 16)
        bits.extend([(v >> 3) & 1, (v >> 2) & 1, (v >> 1) & 1, v & 1])
    bits = np.asarray(bits[:n], dtype=np.int8)
    return (bits * 2 - 1).astype(np.int8)
