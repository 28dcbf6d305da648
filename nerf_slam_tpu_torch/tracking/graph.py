"""Host-side co-visibility graph bookkeeping (numpy).

The factor-graph topology decisions -- neighborhood edges, distance-based
proximity edges with non-max suppression, age-based eviction -- are tiny,
sequentially-dependent integer computations; the reference also runs them
in Python on the CPU (visual_frontend.py:690-775).  Keeping them host-side
lets every device step stay static-shape: the host hands the device padded
edge arrays plus an index plan (solver/dba.plan).

Distances come from the device (camera.frame_distance); everything else is
numpy.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Set, Tuple

import numpy as np


@dataclass
class CovisibilityGraph:
    """Active + inactive edge sets with ages (visual_frontend.py:222-234)."""
    max_factors: int = 48
    ii: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    jj: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    age: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    ii_inactive: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.int64))
    jj_inactive: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.int64))
    ii_bad: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    jj_bad: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))

    @property
    def n_edges(self) -> int:
        return int(self.ii.shape[0])

    @property
    def n_inactive(self) -> int:
        return int(self.ii_inactive.shape[0])

    def edge_set(self) -> Set[Tuple[int, int]]:
        s = set(zip(self.ii.tolist(), self.jj.tolist()))
        s |= set(zip(self.ii_inactive.tolist(), self.jj_inactive.tolist()))
        return s

    def filter_repeated(self, ii, jj):
        """Drop proposed edges already present (visual_frontend.py:896-907)."""
        es = self.edge_set()
        keep = [k for k, (i, j) in enumerate(zip(ii, jj))
                if (int(i), int(j)) not in es]
        return np.asarray(ii)[keep], np.asarray(jj)[keep]

    def add_edges(self, ii, jj) -> Tuple[np.ndarray, np.ndarray]:
        """Append new (deduplicated) edges; returns what was added."""
        ii, jj = self.filter_repeated(ii, jj)
        if ii.shape[0] == 0:
            return ii, jj
        self.ii = np.concatenate([self.ii, ii])
        self.jj = np.concatenate([self.jj, jj])
        self.age = np.concatenate([self.age, np.zeros(ii.shape[0],
                                                      np.int64)])
        return ii, jj

    def rm_edges(self, mask: np.ndarray, store: bool) -> np.ndarray:
        """Drop masked edges, optionally storing them as inactive.
        Returns the integer indices of the *kept* edges (for compacting
        the per-edge device state)."""
        mask = np.asarray(mask, dtype=bool)
        if store and mask.any():
            self.ii_inactive = np.concatenate(
                [self.ii_inactive, self.ii[mask]])
            self.jj_inactive = np.concatenate(
                [self.jj_inactive, self.jj[mask]])
        keep = np.nonzero(~mask)[0]
        self.ii = self.ii[keep]
        self.jj = self.jj[keep]
        self.age = self.age[keep]
        return keep

    def rm_keyframe_reindex(self, kf_idx: int) -> Tuple[np.ndarray,
                                                        np.ndarray]:
        """Handle keyframe removal (visual_frontend.py:529-574): drop
        inactive edges touching kf_idx, shift indices > kf_idx down by 1,
        and return (keep_indices, removed_mask) for the active set; the
        caller must also drop the active edges touching kf_idx."""
        # inactive
        m_in = (self.ii_inactive == kf_idx) | (self.jj_inactive == kf_idx)
        self.ii_inactive = np.where(self.ii_inactive >= kf_idx,
                                    self.ii_inactive - 1, self.ii_inactive)
        self.jj_inactive = np.where(self.jj_inactive >= kf_idx,
                                    self.jj_inactive - 1, self.jj_inactive)
        keep_in = np.nonzero(~m_in)[0]
        self.ii_inactive = self.ii_inactive[keep_in]
        self.jj_inactive = self.jj_inactive[keep_in]

        # active: reindex, then report which to drop (no store)
        m_act = (self.ii == kf_idx) | (self.jj == kf_idx)
        self.ii = np.where(self.ii >= kf_idx, self.ii - 1, self.ii)
        self.jj = np.where(self.jj >= kf_idx, self.jj - 1, self.jj)
        keep_act = self.rm_edges(m_act, store=False)
        return keep_act, keep_in


def neighborhood_edges(kf0: int, kf1: int, radius: int = 3,
                       stereo: bool = False):
    """All pairs within `radius` frames (visual_frontend.py:690-708).
    Note the reference includes kf1 (arange(kf0, kf1+1))."""
    r = np.arange(kf0, kf1 + 1)
    ii, jj = np.meshgrid(r, r, indexing="ij")
    ii, jj = ii.ravel(), jj.ravel()
    d = np.abs(ii - jj)
    c = 1 if stereo else 0
    keep = (d <= radius) & (d > c)
    return ii[keep], jj[keep]


def proximity_edges(graph: CovisibilityGraph, distances: np.ndarray,
                    kf_idx: int, kf0: int, kf1: int, rad: int, nms: int,
                    thresh: float, max_factors: int,
                    stereo: bool = False):
    """Distance-based edge proposals with NMS
    (visual_frontend.py:712-775).  ``distances`` is the flattened (t-kf0,
    t-kf1) grid of frame distances d[(i-kf0)*(t-kf1) + (j-kf1)] for
    i in [kf0, t), j in [kf1, t), t = kf_idx + 1.
    Returns (ii, jj) proposals (bidirectional)."""
    t = kf_idx + 1
    ix = np.arange(kf0, t)
    jx = np.arange(kf1, t)
    ii_g, jj_g = np.meshgrid(ix, jx, indexing="ij")
    ii_g = ii_g.ravel()
    jj_g = jj_g.ravel()

    d = np.array(distances, dtype=np.float64).copy()
    d[(ii_g - rad) < jj_g] = np.inf
    d[d > 100] = np.inf

    n_j = t - kf1

    def suppress(i, j):
        lim = max(min(abs(i - j) - 2, nms), 0)
        for di in range(-nms, nms + 1):
            for dj in range(-nms, nms + 1):
                if abs(di) + abs(dj) <= lim:
                    i1, j1 = i + di, j + dj
                    if kf0 <= i1 < t and kf1 <= j1 < t:
                        d[(i1 - kf0) * n_j + (j1 - kf1)] = np.inf

    ii1 = np.concatenate([graph.ii, graph.ii_bad, graph.ii_inactive])
    jj1 = np.concatenate([graph.jj, graph.jj_bad, graph.jj_inactive])
    for i, j in zip(ii1.tolist(), jj1.tolist()):
        suppress(int(i), int(j))

    es: List[Tuple[int, int]] = []
    for i in range(kf0, t):
        if stereo:
            es.append((i, i))
            d[(i - kf0) * n_j + (i - kf1)] = np.inf
        for j in range(max(i - rad - 1, 0), i):
            es.append((i, j))
            es.append((j, i))
            if kf1 <= j < t:
                d[(i - kf0) * n_j + (j - kf1)] = np.inf

    for k in np.argsort(d):
        if d[k] > thresh:
            continue
        if len(es) > max_factors:
            break
        i = int(ii_g[k])
        j = int(jj_g[k])
        es.append((i, j))
        es.append((j, i))
        suppress(i, j)

    if not es:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    arr = np.asarray(es, dtype=np.int64)
    return arr[:, 0], arr[:, 1]
