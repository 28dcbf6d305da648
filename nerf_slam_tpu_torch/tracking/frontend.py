"""RAFT visual frontend: the tracking state machine (PyTorch).

Keyframe state lives in preallocated device buffers of ``cfg.buffer``
slots; per-edge state (GRU hidden, flow targets, correlation pyramids)
lives in ``cfg.e_active`` padded slots, active edges first, with numpy
slot bookkeeping on the host.  Per keyframe the frontend

  1. ingests the frame: normalize, feature/context encode, and the
     motion-filter magnitude (a correlation pyramid against the last
     keyframe, the motion lookup kernel, one GRU update);
  2. edits the co-visibility graph (age eviction, proximity edges) and
     syncs the edge slots: compaction, new-edge initialization, pyramid
     builds for new edges only;
  3. runs iters1 update iterations -- projective transform, the update
     lookup kernel chosen by ``cfg.corr_impl``, ConvGRU, dense BA -- then
     the keyframe distance decides: reject (roll the buffers down) or run
     iters2 more iterations and the export tail (covariances, flow RMS,
     convex upsampling, next-keyframe seeding).

At the end of the sequence ``cfg.global_ba`` runs the backend: full-map
bundle adjustment over a denser graph with on-the-fly correlation, kept
only if the map's multi-view depth consistency does not fall.

The JAX package fuses these steps into single jitted programs to save
round trips to a remote TPU; this port runs them eagerly, in the same
order, and syncs to the host where a decision needs a value.

The steps run inside spans of ``utils.runtime`` (recorded while a
profiler records): ``track.frame`` (a call, with the frame's ``k`` and
the tracker's ``session``, which each ``reset`` renews) over
``track.ingest`` (upload, encoders; inside it ``track.motion``, the
magnitude and its read), ``track.graph`` (graph edits, edge-slot sync,
the round's plan and shards), ``track.iter`` (an update iteration;
inside it ``track.dba``), ``track.kf_dist``, ``track.export`` (inside it
``track.cov``) and ``track.viz_out``; and ``track.reset``.
"""
from __future__ import annotations

import copy
import itertools
from dataclasses import dataclass, fields
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..geometry import camera, se3, upsample
from ..models import DroidNet
from ..ops import corr, corr_lookup
from ..ops.segment import reduce_in_order
from ..parallel.tracking import placement, shard_devices, shard_plan
from ..solver import dba
from ..utils import runtime
from . import graph as graphlib

# the trackers' sessions, numbered across the process
_SESSIONS = itertools.count(1)


@dataclass(frozen=True)
class FrontendConfig:
    # capacities
    buffer: int = 64                 # keyframe buffer
    e_active: int = 64               # active edge slots (>= max_factors)
    e_inactive: int = 64             # inactive edge slots for BA reuse
    p_window: int = 32               # pose window slots
    k_depth: int = 48                # depth-map slots
    # DROID frontend parameters (visual_frontend.py:92-131)
    keyframe_warmup: int = 8
    max_age: int = 25
    max_factors: int = 48
    motion_filter_thresh: float = 2.4
    keyframe_thresh: float = 4.0
    frontend_thresh: float = 16.0
    frontend_window: int = 25
    frontend_radius: int = 2
    frontend_nms: int = 1
    beta: float = 0.3
    iters1: int = 4
    iters2: int = 2
    gn_iters: int = 2
    dsf: int = 8
    lm: float = 1e-4
    ep: float = 0.1
    # BA depth damping = damping_scale * eta + damping_offset (the weight
    # files carry their own values in the sidecar JSON)
    damping_scale: float = 0.2
    damping_offset: float = 1e-7
    sigma_idepth: float = 0.1        # initial inverse-depth variance prior
    # False: the export tail skips the marginal covariances and exports
    # 1e-4 I pose and unit inverse-depth variances, as the JAX tracker does
    compute_covariances: bool = True
    # update-loop lookup: "pallas4g" (four pooled slabs, bf16 hat weights,
    # n_act-gated) | "pallas" (level-0 slab only, levels 1-3 derived in the
    # kernel) | "pallas_grouped" (four slabs, one exact-tap launch per
    # level) | "onehot" (the plain reference lookup, no kernel)
    corr_impl: str = "pallas4g"
    # Schur complement: "dense" (one contraction over the (P, K) coupling
    # tensor) | "sparse" (interaction list of coupling pairs)
    schur_impl: str = "dense"
    global_ba: bool = False          # full-map BA at terminate()
    # stereo: keyframes carry right-camera features too; the graph adds
    # (i, i) STEREO edges whose correlation targets cam1 and whose relative
    # pose is pinned to ``stereo_rel`` (cam1_T_cam0, [t, q_xyzw]); in the
    # DBA they constrain depth and scale only
    stereo: bool = False
    stereo_rel: tuple = (-0.1, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0)
    # RGB-D: sensed inverse depths from the packets' depths seed each new
    # keyframe and anchor the gauge in the DBA (monocular runs keep the
    # free Sim(3) gauge)
    rgbd: bool = False
    # edge-sharded update: split the active and the inactive edge slots
    # into this many shards (both counts must divide by it), each run on
    # its device of parallel.tracking.shard_devices: projective
    # transform, lookup, ConvGRU, linearization and edge sums per shard;
    # the GRU pool, the DBA's edge sums and the flow RMS reduced across
    # shards; the solve once.  1 = off.
    edge_shards: int = 1


CORR_IMPLS = ("pallas4g", "pallas", "pallas_grouped", "onehot")


@dataclass
class KeyframeState:
    """Per-keyframe device buffers (B = cfg.buffer)."""
    timestamps: torch.Tensor      # (B,)
    images: torch.Tensor          # (B, H, W, 3) uint8
    intrinsics: torch.Tensor      # (B, 4) at feature resolution
    gt_poses: torch.Tensor        # (B, 4, 4)
    gt_depths: torch.Tensor       # (B, H, W)
    cam_T_world: torch.Tensor     # (B, 7)
    pose_cov: torch.Tensor        # (B, 6, 6) [w, v] block order (export)
    idepths: torch.Tensor         # (B, h, w)
    idepths_cov: torch.Tensor     # (B, h, w)
    depths_cov: torch.Tensor      # (B, h, w)
    idepths_sensed: torch.Tensor  # (B, h, w) (0: monocular)
    idepths_up: torch.Tensor      # (B, H, W)
    depths_cov_up: torch.Tensor   # (B, H, W)
    damping: torch.Tensor         # (B, h, w) GRU-predicted eta
    features: torch.Tensor        # (B, h, w, 128) bf16
    contexts: torch.Tensor        # (B, h, w, 128) bf16 (tanh)
    cst_contexts: torch.Tensor    # (B, h, w, 128) bf16 (relu)
    features1: torch.Tensor       # (B, h, w, 128) bf16 right camera
                                  # (stereo; (B, 1, 1, 1) otherwise)

    def permute(self, idx: torch.Tensor) -> None:
        for f in fields(self):
            setattr(self, f.name, getattr(self, f.name)[idx])


@dataclass
class EdgeState:
    """Per-active-edge device buffers (Ea = cfg.e_active)."""
    hidden: torch.Tensor          # (Ea, h, w, 128) GRU hidden (net dtype)
    flow: torch.Tensor            # (Ea, h, w, 2) fp32 GRU flow targets
    flow_weight: torch.Tensor     # (Ea, h, w, 2) fp32
    corr_levels: list             # (Ea, h, w, h_l padded to 8, w_l) bf16:
                                  # 4 levels, or level 0 alone under
                                  # corr_impl="pallas"


@dataclass
class InactiveState:
    flow: torch.Tensor            # (Ei, h, w, 2)
    flow_weight: torch.Tensor     # (Ei, h, w, 2)


@dataclass
class _Shard:
    """One edge shard of an update round, on its device: its slots of the
    global edge buffers (views on the tracker's device, copies elsewhere)
    and its plan (its slots' edge rows, the slot arrays replicated)."""
    net: DroidNet
    act: slice                    # its active slots
    plan: dba.DBAPlan             # [its active ++ its inactive slots]
    levels: list                  # its active slots' correlation levels
    in_flow: torch.Tensor         # its inactive slots' flows
    in_weight: torch.Tensor
    gates: tuple                  # the GRU's context gates of its edges


_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)
_GTSAM_PERM = [3, 4, 5, 0, 1, 2]     # DROID [v, w] -> GTSAM [w, v]


class RaftVisualFrontend:
    """Tracking state machine over a :class:`DroidNet` (its dtype is the
    compute dtype: bf16 on the card).  ``frontend(k, batch)`` processes
    frame k and returns a viz packet dict or None."""

    def __init__(self, net: DroidNet, cfg: FrontendConfig, image_size,
                 world_T_cam0_t0: Optional[np.ndarray] = None,
                 device="cuda"):
        if cfg.corr_impl not in CORR_IMPLS:
            raise ValueError(f"corr_impl {cfg.corr_impl!r} is not one of "
                             f"{CORR_IMPLS}")
        if cfg.schur_impl not in ("dense", "sparse"):
            raise ValueError(f"schur_impl {cfg.schur_impl!r} is not 'dense' "
                             f"or 'sparse'")
        n = cfg.edge_shards
        if n < 1 or cfg.e_active % n or cfg.e_inactive % n:
            raise ValueError(f"e_active/e_inactive must divide "
                             f"edge_shards={n}")
        self.cfg = cfg
        self.device = torch.device(device)
        # stored pyramid levels per edge
        self._n_levels = 1 if cfg.corr_impl == "pallas" else 4
        # interaction-list padding of the sparse Schur plan (compute_pairs
        # grows to the next power of two if a window needs more)
        self._pair_pad = max(2048, int(2 ** np.ceil(np.log2(
            8 * (cfg.e_active + cfg.e_inactive)))))
        # tracking is inference only: no autograd graphs anywhere
        self.net = net.to(self.device).eval().requires_grad_(False)
        self.shard_devices = shard_devices(n, self.device)
        # a replica of the network on each other device a shard runs on
        self._nets = {d: self.net if d == self.device
                      else copy.deepcopy(self.net).to(d)
                      for d in self.shard_devices}
        if n > 1:
            print(f"edge_shards={n} {placement(self.shard_devices)}",
                  flush=True)
        self.H, self.W = image_size
        self.h, self.w = self.H // cfg.dsf, self.W // cfg.dsf
        self.world_T_cam0_t0 = (np.eye(4, dtype=np.float32)
                                if world_T_cam0_t0 is None
                                else np.asarray(world_T_cam0_t0))
        self._coords0 = camera.coords_grid(self.h, self.w,
                                           device=self.device)
        self._mean = torch.tensor(_MEAN, device=self.device)
        self._std = torch.tensor(_STD, device=self.device)
        # the rig pose of the stereo edges, or None (monocular)
        self._rig = (torch.tensor(cfg.stereo_rel, dtype=torch.float32,
                                  device=self.device)
                     if cfg.stereo else None)
        self.reset()

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------
    def reset(self):
        """Fresh tracking state on the same instance: a new session."""
        self.session = next(_SESSIONS)
        with runtime.span("track.reset", session=self.session):
            self._fresh_state()

    def _fresh_state(self):
        cfg, dev = self.cfg, self.device
        B, H, W, h, w = cfg.buffer, self.H, self.W, self.h, self.w
        Ea, Ei = cfg.e_active, cfg.e_inactive
        f32, bf16 = torch.float32, torch.bfloat16
        self.kf_idx = 0
        self.last_kf_idx = 0
        self.last_k: Optional[int] = None
        self.is_initialized = False
        self.stop = False
        self.last_kf_dist = float("inf")
        self.last_motion_mag = None
        self.last_flow_rms = None
        self.last_gba_scores: Optional[Tuple[float, float]] = None
        self.kf_idx_to_f_idx: Dict[int, int] = {}
        self.f_idx_to_kf_idx: Dict[int, int] = {}
        # deferred edge maintenance: graph edits compose here and are
        # applied at the start of the next update (or by rm_keyframe)
        self._pending_gather: Optional[np.ndarray] = None
        self._pending_app: list = []
        self._pending_app_n_old = 0
        self.graph = graphlib.CovisibilityGraph(max_factors=cfg.max_factors)
        self.viz_idx = np.zeros(B, dtype=bool)

        init_pose = se3.from_matrix(torch.as_tensor(
            np.linalg.inv(self.world_T_cam0_t0), dtype=f32, device=dev))

        def full(shape, v, dtype=f32):
            return torch.full(shape, v, dtype=dtype, device=dev)

        self.state = KeyframeState(
            timestamps=full((B,), 0.0),
            images=full((B, H, W, 3), 0, torch.uint8),
            intrinsics=full((B, 4), 0.0),
            gt_poses=torch.eye(4, device=dev).repeat(B, 1, 1),
            gt_depths=full((B, H, W), 0.0),
            cam_T_world=init_pose.repeat(B, 1),
            pose_cov=1e-4 * torch.eye(6, device=dev).repeat(B, 1, 1),
            idepths=full((B, h, w), 1.0),
            idepths_cov=full((B, h, w), cfg.sigma_idepth ** 2),
            depths_cov=full((B, h, w), 1.0),
            idepths_sensed=full((B, h, w), 0.0),
            idepths_up=full((B, H, W), 0.0),
            depths_cov_up=full((B, H, W), 1.0),
            damping=full((B, h, w), 1e-6),
            features=full((B, h, w, 128), 0.0, bf16),
            contexts=full((B, h, w, 128), 0.0, bf16),
            cst_contexts=full((B, h, w, 128), 0.0, bf16),
            features1=full((B, h, w, 128) if cfg.stereo else (B, 1, 1, 1),
                           0.0, bf16))
        levels, hl, wl = [], h, w
        for _ in range(self._n_levels):
            levels.append(full((Ea, h, w, -(-hl // 8) * 8, wl), 0.0, bf16))
            hl, wl = hl // 2, wl // 2
        self.edges = EdgeState(
            hidden=full((Ea, h, w, 128), 0.0, self.net.dtype),
            flow=full((Ea, h, w, 2), 0.0),
            flow_weight=full((Ea, h, w, 2), 0.0),
            corr_levels=levels)
        self.inactive = InactiveState(flow=full((Ei, h, w, 2), 0.0),
                                      flow_weight=full((Ei, h, w, 2), 0.0))

    # ------------------------------------------------------------------
    # frame ingest and the motion filter
    # ------------------------------------------------------------------
    def _normalize(self, img_u8: torch.Tensor) -> torch.Tensor:
        """uint8 (H, W, 3) -> normalized float (1, H, W, 3)."""
        return ((img_u8.float() / 255.0 - self._mean) / self._std)[None]

    def _motion_mag(self, feat_cur, last_kf: int) -> torch.Tensor:
        """Mean GRU flow-delta magnitude against keyframe ``last_kf``
        (visual_frontend.py:976-1007); a device scalar."""
        st = self.state
        f1 = st.features[last_kf].permute(2, 0, 1)[None]
        f2 = feat_cur.to(torch.bfloat16).permute(2, 0, 1)[None]
        cvals = corr.CorrPyramidPallas.from_volume(
            corr.build_volume(f1, f2)).nhwc(self._coords0[None])
        _, delta, _ = self.net.update(st.contexts[last_kf][None],
                                      st.cst_contexts[last_kf][None],
                                      cvals.to(torch.bfloat16))
        return torch.linalg.norm(delta, dim=-1).mean()

    def _ingest(self, k: int, slot: int, batch: Dict[str, Any],
                with_motion: bool) -> Optional[float]:
        """Encode frame k, compute its motion magnitude against the last
        keyframe (before the store; read on the host), and store it into
        ``slot``.  A slot
        whose frame is then rejected simply holds a candidate that the
        next frame overwrites."""
        dev, st, cfg = self.device, self.state, self.cfg
        img = torch.as_tensor(np.ascontiguousarray(
            np.asarray(batch["images"])[..., :3]), device=dev)
        image_norm = self._normalize(img)
        f = self.net.features(image_norm)[0]
        c, ci = self.net.context(image_norm)
        mag = None
        if with_motion:
            with runtime.span("track.motion"):
                mag = float(self._motion_mag(f, self.last_kf_idx))
        if cfg.stereo:
            # the right camera needs features only (no context)
            right = batch.get("images_right")
            assert right is not None, \
                "stereo frontend needs batch['images_right']"
            img1 = torch.as_tensor(np.ascontiguousarray(
                np.asarray(right)[..., :3]), device=dev)
            st.features1[slot] = self.net.features(
                self._normalize(img1))[0].to(torch.bfloat16)
        if batch.get("idepths_sensed") is not None:
            st.idepths_sensed[slot] = torch.as_tensor(
                np.asarray(batch["idepths_sensed"], np.float32), device=dev)
        st.timestamps[slot] = float(batch["t_cams"]) \
            if batch.get("t_cams") is not None else float(k)
        st.images[slot] = img
        st.intrinsics[slot] = torch.as_tensor(
            np.asarray(batch["intrinsics"], np.float32) / cfg.dsf,
            device=dev)
        if batch.get("poses") is not None:
            st.gt_poses[slot] = torch.as_tensor(
                np.asarray(batch["poses"], np.float32), device=dev)
        if batch.get("depths") is not None:
            st.gt_depths[slot] = torch.as_tensor(
                np.asarray(batch["depths"], np.float32), device=dev)
        st.features[slot] = f.to(torch.bfloat16)
        st.contexts[slot] = c[0].to(torch.bfloat16)
        st.cst_contexts[slot] = ci[0].to(torch.bfloat16)
        return mag

    # ------------------------------------------------------------------
    # edge-state maintenance
    # ------------------------------------------------------------------
    def _flush_pending(self):
        """Apply deferred maintenance: the inactive-flow append (from the
        pre-sync edge slots) first, then the edge sync."""
        cfg = self.cfg
        if self._pending_app:
            Ei = cfg.e_inactive
            idx = np.concatenate(self._pending_app)[:Ei]
            n_new, n_old = len(idx), self._pending_app_n_old
            shift = max(n_old + n_new - Ei, 0)
            start = n_old - shift
            sel = torch.as_tensor(idx, device=self.device)
            ia = self.inactive
            f = torch.roll(ia.flow, -shift, 0)
            w = torch.roll(ia.flow_weight, -shift, 0)
            f[start:start + n_new] = self.edges.flow[sel]
            w[start:start + n_new] = self.edges.flow_weight[sel]
            self.inactive = InactiveState(flow=f, flow_weight=w)
            self._pending_app = []
        if self._pending_gather is not None:
            pg = self._pending_gather
            self._pending_gather = None
            self._apply_edge_sync(pg)

    def _apply_edge_sync(self, slot_map: np.ndarray):
        """slot_map: for each current edge, its pre-change slot (-1 = new).
        Surviving slots are gathered (volumes depend only on keyframe
        identity, which compaction preserves); new slots get hidden =
        context, flow = reprojection, weight 0, and fresh pyramids."""
        Ea, g, st, dev = self.cfg.e_active, self.graph, self.state, \
            self.device
        n = slot_map.shape[0]
        if n > Ea:
            raise ValueError(f"{n} edges > e_active {Ea} slots (stereo adds "
                             f"an (i, i) edge a keyframe)")
        gather = np.zeros(Ea, np.int64)
        gather[:n] = np.maximum(slot_map, 0)
        gi = torch.as_tensor(gather, device=dev)
        ed = self.edges
        hidden, flow, flow_w = ed.hidden[gi], ed.flow[gi], ed.flow_weight[gi]
        levels = [lv[gi] for lv in ed.corr_levels]
        new_pos = np.nonzero(slot_map < 0)[0]
        if new_pos.size:
            pos = torch.as_tensor(new_pos, device=dev)
            ii = torch.as_tensor(g.ii[new_pos], device=dev)
            jj = torch.as_tensor(g.jj[new_pos], device=dev)
            target, _, _ = camera.projective_transform(
                st.cam_T_world, st.idepths, st.intrinsics, ii, jj,
                stereo_rel=self._rig)
            hidden[pos] = st.contexts[ii].to(hidden.dtype)
            flow[pos] = target
            flow_w[pos] = 0.0
            f = st.features.permute(0, 3, 1, 2)
            fj = f[jj]
            if self.cfg.stereo:
                # stereo (i, i) edges correlate cam0 with cam1 features
                fj = torch.where((ii == jj)[:, None, None, None],
                                 st.features1.permute(0, 3, 1, 2)[jj], fj)
            for lv, nl in zip(levels, corr.build_pyramid_bf16(
                    f[ii], fj, self._n_levels, pad_rows_to=8)):
                lv[pos] = nl
        self.edges = EdgeState(hidden=hidden, flow=flow, flow_weight=flow_w,
                               corr_levels=levels)

    def _sync_edges_after_change(self, keep, n_new: int, n_before: int):
        """Record a topology change: compose the pending slot map (current
        edge -> pre-pending slot, -1 = new)."""
        base = (self._pending_gather if self._pending_gather is not None
                else np.arange(n_before, dtype=np.int64))
        assert base.shape[0] == n_before, (base.shape, n_before)
        self._pending_gather = np.concatenate(
            [base[np.asarray(keep, np.int64)], -np.ones(n_new, np.int64)])

    def _store_inactive_flows(self, idx: np.ndarray):
        """Queue the flows of edges ``idx`` (current host layout) for the
        inactive ring; edges added since the last sync have no flow yet."""
        idx = np.asarray(idx, np.int64)
        if self._pending_gather is not None:
            slots = self._pending_gather[idx]
            idx = slots[slots >= 0]
        if len(idx) == 0:
            return
        if not self._pending_app:
            self._pending_app_n_old = min(self.graph.n_inactive,
                                          self.cfg.e_inactive)
        self._pending_app.append(idx)

    def _spill_inactive(self):
        """Cap the inactive edge list at e_inactive (keep the newest)."""
        g = self.graph
        n = min(g.n_inactive, self.cfg.e_inactive)
        if g.n_inactive > self.cfg.e_inactive:
            g.ii_inactive = g.ii_inactive[-n:]
            g.jj_inactive = g.jj_inactive[-n:]

    def add_factors(self, ii, jj, remove: bool = False):
        """visual_frontend.py:806-862."""
        g, cfg = self.graph, self.cfg
        ii, jj = g.filter_repeated(np.asarray(ii), np.asarray(jj))
        if ii.shape[0] == 0:
            return
        keep = np.arange(g.n_edges)
        n_before = g.n_edges
        if (cfg.max_factors > 0 and remove
                and g.n_edges + ii.shape[0] > cfg.max_factors):
            # drop the oldest edges to make room
            rank = np.empty(g.n_edges, np.int64)
            rank[np.argsort(g.age, kind="stable")] = np.arange(g.n_edges)
            drop = rank >= (cfg.max_factors - ii.shape[0])
            self._store_inactive_flows(np.nonzero(drop)[0])
            keep = g.rm_edges(drop, store=True)
            self._spill_inactive()
        g.add_edges(ii, jj)
        self._sync_edges_after_change(keep, ii.shape[0], n_before)

    def rm_factors(self, mask: np.ndarray, store: bool):
        g = self.graph
        n_before = g.n_edges
        mask = np.asarray(mask, dtype=bool)
        if n_before == 0 or not mask.any():
            return
        if store:
            self._store_inactive_flows(np.nonzero(mask)[0])
        keep = g.rm_edges(mask, store=store)
        self._spill_inactive()
        self._sync_edges_after_change(keep, 0, n_before)

    def add_neighborhood_factors(self, kf0, kf1, radius=3):
        # stereo (i, i) edges enter through add_proximity_factors
        ii, jj = graphlib.neighborhood_edges(kf0, kf1, radius,
                                             stereo=self.cfg.stereo)
        self.add_factors(ii, jj)

    def distance(self, ii, jj) -> np.ndarray:
        st = self.state
        ii = torch.as_tensor(np.asarray(ii, np.int64).reshape(-1),
                             device=self.device)
        jj = torch.as_tensor(np.asarray(jj, np.int64).reshape(-1),
                             device=self.device)
        d = camera.frame_distance_bidirectional(
            st.cam_T_world, st.idepths, st.intrinsics, ii, jj, self.cfg.beta)
        return d.cpu().numpy()

    def add_proximity_factors(self, kf0=0, kf1=0, rad=2, nms=2,
                              thresh=16.0, remove=False):
        t = self.kf_idx + 1
        ii_g, jj_g = np.meshgrid(np.arange(kf0, t), np.arange(kf1, t),
                                 indexing="ij")
        d = self.distance(ii_g.ravel(), jj_g.ravel())
        ii, jj = graphlib.proximity_edges(
            self.graph, d, self.kf_idx, kf0, kf1, rad, nms, thresh,
            self.cfg.max_factors, stereo=self.cfg.stereo)
        if ii.shape[0]:
            self.add_factors(ii, jj, remove)

    def rm_keyframe(self, kf_idx: int):
        """visual_frontend.py:529-574: roll the buffers down over kf_idx."""
        self._flush_pending()
        B, Ei = self.cfg.buffer, self.cfg.e_inactive
        perm = np.arange(B)
        perm[kf_idx:-1] = np.arange(kf_idx + 1, B)
        self.state.permute(torch.as_tensor(perm, device=self.device))
        g = self.graph
        n_in_before = g.n_inactive
        m_act = (g.ii == kf_idx) | (g.jj == kf_idx)
        keep_act, keep_in = g.rm_keyframe_reindex(kf_idx)
        if len(keep_in) != n_in_before:
            idx = np.zeros(Ei, np.int64)
            idx[:len(keep_in)] = keep_in
            gi = torch.as_tensor(idx, device=self.device)
            self.inactive = InactiveState(
                flow=self.inactive.flow[gi],
                flow_weight=self.inactive.flow_weight[gi])
        self._sync_edges_after_change(keep_act, 0,
                                      len(keep_act) + int(m_act.sum()))

    # ------------------------------------------------------------------
    # the update: GRU + DBA iterations, then the export tail
    # ------------------------------------------------------------------
    def _plan(self, use_inactive: bool, kf0: int, kf1: int) -> dba.DBAPlan:
        """Slot-aligned DBA plan over [active slots ++ inactive slots]."""
        cfg, g = self.cfg, self.graph
        Ea, Ei = cfg.e_active, cfg.e_inactive
        ii_all = np.zeros(Ea + Ei, np.int64)
        jj_all = np.zeros(Ea + Ei, np.int64)
        valid = np.zeros(Ea + Ei, bool)
        n = g.n_edges
        ii_all[:n], jj_all[:n], valid[:n] = g.ii, g.jj, True
        n_in = g.n_inactive
        if use_inactive and n_in:
            ii_all[Ea:Ea + n_in] = g.ii_inactive
            jj_all[Ea:Ea + n_in] = g.jj_inactive
            valid[Ea:Ea + n_in] = ((g.ii_inactive >= kf0 - 3)
                                   & (g.jj_inactive >= kf0 - 3))
        return self._slot_aligned_plan(ii_all, jj_all, valid, kf0, kf1)

    def _slot_aligned_plan(self, ii_all, jj_all, valid, kf0: int,
                           kf1: int) -> dba.DBAPlan:
        """DBA plan whose edge axis is the given slot layout; under
        ``schur_impl="sparse"`` it carries the interaction list."""
        cfg = self.cfg
        P, K = cfg.p_window, cfg.k_depth
        kf_ids = np.unique(np.concatenate([np.arange(kf0, kf1),
                                           ii_all[valid]]))
        if kf_ids.shape[0] > K:
            raise ValueError(f"{kf_ids.shape[0]} depth maps > capacity {K}")
        kmap = {int(k): s for s, k in enumerate(kf_ids)}
        px = np.arange(kf0, kf0 + P)
        p_fixed = np.zeros(P)
        if kf0 == 0:
            p_fixed[0] = 1.0
        kx = np.zeros(K, np.int64)
        kx[:kf_ids.shape[0]] = kf_ids
        k_valid = np.zeros(K)
        k_valid[:kf_ids.shape[0]] = 1.0
        arrays = {
            "ii": np.where(valid, ii_all, 0), "jj": np.where(valid, jj_all, 0),
            "pi": np.where(valid & (ii_all >= kf0) & (ii_all < kf1),
                           ii_all - kf0, -1),
            "pj": np.where(valid & (jj_all >= kf0) & (jj_all < kf1),
                           jj_all - kf0, -1),
            "kk": np.array([kmap.get(int(i), -1) if v else -1
                            for i, v in zip(ii_all, valid)], np.int64),
            "edge_valid": valid, "px": np.clip(px, 0, cfg.buffer - 1),
            "p_valid": px < kf1, "p_fixed": p_fixed, "kx": kx,
            "k_valid": k_valid}
        if cfg.schur_impl == "sparse":
            arrays["pair_a"], arrays["pair_b"], arrays["pair_valid"] = \
                dba.compute_pairs(arrays["pi"], arrays["pj"], arrays["kk"],
                                  valid, pad_to=self._pair_pad)
        return dba.plan_from_numpy(arrays, self.device)

    def _lookup(self, levels, n_act: torch.Tensor):
        """The update loop's lookup under ``cfg.corr_impl``: a function
        from level-0 coords (E, h, w, 2) to (E, h, w, 196) correlation
        features of the edges whose ``levels`` are given, through the
        kernel the JAX tracker's configuration of the same name reaches."""
        impl = self.cfg.corr_impl
        dims = corr_lookup.pyramid_dims(self.h, self.w)
        if impl == "pallas4g":
            # active edges occupy the slot prefix; the kernel reads the
            # count from device memory and zero-fills the padded slots
            return lambda c: corr_lookup.lookup_pyramid_grouped4(
                levels, c, dims, n_act)
        if impl == "pallas":
            return lambda c: corr_lookup.lookup_pyramid_l0(levels[0], c, dims)
        if impl == "pallas_grouped":
            return corr.CorrPyramidPallas(levels, grouped=True).nhwc
        cp = corr.CorrPyramid(levels)
        return lambda c: cp(c).permute(0, 2, 3, 1)

    def _shards(self, plan: dba.DBAPlan):
        """The round's edge shards: shard s owns active slots [s Ea/n,
        (s+1) Ea/n) and inactive slots [s Ei/n, (s+1) Ei/n) of the global
        edge buffers.  One shard holds the whole plan and the buffers
        themselves."""
        cfg, st, ed = self.cfg, self.state, self.edges
        Ea, Ei, n = cfg.e_active, cfg.e_inactive, cfg.edge_shards
        ea, ei = Ea // n, Ei // n
        shards = []
        for s, dev in enumerate(self.shard_devices):
            act, ina = slice(s * ea, (s + 1) * ea), slice(s * ei, (s + 1) * ei)
            sp = plan if n == 1 else shard_plan(plan, torch.cat([
                torch.arange(act.start, act.stop, device=self.device),
                Ea + torch.arange(ina.start, ina.stop, device=self.device)]),
                dev)
            net = self._nets[dev]
            shards.append(_Shard(
                net=net, act=act, plan=sp,
                levels=[lv[act].to(dev) for lv in ed.corr_levels],
                in_flow=self.inactive.flow[ina].to(dev),
                in_weight=self.inactive.flow_weight[ina].to(dev),
                gates=net.update_precompute(
                    st.cst_contexts[plan.ii[act]].to(dev))))
        return shards

    def _gather(self, parts) -> torch.Tensor:
        """The shards' slices of a per-edge tensor, as one tensor on the
        tracker's device."""
        if len(parts) == 1:
            return parts[0]
        return torch.cat([x.to(self.device) for x in parts], 0)

    def _edge_shards(self, c: dict, shards):
        """Each shard's DBA edges: its flows ++ its inactive flows."""
        return [dba.EdgeShard(sh.plan, torch.cat([f, sh.in_flow], 0),
                              torch.cat([w, sh.in_weight], 0))
                for sh, f, w in zip(shards, c["flow"], c["flow_w"])]

    def _iterate(self, n: int, c: dict, plan: dba.DBAPlan, shards):
        """n GRU + DBA iterations over the active slots, updating the
        carry ``c`` (poses, disps and damping, and per shard hidden, flow
        and flow_w).  Per shard: projective transform, lookup (the gated
        kernel with the shard's own active count), ConvGRU; then the GRU
        pool and the DBA's edge sums across shards, the solve once."""
        cfg, st = self.cfg, self.state
        ea = cfg.e_active // cfg.edge_shards
        K = plan.kx.shape[0]
        sens_k = st.idepths_sensed[plan.kx]
        ons = [sh.plan.edge_valid[:ea][:, None, None, None] > 0
               for sh in shards]
        segs = [torch.where(on[:, 0, 0, 0], sh.plan.kk[:ea], -1)
                for sh, on in zip(shards, ons)]
        lookups = [self._lookup(sh.levels,
                                on.sum().to(torch.int32).reshape(1))
                   for sh, on in zip(shards, ons)]
        for _ in range(n):
            with runtime.span("track.iter"):
                hiddens = []
                for s, sh in enumerate(shards):
                    dev = sh.plan.ii.device
                    coords1, _, _ = camera.projective_transform(
                        c["poses"].to(dev), c["disps"].to(dev),
                        st.intrinsics.to(dev), sh.plan.ii[:ea],
                        sh.plan.jj[:ea], stereo_rel=None if self._rig is None
                        else self._rig.to(dev))
                    flow = c["flow"][s]
                    motion = torch.cat([coords1 - self._coords0.to(dev),
                                        flow - coords1], -1).clamp(-64.0, 64.0)
                    cvals = lookups[s](coords1.contiguous()).to(torch.bfloat16)
                    hidden2, delta, weight = sh.net.update(
                        c["hidden"][s], None, cvals, motion.to(torch.bfloat16),
                        gates_inp=sh.gates)
                    on = ons[s]
                    c["flow"][s] = torch.where(on, coords1 + delta, flow)
                    c["flow_w"][s] = torch.where(on, weight, c["flow_w"][s])
                    c["hidden"][s] = torch.where(on, hidden2, c["hidden"][s])
                    hiddens.append(hidden2)
                eta = self.net.eta(hiddens, segs, K)
                c["damping"] = dba.kx_scatter(c["damping"], plan.kx,
                                              plan.k_valid, eta)
                eta_k = cfg.damping_scale * c["damping"][plan.kx] \
                    + cfg.damping_offset
                edges = self._edge_shards(c, shards)
                with runtime.span("track.dba"):
                    c["poses"], c["disps"] = dba.dba_iterations(
                        c["poses"], c["disps"], st.intrinsics,
                        edges[0].targets, edges[0].weights, eta_k, sens_k,
                        plan, iters=cfg.gn_iters, ep=cfg.ep, lm=cfg.lm,
                        stereo_rel=self._rig,
                        shards=edges if len(edges) > 1 else None)

    def _commit_light(self, c: dict):
        st, ed = self.state, self.edges
        st.cam_T_world, st.idepths, st.damping = \
            c["poses"], c["disps"], c["damping"]
        ed.hidden, ed.flow, ed.flow_weight = (
            self._gather(c[k]) for k in ("hidden", "flow", "flow_w"))

    def _export(self, c: dict, plan: dba.DBAPlan, shards, seed_next: int):
        """Accepting update's tail: covariances (unless
        ``cfg.compute_covariances`` is off; from the system reduced over
        the shards), flow RMS (its sums reduced over the shards), convex
        upsampling of idepths and depth covariances (the upmask pooled
        over the shards), next-kf seeding."""
        cfg, st = self.cfg, self.state
        h, w = self.h, self.w
        K, B = plan.kx.shape[0], cfg.buffer
        poses, disps = c["poses"], c["disps"]
        edges = self._edge_shards(c, shards)
        if cfg.compute_covariances:
            eta_k = cfg.damping_scale * c["damping"][plan.kx] \
                + cfg.damping_offset
            sens_k = st.idepths_sensed[plan.kx]
            with runtime.span("track.cov"):
                (Hd, vd, Ehat, C, wv), blocks = dba.sharded_system(
                    poses, disps, st.intrinsics, edges, plan, eta_k, sens_k,
                    self._rig)
                eb = (blocks[2] if cfg.schur_impl == "sparse"
                      and len(edges) == 1 else None)
                _, _, L, Q = dba.solve_system(Hd, vd, Ehat, C, wv, plan,
                                              cfg.ep, cfg.lm, E_blocks=eb)
                pose_cov_p, z_cov = dba.covariances(L, Ehat, Q, plan)
            z_cov = z_cov.reshape(K, h, w)
        else:
            pose_cov_p = 1e-4 * torch.eye(6, device=self.device).repeat(
                plan.px.shape[0], 1, 1)
            z_cov = torch.ones((K, h, w), device=self.device)

        sums = []
        for e in edges:
            dev = e.plan.ii.device
            coords1, valid, _ = camera.projective_transform(
                poses.to(dev), disps.to(dev), st.intrinsics.to(dev),
                e.plan.ii, e.plan.jj,
                stereo_rel=None if self._rig is None else self._rig.to(dev))
            r = (e.targets - coords1) * valid \
                * e.plan.edge_valid[:, None, None, None]
            sums.append(((r * r).sum(), valid.sum() * 2.0))
        num, den = reduce_in_order(sums, self.device)
        self.last_flow_rms = torch.sqrt(num / torch.clamp(den, min=1.0))

        self._commit_light(c)
        px_safe = torch.where(plan.p_valid > 0, plan.px, B)
        pc = torch.cat([st.pose_cov, st.pose_cov[:1]], 0)
        pc[px_safe] = pose_cov_p[:, _GTSAM_PERM][:, :, _GTSAM_PERM]
        st.pose_cov = pc[:B]
        st.idepths_cov = dba.kx_scatter(st.idepths_cov, plan.kx,
                                        plan.k_valid, z_cov)
        depths_cov_k = z_cov / torch.clamp(disps[plan.kx], min=1e-3) ** 4
        st.depths_cov = dba.kx_scatter(st.depths_cov, plan.kx, plan.k_valid,
                                       depths_cov_k)
        ea = cfg.e_active // cfg.edge_shards
        _, upmask = self.net.aggregate(c["hidden"], [
            torch.where(e.plan.edge_valid[:ea] > 0, e.plan.kk[:ea], -1)
            for e in edges], K)
        um = upmask.permute(0, 3, 1, 2).reshape(K, 576, h, w)
        st.idepths_up = dba.kx_scatter(
            st.idepths_up, plan.kx, plan.k_valid,
            upsample.upsample_disp(disps[plan.kx], um))
        st.depths_cov_up = dba.kx_scatter(
            st.depths_cov_up, plan.kx, plan.k_valid,
            upsample.upsample_disp(depths_cov_k, um, pow=1.0))
        if seed_next >= 0:
            # next-keyframe seeding (visual_frontend.py:620-635)
            src = min(max(seed_next - 1, 0), B - 1)
            st.cam_T_world[seed_next] = st.cam_T_world[src]
            st.pose_cov[seed_next] = st.pose_cov[src]
            st.idepths[seed_next] = st.idepths[src].mean()
            st.idepths_cov[seed_next] = st.idepths_cov[src]
            st.depths_cov[seed_next] = st.depths_cov[src]
            st.intrinsics[seed_next] = st.intrinsics[src]

    def update(self, n_iters: int, use_inactive: bool = True,
               kf_dist_pair: Optional[Tuple[int, int]] = None,
               seed_next: int = -1, two_phase: bool = False,
               n_iters2: int = 0,
               seed_sensed_slot: int = -1) -> Optional[bool]:
        """One update round: pending maintenance, ``n_iters`` iterations,
        then the export tail.  ``two_phase``: after ``n_iters`` the
        keyframe distance of ``kf_dist_pair`` decides -- below
        cfg.keyframe_thresh the round stops there (returns False), else it
        runs ``n_iters2`` more and exports (returns True).
        ``seed_sensed_slot``: the keyframe whose inverse depths start from
        its sensed ones where it has them (-1: none).  None: empty graph,
        nothing ran."""
        cfg, g, st = self.cfg, self.graph, self.state
        if g.n_edges == 0:
            return None
        with runtime.span("track.graph"):
            kf0 = max(0, int(g.ii.min()))
            kf1 = max(int(g.ii.max()), int(g.jj.max())) + 1
            self._flush_pending()
            plan = self._plan(use_inactive, kf0, kf1)
            shards = self._shards(plan)
        ed = self.edges
        disps = st.idepths
        if seed_sensed_slot >= 0:
            sensed = st.idepths_sensed[seed_sensed_slot]
            disps = disps.clone()
            disps[seed_sensed_slot] = torch.where(
                sensed > 0, sensed, disps[seed_sensed_slot])

        def split(x):
            return [x[sh.act].to(sh.plan.ii.device) for sh in shards]

        c = {"poses": st.cam_T_world, "disps": disps,
             "hidden": split(ed.hidden), "flow": split(ed.flow),
             "flow_w": split(ed.flow_weight), "damping": st.damping}
        self._iterate(n_iters, c, plan, shards)
        g.age += n_iters
        da, db = kf_dist_pair if kf_dist_pair is not None else (0, 0)
        with runtime.span("track.kf_dist"):
            kf_dist = camera.frame_distance_bidirectional(
                c["poses"], c["disps"], st.intrinsics,
                torch.tensor([da], device=self.device),
                torch.tensor([db], device=self.device), cfg.beta)[0]
            self.last_kf_dist = kf_dist
            close = two_phase and float(kf_dist) < cfg.keyframe_thresh
        if close:
            self._commit_light(c)
            return False
        if two_phase:
            self._iterate(n_iters2, c, plan, shards)
        with runtime.span("track.export"):
            self._export(c, plan, shards, seed_next)
        self.viz_idx[kf0:self.kf_idx + 1] = True
        return True

    def has_enough_motion(self, feat_cur: torch.Tensor) -> bool:
        """Whether the frame with features ``feat_cur`` (h, w, 128) moved
        more than ``cfg.motion_filter_thresh`` from the last keyframe."""
        return float(self._motion_mag(feat_cur, self.last_kf_idx)) \
            > self.cfg.motion_filter_thresh

    # ------------------------------------------------------------------
    # the state machine
    # ------------------------------------------------------------------
    def __call__(self, k: int, batch: Dict[str, Any]):
        """Process frame k.  batch: images (H, W, 3) uint8, intrinsics
        (4,), optional poses (4, 4), depths (H, W), t_cams,
        is_last_frame.  Returns a viz packet dict or None."""
        with runtime.span("track.frame", k=k, session=self.session):
            return self._track(k, batch)

    def _track(self, k: int, batch: Dict[str, Any]):
        cfg = self.cfg
        if cfg.rgbd and batch.get("depths") is not None \
                and batch.get("idepths_sensed") is None:
            # sensed inverse depths at feature resolution (a pixel of each
            # dsf x dsf block; 0 where the sensor saw nothing)
            d = np.asarray(batch["depths"], np.float32)[
                cfg.dsf // 2::cfg.dsf, cfg.dsf // 2::cfg.dsf]
            batch = dict(batch)
            batch["idepths_sensed"] = np.where(
                d > 1e-3, 1.0 / np.maximum(d, 1e-3), 0.0)
        if self.last_k is None:
            assert k == 0 and self.kf_idx == 0
            with runtime.span("track.ingest"):
                self._ingest(k, 0, batch, with_motion=False)
            self.last_k = k
            self.last_kf_idx = 0
            self.kf_idx_to_f_idx[0] = k
            self.f_idx_to_kf_idx[k] = 0
            out = self.get_viz_out(batch)
            self.kf_idx = 1
            return out

        assert self.kf_idx < cfg.buffer
        with_motion = cfg.motion_filter_thresh >= 0
        with runtime.span("track.ingest"):
            mag = self._ingest(k, self.kf_idx, batch, with_motion)
        if with_motion:
            self.last_motion_mag = mag
            if not self.last_motion_mag > cfg.motion_filter_thresh:
                if batch.get("is_last_frame"):
                    self.kf_idx -= 1
                    self.terminate()
                    return self.get_viz_out(batch)
                return None

        self.kf_idx_to_f_idx[self.kf_idx] = k
        self.f_idx_to_kf_idx[k] = self.kf_idx
        if not self.is_initialized:
            if self.kf_idx >= cfg.keyframe_warmup:
                self._initialize()
        elif not self._update_keyframe():
            with runtime.span("track.graph"):
                self.rm_keyframe(self.kf_idx - 1)
            if batch.get("is_last_frame"):
                # the sequence ends on a rejected keyframe: the newest
                # keyframe now sits in slot kf_idx - 1 (the JAX tracker
                # returns None here and never terminates)
                self.kf_idx -= 1
                self.terminate()
                return self.get_viz_out(batch)
            return None

        self.last_k = k
        self.last_kf_idx = self.kf_idx
        out = self.get_viz_out(batch)
        if self.kf_idx + 1 >= cfg.buffer or batch.get("is_last_frame"):
            # buffer-full ends the sequence for every downstream consumer
            self.terminate()
            final = dict(batch)
            final["is_last_frame"] = True
            return self.get_viz_out(final) or out
        self.kf_idx += 1
        return out

    def _initialize(self):
        cfg, B = self.cfg, self.cfg.buffer
        with runtime.span("track.graph"):
            self.add_neighborhood_factors(0, self.kf_idx, radius=3)
        self.update(n_iters=8)
        with runtime.span("track.graph"):
            self.add_proximity_factors(0, 0, rad=2, nms=2,
                                       thresh=cfg.frontend_thresh,
                                       remove=False)
        self.update(n_iters=8)
        st, kf, nxt = self.state, self.kf_idx, self.kf_idx + 1
        if nxt < B:
            st.cam_T_world[nxt] = st.cam_T_world[kf]
            st.idepths[nxt] = st.idepths[kf - 3:kf + 1].mean()
            st.idepths_cov[nxt] = st.idepths_cov[kf - 3:kf + 1].mean()
            st.depths_cov[nxt] = st.depths_cov[kf - 3:kf + 1].mean()
            st.intrinsics[nxt] = st.intrinsics[kf]
        self.is_initialized = True
        self.viz_idx[:kf + 1] = True
        with runtime.span("track.graph"):
            self.rm_factors(self.graph.ii < (cfg.keyframe_warmup - 4),
                            store=True)

    def _update_keyframe(self) -> bool:
        """The per-keyframe round (visual_frontend.py:596-640); False when
        the new keyframe is rejected as too close to the previous one."""
        cfg = self.cfg
        with runtime.span("track.graph"):
            if self.graph.n_edges:
                self.rm_factors(self.graph.age > cfg.max_age, store=True)
            self.add_proximity_factors(
                kf0=self.kf_idx - 4,
                kf1=max(self.kf_idx + 1 - cfg.frontend_window, 0),
                rad=cfg.frontend_radius, nms=cfg.frontend_nms,
                thresh=cfg.frontend_thresh, remove=True)
        nxt = self.kf_idx + 1
        seed_next = nxt if nxt < cfg.buffer else -1
        if cfg.keyframe_thresh >= 0:
            ran = self.update(n_iters=cfg.iters1, n_iters2=cfg.iters2,
                              two_phase=True, seed_next=seed_next,
                              seed_sensed_slot=self.kf_idx,
                              kf_dist_pair=(self.kf_idx - 2,
                                            self.kf_idx - 1))
            if ran is False:
                return False
            if ran:
                self.graph.age += cfg.iters2
        else:
            self.update(n_iters=cfg.iters1 + cfg.iters2, seed_next=seed_next,
                        seed_sensed_slot=self.kf_idx)
        return True

    # ------------------------------------------------------------------
    # the backend: global bundle adjustment
    # ------------------------------------------------------------------
    @staticmethod
    def _normalize_map(poses, disps, n_kf: int):
        """Rescale the first ``n_kf`` keyframes so their mean inverse depth
        is 1 (visual_frontend.py:1302-1307); a pure gauge change."""
        s = disps[:n_kf].mean()
        disps, poses = disps.clone(), poses.clone()
        disps[:n_kf] /= s
        poses[:n_kf, :3] *= s
        return poses, disps

    @staticmethod
    def _feature_pyramid(features):
        """(B, h, w, 128) -> 4 pooled bf16 levels (B, 128, h_l, w_l); a
        level that cannot halve any more repeats (tiny images)."""
        pyr = [features.permute(0, 3, 1, 2).float()]
        for _ in range(3):
            prev = pyr[-1]
            pyr.append(corr.avg_pool2(prev) if min(prev.shape[-2:]) >= 2
                       else prev)
        return [p.to(torch.bfloat16) for p in pyr]

    def _gba_chunk(self, pyramid, hidden, ctx_inp, coords1, flow, flow_w,
                   ii_c, jj_c, valid_c, seg_c, n_seg: int):
        """One GRU pass over a chunk of backend edges with on-the-fly
        correlation (update_lowmem's inner loop,
        visual_frontend.py:488-514)."""
        # the source features are always level 0 (AltCorrBlock)
        f1 = pyramid[0][ii_c]
        cvals = torch.cat([
            corr.alt_corr_level(f1, fmaps[jj_c], coords1 / (2 ** lvl),
                                radius=3, chunk=max(1, ii_c.shape[0] // 4))
            for lvl, fmaps in enumerate(pyramid)], dim=1).permute(0, 2, 3, 1)
        motion = torch.cat([coords1 - self._coords0, flow - coords1],
                           -1).clamp(-64.0, 64.0)
        hidden2, delta, weight, eta = self.net.update(
            hidden, ctx_inp, cvals.to(torch.bfloat16),
            motion.to(torch.bfloat16), seg_c, n_seg, False)
        on = valid_c[:, None, None, None] > 0
        return (torch.where(on, hidden2, hidden),
                torch.where(on, coords1 + delta, flow),
                torch.where(on, weight, flow_w), eta)

    def _map_consistency(self) -> float:
        """Map health without ground truth: the mean multi-view
        depth-consistency count over the keyframes (depth_filter).  The
        threshold follows the map's depth gauge, so the score compares
        across the global-BA rescale.  Only the kf_idx + 1 live keyframes
        are passed, so unused buffer slots never count as neighbours."""
        n, st = self.kf_idx + 1, self.state
        med_z = 1.0 / torch.clamp(torch.median(st.idepths[:n]), min=1e-6)
        counts = camera.depth_filter(
            st.cam_T_world[:n], st.idepths[:n], st.intrinsics[:n],
            torch.arange(n, device=self.device), 0.1 * med_z)
        return float(counts.mean())

    def global_ba(self, steps: int = 12, chunk: int = 32,
                  thresh: Optional[float] = None):
        """Full-map bundle adjustment (backend(), visual_frontend.py:
        1255-1295): a denser graph from the backend's thresholds, then
        ``steps`` rounds of chunked GRU flow refinement (on-the-fly
        correlation) and DBA over all keyframes.

        Guarded: long-range backend edges can lie outside what the GRU was
        trained on, and the refinement then diverges.  The map's depth
        consistency is scored before and after, and a run that lowers it
        is rolled back."""
        cfg, kf, dev = self.cfg, self.kf_idx, self.device
        if kf < 2 or steps <= 0:
            return
        self._flush_pending()
        st = self.state
        if float(st.idepths_sensed[:kf].max()) <= 0:
            st.cam_T_world, st.idepths = self._normalize_map(
                st.cam_T_world, st.idepths, kf + 1)
        # rollback snapshot, taken after the (always safe) rescale
        snap_poses, snap_disps = st.cam_T_world, st.idepths
        score0 = self._map_consistency()

        t = kf + 1
        ii_g, jj_g = np.meshgrid(np.arange(t), np.arange(t), indexing="ij")
        d = self.distance(ii_g.ravel(), jj_g.ravel())
        ii, jj = graphlib.proximity_edges(
            graphlib.CovisibilityGraph(max_factors=16 * kf), d, kf, 0, 0,
            2, 3, thresh or 22.0, 16 * kf)
        n_e = ii.shape[0]
        if n_e == 0:
            return
        E_g = -(-n_e // chunk) * chunk
        ii_p, jj_p = np.zeros(E_g, np.int64), np.zeros(E_g, np.int64)
        valid = np.arange(E_g) < n_e
        ii_p[:n_e], jj_p[:n_e] = ii, jj
        plan = self._slot_aligned_plan(ii_p, jj_p, valid, 0, t)
        K = plan.kx.shape[0]
        seg = torch.where(plan.edge_valid > 0, plan.kk, -1)
        on = plan.edge_valid

        pyramid = self._feature_pyramid(st.features)
        hidden = st.contexts[plan.ii].to(self.net.dtype)
        ctx = st.cst_contexts[plan.ii]
        flow, _, _ = camera.projective_transform(
            st.cam_T_world, st.idepths, st.intrinsics, plan.ii, plan.jj)
        flow_w = torch.zeros_like(flow)
        eta_buf = torch.full((cfg.buffer, self.h, self.w), 1e-6, device=dev)
        sens_k = st.idepths_sensed[plan.kx]
        for _ in range(steps):
            coords1, _, _ = camera.projective_transform(
                st.cam_T_world, st.idepths, st.intrinsics, plan.ii, plan.jj)
            for c0 in range(0, E_g, chunk):
                sl = slice(c0, c0 + chunk)
                hidden[sl], flow[sl], flow_w[sl], eta_c = self._gba_chunk(
                    pyramid, hidden[sl], ctx[sl], coords1[sl], flow[sl],
                    flow_w[sl], plan.ii[sl], plan.jj[sl], on[sl], seg[sl], K)
                eta_buf = dba.kx_scatter(eta_buf, plan.kx, plan.k_valid,
                                         eta_c)
            eta_k = cfg.damping_scale * eta_buf[plan.kx] + cfg.damping_offset
            st.cam_T_world, st.idepths = dba.dba_iterations(
                st.cam_T_world, st.idepths, st.intrinsics, flow, flow_w,
                eta_k, sens_k, plan, iters=2, ep=1e-2, lm=1e-5)
        score1 = self._map_consistency()
        self.last_gba_scores = (score0, score1)
        if score1 < score0:
            # the refinement hurt the map: back to the snapshot
            st.cam_T_world, st.idepths = snap_poses, snap_disps
        self.viz_idx[:kf + 1] = True

    def terminate(self):
        """End of sequence: optional global BA (two runs, as the
        reference's backend), then flag the whole map for a final viz
        packet (visual_frontend.py:1309-1335)."""
        if self.cfg.global_ba:
            self.global_ba(7)
            self.global_ba(12)
        self.viz_idx[:self.kf_idx + 1] = True
        self.stop = True

    def stop_condition(self) -> bool:
        return self.stop

    _PACKET_FIELDS = ("cam0_poses", "gt_poses", "gt_depths", "world_T_body",
                      "world_T_body_cov", "cam0_idepths", "cam0_idepths_up",
                      "cam0_idepths_sensed", "cam0_idepths_cov",
                      "cam0_depths_cov", "cam0_depths_cov_up", "cam0_images",
                      "cam0_intrinsics")

    def get_viz_out(self, batch) -> Optional[Dict[str, Any]]:
        """Viz packet (visual_frontend.py:1337-1391 contract).  Fields are
        device tensors padded to 16 (or buffer) rows by repeating the last
        selected keyframe; consumers slice with ``viz_count``."""
        with runtime.span("track.viz_out"):
            idx = np.nonzero(self.viz_idx)[0]
            if idx.size == 0:
                if batch.get("is_last_frame"):
                    return {"is_last_frame": True}
                return None
            V = 16 if idx.size <= 16 else self.cfg.buffer
            sel = np.full(V, idx[-1], np.int64)
            sel[:idx.size] = idx[:V]
            idx = idx[:V]
            st = self.state
            s = torch.as_tensor(sel, device=self.device)
            poses = st.cam_T_world[s]
            values = (poses, st.gt_poses[s], st.gt_depths[s],
                      se3.inv(poses), st.pose_cov[s], st.idepths[s],
                      st.idepths_up[s], st.idepths_sensed[s],
                      st.idepths_cov[s], st.depths_cov[s],
                      st.depths_cov_up[s], st.images[s], st.intrinsics[s])
            out = dict(zip(self._PACKET_FIELDS, values))
            out.update({
                "viz_idx": idx,
                "viz_count": int(idx.size),
                "kf_idx": self.kf_idx,
                "kf_idx_to_f_idx": dict(self.kf_idx_to_f_idx),
                "is_last_frame": bool(batch.get("is_last_frame", False)),
            })
            self.viz_idx[:] = False
            return out
