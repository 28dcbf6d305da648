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
     lookup kernel (n_act-gated), ConvGRU, dense BA -- then the keyframe
     distance decides: reject (roll the buffers down) or run iters2 more
     iterations and the export tail (covariances, flow RMS, convex
     upsampling, next-keyframe seeding).

The JAX package fuses these steps into single jitted programs to save
round trips to a remote TPU; this port runs them eagerly, in the same
order, and syncs to the host where a decision needs a value.
"""
from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..geometry import camera, se3, upsample
from ..models import DroidNet
from ..ops import corr, corr_lookup
from ..solver import dba
from . import graph as graphlib


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

    def permute(self, idx: torch.Tensor) -> None:
        for f in fields(self):
            setattr(self, f.name, getattr(self, f.name)[idx])


@dataclass
class EdgeState:
    """Per-active-edge device buffers (Ea = cfg.e_active)."""
    hidden: torch.Tensor          # (Ea, h, w, 128) GRU hidden (net dtype)
    flow: torch.Tensor            # (Ea, h, w, 2) fp32 GRU flow targets
    flow_weight: torch.Tensor     # (Ea, h, w, 2) fp32
    corr_levels: list             # 4 x (Ea, h, w, h_l padded to 8, w_l) bf16


@dataclass
class InactiveState:
    flow: torch.Tensor            # (Ei, h, w, 2)
    flow_weight: torch.Tensor     # (Ei, h, w, 2)


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
        self.cfg = cfg
        self.device = torch.device(device)
        # tracking is inference only: no autograd graphs anywhere
        self.net = net.to(self.device).eval().requires_grad_(False)
        self.H, self.W = image_size
        self.h, self.w = self.H // cfg.dsf, self.W // cfg.dsf
        self.world_T_cam0_t0 = (np.eye(4, dtype=np.float32)
                                if world_T_cam0_t0 is None
                                else np.asarray(world_T_cam0_t0))
        self._coords0 = camera.coords_grid(self.h, self.w,
                                           device=self.device)
        self._mean = torch.tensor(_MEAN, device=self.device)
        self._std = torch.tensor(_STD, device=self.device)
        self.reset()

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------
    def reset(self):
        """Fresh tracking state on the same instance."""
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
            cst_contexts=full((B, h, w, 128), 0.0, bf16))
        levels, hl, wl = [], h, w
        for _ in range(4):
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
        levels = [lv.to(torch.bfloat16).contiguous() for lv in
                  corr.build_pyramid(corr.build_volume(f1, f2))]
        cvals = corr_lookup.lookup_pyramid(levels, self._coords0[None]
                                           .contiguous())
        _, delta, _ = self.net.update(st.contexts[last_kf][None],
                                      st.cst_contexts[last_kf][None],
                                      cvals.to(torch.bfloat16))
        return torch.linalg.norm(delta, dim=-1).mean()

    def _ingest(self, k: int, slot: int, batch: Dict[str, Any],
                with_motion: bool) -> Optional[torch.Tensor]:
        """Encode frame k, compute its motion magnitude against the last
        keyframe (before the store), and store it into ``slot``.  A slot
        whose frame is then rejected simply holds a candidate that the
        next frame overwrites."""
        dev, st, cfg = self.device, self.state, self.cfg
        img = torch.as_tensor(np.ascontiguousarray(
            np.asarray(batch["images"])[..., :3]), device=dev)
        image_norm = self._normalize(img)
        f = self.net.features(image_norm)[0]
        c, ci = self.net.context(image_norm)
        mag = self._motion_mag(f, self.last_kf_idx) if with_motion else None
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
                st.cam_T_world, st.idepths, st.intrinsics, ii, jj)
            hidden[pos] = st.contexts[ii].to(hidden.dtype)
            flow[pos] = target
            flow_w[pos] = 0.0
            f = st.features.permute(0, 3, 1, 2)
            for lv, nl in zip(levels, corr.build_pyramid_bf16(
                    f[ii], f[jj], 4, pad_rows_to=8)):
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
        ii, jj = graphlib.neighborhood_edges(kf0, kf1, radius)
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
            self.cfg.max_factors)
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
        Ea, Ei, P, K = cfg.e_active, cfg.e_inactive, cfg.p_window, \
            cfg.k_depth
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
        return dba.plan_from_numpy({
            "ii": np.where(valid, ii_all, 0), "jj": np.where(valid, jj_all, 0),
            "pi": np.where(valid & (ii_all >= kf0) & (ii_all < kf1),
                           ii_all - kf0, -1),
            "pj": np.where(valid & (jj_all >= kf0) & (jj_all < kf1),
                           jj_all - kf0, -1),
            "kk": np.array([kmap.get(int(i), -1) if v else -1
                            for i, v in zip(ii_all, valid)], np.int64),
            "edge_valid": valid, "px": np.clip(px, 0, cfg.buffer - 1),
            "p_valid": px < kf1, "p_fixed": p_fixed, "kx": kx,
            "k_valid": k_valid}, self.device)

    def _iterate(self, n: int, c: dict, plan: dba.DBAPlan, gates_inp):
        """n GRU + DBA iterations over the active slots, updating the
        carry ``c`` (poses, disps, hidden, flow, flow_w, damping)."""
        cfg, st, Ea = self.cfg, self.state, self.cfg.e_active
        ii, jj = plan.ii[:Ea], plan.jj[:Ea]
        on = plan.edge_valid[:Ea][:, None, None, None] > 0
        seg = torch.where(on[:, 0, 0, 0], plan.kk[:Ea], -1)
        K = plan.kx.shape[0]
        # active edges occupy the slot prefix; the kernel reads the count
        # from device memory and zero-fills the padded slots
        n_act = on.sum().to(torch.int32).reshape(1)
        dims = corr_lookup.pyramid_dims(self.h, self.w)
        sens_k = st.idepths_sensed[plan.kx]
        for _ in range(n):
            coords1, _, _ = camera.projective_transform(
                c["poses"], c["disps"], st.intrinsics, ii, jj)
            motion = torch.cat([coords1 - self._coords0,
                                c["flow"] - coords1], -1).clamp(-64.0, 64.0)
            cvals = corr_lookup.lookup_pyramid_grouped4(
                self.edges.corr_levels, coords1.contiguous(), dims, n_act)
            hidden2, delta, weight, eta = self.net.update(
                c["hidden"], None, cvals, motion.to(torch.bfloat16), seg, K,
                False, gates_inp)
            c["flow"] = torch.where(on, coords1 + delta, c["flow"])
            c["flow_w"] = torch.where(on, weight, c["flow_w"])
            c["hidden"] = torch.where(on, hidden2, c["hidden"])
            c["damping"] = dba.kx_scatter(c["damping"], plan.kx,
                                          plan.k_valid, eta)
            targets = torch.cat([c["flow"], self.inactive.flow], 0)
            weights = torch.cat([c["flow_w"], self.inactive.flow_weight], 0)
            eta_k = cfg.damping_scale * c["damping"][plan.kx] \
                + cfg.damping_offset
            c["poses"], c["disps"] = dba.dba_iterations(
                c["poses"], c["disps"], st.intrinsics, targets, weights,
                eta_k, sens_k, plan, iters=cfg.gn_iters, ep=cfg.ep,
                lm=cfg.lm)

    def _commit_light(self, c: dict):
        st, ed = self.state, self.edges
        st.cam_T_world, st.idepths, st.damping = \
            c["poses"], c["disps"], c["damping"]
        ed.hidden, ed.flow, ed.flow_weight = \
            c["hidden"], c["flow"], c["flow_w"]

    def _export(self, c: dict, plan: dba.DBAPlan, seed_next: int):
        """Accepting update's tail: covariances, flow RMS, convex
        upsampling of idepths and depth covariances, next-kf seeding."""
        cfg, st = self.cfg, self.state
        h, w = self.h, self.w
        K, B = plan.kx.shape[0], cfg.buffer
        poses, disps = c["poses"], c["disps"]
        targets = torch.cat([c["flow"], self.inactive.flow], 0)
        weights = torch.cat([c["flow_w"], self.inactive.flow_weight], 0)
        eta_k = cfg.damping_scale * c["damping"][plan.kx] + cfg.damping_offset
        sens_k = st.idepths_sensed[plan.kx]
        blocks = dba.linearize(poses, disps, st.intrinsics, targets, weights,
                               plan)
        Hd, vd, Ehat, C, wv = dba.assemble(blocks, plan, disps, eta_k, sens_k)
        _, _, L, Q = dba.solve_system(Hd, vd, Ehat, C, wv, plan, cfg.ep,
                                      cfg.lm)
        pose_cov_p, z_cov = dba.covariances(L, Ehat, Q, plan)
        z_cov = z_cov.reshape(K, h, w)

        coords1, valid, _ = camera.projective_transform(
            poses, disps, st.intrinsics, plan.ii, plan.jj)
        r = (targets - coords1) * valid * plan.edge_valid[:, None, None, None]
        self.last_flow_rms = torch.sqrt(
            (r * r).sum() / torch.clamp(valid.sum() * 2.0, min=1.0))

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
        seg = torch.where(plan.edge_valid[:cfg.e_active] > 0,
                          plan.kk[:cfg.e_active], -1)
        _, upmask = self.net.aggregate(c["hidden"], seg, K)
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
               n_iters2: int = 0) -> Optional[bool]:
        """One update round: pending maintenance, ``n_iters`` iterations,
        then the export tail.  ``two_phase``: after ``n_iters`` the
        keyframe distance of ``kf_dist_pair`` decides -- below
        cfg.keyframe_thresh the round stops there (returns False), else it
        runs ``n_iters2`` more and exports (returns True).  None: empty
        graph, nothing ran."""
        cfg, g, st, ed = self.cfg, self.graph, self.state, self.edges
        if g.n_edges == 0:
            return None
        kf0 = max(0, int(g.ii.min()))
        kf1 = max(int(g.ii.max()), int(g.jj.max())) + 1
        self._flush_pending()
        ed = self.edges
        plan = self._plan(use_inactive, kf0, kf1)
        gates_inp = self.net.update_precompute(
            st.cst_contexts[plan.ii[:cfg.e_active]])
        c = {"poses": st.cam_T_world, "disps": st.idepths,
             "hidden": ed.hidden, "flow": ed.flow, "flow_w": ed.flow_weight,
             "damping": st.damping}
        self._iterate(n_iters, c, plan, gates_inp)
        g.age += n_iters
        da, db = kf_dist_pair if kf_dist_pair is not None else (0, 0)
        kf_dist = camera.frame_distance_bidirectional(
            c["poses"], c["disps"], st.intrinsics,
            torch.tensor([da], device=self.device),
            torch.tensor([db], device=self.device), cfg.beta)[0]
        self.last_kf_dist = kf_dist
        if two_phase:
            if float(kf_dist) < cfg.keyframe_thresh:
                self._commit_light(c)
                return False
            self._iterate(n_iters2, c, plan, gates_inp)
        self._export(c, plan, seed_next)
        self.viz_idx[kf0:self.kf_idx + 1] = True
        return True

    # ------------------------------------------------------------------
    # the state machine
    # ------------------------------------------------------------------
    def __call__(self, k: int, batch: Dict[str, Any]):
        """Process frame k.  batch: images (H, W, 3) uint8, intrinsics
        (4,), optional poses (4, 4), depths (H, W), t_cams,
        is_last_frame.  Returns a viz packet dict or None."""
        cfg = self.cfg
        if self.last_k is None:
            assert k == 0 and self.kf_idx == 0
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
        mag = self._ingest(k, self.kf_idx, batch, with_motion)
        if with_motion:
            self.last_motion_mag = float(mag)
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
            self.rm_keyframe(self.kf_idx - 1)
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
        self.add_neighborhood_factors(0, self.kf_idx, radius=3)
        self.update(n_iters=8)
        self.add_proximity_factors(0, 0, rad=2, nms=2,
                                   thresh=cfg.frontend_thresh, remove=False)
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
        self.rm_factors(self.graph.ii < (cfg.keyframe_warmup - 4),
                        store=True)

    def _update_keyframe(self) -> bool:
        """The per-keyframe round (visual_frontend.py:596-640); False when
        the new keyframe is rejected as too close to the previous one."""
        cfg = self.cfg
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
                              kf_dist_pair=(self.kf_idx - 2,
                                            self.kf_idx - 1))
            if ran is False:
                return False
            if ran:
                self.graph.age += cfg.iters2
        else:
            self.update(n_iters=cfg.iters1 + cfg.iters2, seed_next=seed_next)
        return True

    def terminate(self):
        """End of sequence: flag the whole map for a final viz packet."""
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
        values = (poses, st.gt_poses[s], st.gt_depths[s], se3.inv(poses),
                  st.pose_cov[s], st.idepths[s], st.idepths_up[s],
                  st.idepths_sensed[s], st.idepths_cov[s], st.depths_cov[s],
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
