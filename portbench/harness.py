"""One run of one cell: set-up, the measured window, the traced reading.

The window drives the port's pipeline as ``cli/slam_demo.py:run`` wires
it: ``run_parallel`` over a source stage of the benchmark's own, then
``SlamModule`` over the tracker and ``FusionModule`` over the map, with
the ``EvalSink``.  The source feeds a closed loop with one frame
outstanding: frame k+1 is handed to the tracking stage once the tracker's
output for frame k is out and its newest pose is on the host.  A session
is one pass over the pre-made frames with a fresh tracker and map; it
ends where the tracker ends it (buffer full or last frame), and sessions
follow each other until the window closes.  The frame in flight then
finishes (its latency counts) and every stage is shut down.

Spans come from thin proxies around the tracker and the map that the
harness hands to the stages (both are called inside ``DEVICE_LOCK``, so
a span is the layer's own time); with ``trace`` the model's and the
correlation's entry points are counted too, and ``torch.profiler``
records the device's kernels and copies over the window.
"""
from __future__ import annotations

import importlib.util
import json
import sys
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from . import frames as framegen
from . import yardstick

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
WEIGHTS = REPO / "weights_synthetic.npz"
# the warm-up session: this many of the cell's frames, about this many
# degrees apart (the orbit's motion, so that every shape an update round
# and the map use is met before the window)
WARMUP_FRAMES = 20
WARMUP_DEG_PER_FRAME = 12.0
# the map step compared is one the field makes after this many: Adam's
# first steps move every element by about its rate whatever the size of
# its gradient, so a gradient at rounding level flips a whole step
MAP_STEP_MIN = 20
# the camera rigs a configuration's ``tracker.sensor`` may state
SENSORS = ("mono", "rgbd", "stereo")
# ``tracker`` keys the harness reads, and those that only describe
TRACKER_KEYS = ("buffer", "e_active", "e_inactive", "p_window", "k_depth",
                "motion_filter_thresh", "keyframe_thresh", "global_ba",
                "gn_iters", "ep", "lm", "sensor", "stereo_baseline_m")
TRACKER_DESCRIPTIVE = ("network", "dtype")


# ---------------------------------------------------------------------------
# what a run records
# ---------------------------------------------------------------------------

@dataclass
class FrameCall:
    session: int
    k: int
    t_hand: float            # handed to the tracking stage
    t_start: float           # the tracker's call began
    t_end: float             # its output out, its newest pose on the host
    kind: str                # "first" | "kept" | "rejected" | "filtered"
    keyframes: int           # the session's keyframes after the call
    edges: int               # and the edges in its graph


@dataclass
class FusionCall:
    t_start: float
    t_end: float
    iters: int               # NeRF training iterations in the call
    with_packet: bool


@dataclass
class Run:
    """Everything a metric reader may read."""
    workload: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device_name: str = ""
    setup_s: float = 0.0
    t_open: float = 0.0
    t_close: float = 0.0
    frames: List[FrameCall] = field(default_factory=list)
    fusion: List[FusionCall] = field(default_factory=list)
    sessions: int = 0
    # traced runs: ("name", shape numbers...) of the model's and the
    # correlation's calls, the lookups' coords, the device's events
    model_calls: List[tuple] = field(default_factory=list)
    lookups: List[tuple] = field(default_factory=list)
    device_events: List[tuple] = field(default_factory=list)

    def in_window(self, t: float) -> bool:
        return self.t_open <= t < self.t_close

    def window_frames(self) -> List[FrameCall]:
        """Frames handed off inside the window."""
        return [f for f in self.frames if self.in_window(f.t_hand)]


# ---------------------------------------------------------------------------
# the data: BENCHMARK.json, configurations, traffic, metric readers
# ---------------------------------------------------------------------------

def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def load_cell(workload: str, root: Path = REPO):
    """(benchmark, workload entry, configuration, traffic) by name."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json "
                         f"has {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[cell["config"]]["file"])
    rig(config)
    traffic = load_json(root / ROOT.name / "traffic"
                        / f"{cell['traffic']}.json")
    return bench, cell, config, traffic


def rig(config: dict):
    """(sensor, stereo baseline in metres or None) as the configuration
    states them; raises, naming the key, on what the harness would not
    run as stated."""
    if config.get("multi_gpu", False):
        raise ValueError(
            "multi_gpu: true: the harness runs tracking and mapping on one "
            "card; the two-card layout waits for PERF.md section 7, row 1")
    t = config["tracker"]
    for key in t:
        if key not in TRACKER_KEYS + TRACKER_DESCRIPTIVE:
            raise ValueError(f"tracker.{key}: the harness does not read it "
                             f"(it reads {', '.join(TRACKER_KEYS)})")
    sensor = t.get("sensor", "mono")
    if sensor not in SENSORS:
        raise ValueError(f"tracker.sensor: {sensor!r} is none of {SENSORS}")
    if (sensor == "stereo") != ("stereo_baseline_m" in t):
        raise ValueError("tracker.stereo_baseline_m: stated with "
                         "sensor \"stereo\" and only with it")
    if sensor == "stereo" and not t["stereo_baseline_m"] > 0:
        raise ValueError("tracker.stereo_baseline_m: a length in metres "
                         "above 0")
    return sensor, t.get("stereo_baseline_m")


def rig_pose(baseline: float) -> np.ndarray:
    """cam1_T_cam0 ([t, q_xyzw]) of a right camera ``baseline`` metres
    along the left camera's x axis (the synthetic dataset's stereo_rel)."""
    return np.array([-baseline, 0, 0, 0, 0, 0, 1], np.float32)


def metrics_for(bench: dict, workload: str, trace: bool) -> List[dict]:
    """The metrics a run of ``workload`` reports: its end-to-end ones
    untraced, its per-layer ones traced."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def load_reader(name: str, root: Path = REPO
                ) -> Callable[[Run], Optional[float]]:
    """``portbench/metrics/<name>.py``'s ``read``."""
    path = root / ROOT.name / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ---------------------------------------------------------------------------
# proxies around the program's objects
# ---------------------------------------------------------------------------

class Window:
    def __init__(self, t_open: float, seconds: float):
        self.t_open, self.t_close = t_open, t_open + seconds

    def closed(self) -> bool:
        return time.perf_counter() >= self.t_close


class TrackerProxy:
    """The object ``SlamModule`` calls: times each call, reads the motion
    filter's decision after it, brings the newest pose to the host, then
    lets the source hand on the next frame."""

    def __init__(self, frontend, run: Optional[Run], session: int,
                 probes: "Probes"):
        self._fe = frontend
        self._run = run
        self._session = session
        self._probes = probes
        self.ready = threading.Event()
        self.ready.set()
        self.t_hand = 0.0
        self.rows: Dict[int, tuple] = {}     # slot -> (cam_T_world, gt)

    def __getattr__(self, name):
        return getattr(self._fe, name)

    def __call__(self, k: int, batch: dict):
        fe = self._fe
        t0 = time.perf_counter()
        probe = self._probes.motion_before(fe, t0)
        out = fe(k, batch)
        if out is not None and "cam0_poses" in out:
            n = int(out["viz_count"])
            est = out["cam0_poses"][:n].cpu().numpy()
            gt = out["gt_poses"][:n].cpu().numpy()
            for slot, e, g in zip(np.asarray(out["viz_idx"])[:n], est, gt):
                self.rows[int(slot)] = (e, g)
        mag = fe.last_motion_mag
        if k == 0 or mag is None:
            kind = "first"
        elif mag > fe.cfg.motion_filter_thresh:
            # passed the filter: kept as a keyframe (the tracker's newest
            # keyframe is then this frame) or rejected by the keyframe
            # distance after its update round
            kind = "kept" if fe.last_k == k else "rejected"
        else:
            kind = "filtered"
        if probe is not None:
            self._probes.motion_after(probe, int(batch["t_cams"]), mag)
        t1 = time.perf_counter()
        if self._run is not None:
            self._run.frames.append(FrameCall(
                self._session, k, self.t_hand, t0, t1, kind, int(fe.kf_idx),
                int(fe.graph.n_edges)))
        self.ready.set()
        return out


class FusionProxy:
    """The map as ``FusionModule`` sees it, with each call timed."""

    def __init__(self, fusion, run: Optional[Run], probes: "Probes"):
        self._f = fusion
        self._run = run
        self._probes = probes

    def __getattr__(self, name):
        return getattr(self._f, name)

    def _record(self, t0, it0, pkt):
        if self._run is not None:
            self._run.fusion.append(FusionCall(
                t0, time.perf_counter(),
                getattr(self._f, "iteration", 0) - it0, pkt is not None))

    def fuse_and_fit(self, pkt, iters=None):
        t0, it0 = time.perf_counter(), self._f.iteration
        probe = self._probes.ingest_before(pkt, t0)
        done = self._f.fuse_and_fit(pkt, iters)
        if probe is not None:
            self._probes.ingest_after(probe, self._f)
        self._record(t0, it0, pkt)
        return done

    def fuse(self, pkt):
        if pkt is None:
            return self._f.fuse(pkt)
        t0 = time.perf_counter()
        probe = self._probes.tsdf_before(self._f, pkt, t0)
        done = self._f.fuse(pkt)
        if probe is not None:
            self._probes.tsdf_after(probe, self._f)
        self._record(t0, 0, pkt)
        return done


# ---------------------------------------------------------------------------
# probes: what the comparison with the reference reads from the window
# ---------------------------------------------------------------------------

class Probes:
    """Captures, at times drawn from the seed, the inputs and outputs of
    the stages the reference recomputes: the motion filter's magnitude
    (encoders, lookup #2, one update), an update round's iterations
    (lookup #1, update operator, DBA), a map training step (hash-grid
    encode, MLP, volume rendering, loss, backward, Adam) and a packet's
    ingest into the training set, and a TSDF integration of a packet."""

    N_MOTION = 6
    N_ROUNDS = 2

    def __init__(self, seed: int, window: Optional[Window], seconds: float,
                 map_step_min: int = MAP_STEP_MIN):
        rng = np.random.default_rng(seed)
        self.window = window
        self.map_step_min = map_step_min
        # each mark takes the first call at or after it, so the marks stay
        # in the window's first half, where a call always follows
        def marks(n):
            return list(np.sort(rng.uniform(0.05, 0.5, n)) * seconds)
        self._motion_at = marks(self.N_MOTION)
        self._round_at = marks(self.N_ROUNDS)
        self._map_at = marks(1)
        self._ingest_at = marks(1)
        self._tsdf_at = marks(1)
        self.motion: List[dict] = []
        self.rounds: List[dict] = []
        self.map_steps: List[dict] = []
        self.ingests: List[dict] = []
        self.tsdf: List[dict] = []

    def _due(self, marks: list, t: float) -> bool:
        w = self.window
        if w is None or not marks or t >= w.t_close:
            return False
        if t - w.t_open >= marks[0]:
            marks.pop(0)
            return True
        return False

    # the motion filter ---------------------------------------------------
    def motion_before(self, fe, t: float):
        if fe.last_k is None or not self._due(self._motion_at, t):
            return None
        return {"last_kf_frame": int(round(float(
            fe.state.timestamps[fe.last_kf_idx])))}

    def motion_after(self, probe: dict, k: int, mag):
        if mag is None:
            return
        probe.update(frame=k, mag=float(mag))
        self.motion.append(probe)

    # an update round -------------------------------------------------------
    def wrap_iterate(self, fe):
        """At a due round, keep the carry before the program's own
        ``_iterate(n, ...)`` call and after each of its iterations: the
        loop's DBA call, its last step, is watched for the iteration's
        end (the update operator's outputs are in the carry by then, the
        poses and depths are what the DBA returns)."""
        orig = fe._iterate

        def iterate(n, c, plan, shards):
            if not self._due(self._round_at, time.perf_counter()):
                return orig(n, c, plan, shards)
            from nerf_slam_tpu_torch.solver import dba
            st = fe.state
            cap = {"plan": plan._asdict(),
                   "in_flow": shards[0].in_flow.clone(),
                   "in_weight": shards[0].in_weight.clone(),
                   "timestamps": st.timestamps.clone(),
                   "steps": []}
            before = [_clone_carry(c)]
            solve = dba.dba_iterations

            def watched(*a, **kw):
                poses, disps = solve(*a, **kw)
                after = _clone_carry(dict(c, poses=poses, disps=disps))
                cap["steps"].append((before[0], after))
                before[0] = after
                return poses, disps
            dba.dba_iterations = watched
            try:
                orig(n, c, plan, shards)
            finally:
                dba.dba_iterations = solve
            self.rounds.append(cap)
        fe._iterate = iterate

    # a map step and the packet ingest ------------------------------------
    def wrap_train_step(self, fusion):
        """At a due step, keep what the program's own ``train_step()``
        call started from (the field's parameters and Adam state, the
        training set), its draws as ``draw_batch`` gave them, and the
        parameters and Adam state it left."""
        orig = fusion.train_step

        def train_step(batch=None):
            if batch is not None or fusion.iteration < self.map_step_min \
                    or not self._due(self._map_at, time.perf_counter()):
                return orig(batch)
            ts = fusion.train_set
            cap = {"train_set": {k: getattr(ts, k).clone() for k in
                                 ("c2w", "images", "depths", "depths_cov",
                                  "intrinsics", "valid")},
                   "before": _field_state(fusion)}
            draw = fusion.draw_batch

            def keep_batch():
                b = draw()
                cap["batch"] = _clone(tuple(b))
                return b
            fusion.draw_batch = keep_batch
            try:
                loss = orig(batch)
            finally:
                del fusion.draw_batch
            cap["after"] = _field_state(fusion)
            self.map_steps.append(cap)
            return loss
        fusion.train_step = train_step

    def ingest_before(self, pkt, t: float):
        if pkt is None or "viz_idx" not in pkt \
                or not self._due(self._ingest_at, t):
            return None
        return {"packet": pkt}

    def ingest_after(self, probe: dict, fusion):
        ids = torch.as_tensor(np.asarray(probe["packet"]["viz_idx"]),
                              device=fusion.device)
        ts = fusion.train_set
        probe["rows"] = {k: getattr(ts, k)[ids].clone() for k in
                         ("c2w", "images", "depths", "depths_cov",
                          "intrinsics")}
        self.ingests.append(probe)

    # a TSDF integration ----------------------------------------------------
    def tsdf_before(self, fusion, pkt, t: float):
        if "viz_idx" not in pkt or not self._due(self._tsdf_at, t):
            return None
        v = fusion.volume
        return {"packet": pkt, "sigma_thresh": float(fusion.sigma_thresh),
                "before": [v.tsdf.clone(), v.weight.clone(), v.color.clone()]}

    def tsdf_after(self, probe: dict, fusion):
        v = fusion.volume
        probe["after"] = [v.tsdf.clone(), v.weight.clone(), v.color.clone()]
        self.tsdf.append(probe)


def _clone(x):
    return tuple(_clone(y) for y in x) if isinstance(x, (tuple, list)) \
        else x.detach().clone()


def _field_state(fusion) -> dict:
    """The field's parameters and, by the same names, Adam's moments and
    step count (absent before a parameter's first step)."""
    out = {"params": {}, "exp_avg": {}, "exp_avg_sq": {}, "step": {}}
    for name, p in fusion.field.named_parameters():
        out["params"][name] = p.detach().clone()
        st = fusion.opt.state.get(p, {})
        for k in ("exp_avg", "exp_avg_sq", "step"):
            if k in st:
                out[k][name] = st[k].detach().clone() \
                    if torch.is_tensor(st[k]) else torch.tensor(st[k])
    return out


def _clone_carry(c: dict) -> dict:
    return {k: (v[0] if isinstance(v, list) else v).detach().clone()
            for k, v in c.items()}


# ---------------------------------------------------------------------------
# traced runs: the model's and the correlation's calls
# ---------------------------------------------------------------------------

class Counters:
    """Wraps the model's and the correlation's entry points to record, in
    the window of a traced run, the shapes the FLOP and byte arithmetic
    needs.  ``active()`` gives the tracker's live edge count."""

    def __init__(self, run: Run, window: Window, active: Callable[[], int]):
        self.run, self.window, self.active = run, window, active

    def _on(self) -> bool:
        return not self.window.closed() and \
            time.perf_counter() >= self.window.t_open

    def install(self, net, e_slots: int):
        from nerf_slam_tpu_torch.ops import corr, corr_lookup
        rec = self.run.model_calls

        def n_act(e):
            return min(self.active(), e) if e == e_slots else e

        def wrap(obj, name, note):
            orig = getattr(obj, name)

            def f(*a, **kw):
                if self._on():
                    rec.append(note(*a, **kw))
                return orig(*a, **kw)
            setattr(obj, name, f)

        wrap(net, "features", lambda x: ("features",) + tuple(x.shape[-3:-1]))
        wrap(net, "context", lambda x: ("context",) + tuple(x.shape[-3:-1]))
        wrap(net, "update_precompute",
             lambda inp: ("gates", n_act(inp.shape[0])) + tuple(
                 inp.shape[1:3]))

        def note_update(hid, inp, cor, flow=None, seg=None, n_seg=None,
                        with_upmask=True, gates_inp=None):
            e = hid.shape[0]
            return ("update", n_act(e), hid.shape[1], hid.shape[2],
                    int(gates_inp is not None), int(flow is not None),
                    0 if seg is None else int(n_seg) * (1 + int(with_upmask)))
        wrap(net, "update", note_update)

        def note_pool(kind):
            def note(hid, seg, n_seg):
                h = hid[0] if isinstance(hid, list) else hid
                return (kind, n_act(h.shape[0]), int(n_seg), h.shape[1],
                        h.shape[2])
            return note
        wrap(net, "eta", note_pool("eta"))
        wrap(net, "aggregate", note_pool("aggregate"))
        wrap(corr, "build_pyramid_bf16",
             lambda f1, f2, n=4, pad_rows_to=1: (
                 "pyramid", f1.shape[0], f1.shape[1], f1.shape[2],
                 f1.shape[3], int(n)))
        wrap(corr, "build_volume", lambda f1, f2: (
            "volume", f1.shape[0], f1.shape[1], f1.shape[2], f1.shape[3]))

        look = self.run.lookups

        def lookup4g(levels, coords, dims, n_act=None):
            if self._on():
                look.append(("lookup4g", coords.detach().clone(),
                             None if n_act is None else n_act.clone(),
                             tuple(dims),
                             tuple(tuple(v.shape[-2:]) for v in levels)))
            return orig4g(levels, coords, dims, n_act)
        orig4g = corr_lookup.lookup_pyramid_grouped4
        corr_lookup.lookup_pyramid_grouped4 = lookup4g

        def lookup_mf(levels, coords):
            if self._on():
                dims = tuple(tuple(v.shape[-2:]) for v in levels)
                look.append(("lookup_mf", coords.detach().clone(), None,
                             dims, dims))
            return orig_mf(levels, coords)
        orig_mf = corr_lookup.lookup_pyramid
        corr_lookup.lookup_pyramid = lookup_mf


# ---------------------------------------------------------------------------
# the cell: the program's objects, built from the configuration
# ---------------------------------------------------------------------------

class Cell:
    """The tracker's network and settings, the map's settings and the
    pre-made frames of one cell: host images, and the depths (RGB-D) or
    right views (stereo) the configuration's rig senses."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from nerf_slam_tpu_torch.models import DroidNet, load_flax_weights
        from nerf_slam_tpu_torch.tracking import FrontendConfig
        from nerf_slam_tpu_torch.utils.checkpoint import load_arrays

        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        c = config
        self.H, self.W = c["height"], c["width"]
        self.sensor, baseline = rig(c)
        f = framegen.render(
            traffic["session_frames"], self.H, self.W, c["fov_deg"],
            traffic["deg_per_frame"], seed, self.device,
            depths=self.sensor == "rgbd", baseline=baseline)
        self.images, self.poses, self.K = f.images, f.poses, f.K
        self.depths, self.images_right = f.depths, f.images_right
        self.stereo_rel = None if baseline is None else rig_pose(baseline)
        # bf16 on the card, as the CLI computes; f32 on the CPU
        dtype = torch.bfloat16 if self.device.type == "cuda" \
            else torch.float32
        flat, meta = load_arrays(str(WEIGHTS))
        self.net = load_flax_weights(DroidNet(dtype=dtype), flat)
        t = c["tracker"]
        sensing = {"rgbd": True} if self.sensor == "rgbd" else {}
        if self.stereo_rel is not None:
            sensing = {"stereo": True, "stereo_rel": tuple(
                float(v) for v in self.stereo_rel)}
        self.fcfg = FrontendConfig(
            buffer=t["buffer"], e_active=t["e_active"],
            e_inactive=t["e_inactive"], p_window=t["p_window"],
            k_depth=t["k_depth"],
            motion_filter_thresh=t["motion_filter_thresh"],
            keyframe_thresh=t["keyframe_thresh"],
            global_ba=t["global_ba"], gn_iters=t["gn_iters"], ep=t["ep"],
            lm=t["lm"],
            damping_scale=float(meta["damping_scale"]),
            damping_offset=float(meta["damping_offset"]), **sensing)

    def rig_packet(self, k: int) -> dict:
        """What the rig adds to frame ``k``'s packet, by the loaders'
        keys."""
        if self.depths is not None:
            return {"depths": self.depths[k]}
        if self.images_right is not None:
            return {"images_right": self.images_right[k],
                    "stereo_rel": self.stereo_rel}
        return {}

    def frontend(self):
        from nerf_slam_tpu_torch.tracking import RaftVisualFrontend
        return RaftVisualFrontend(self.net, self.fcfg, (self.H, self.W),
                                  device=self.device)

    def fusion(self):
        """(map, FusionModule mode)."""
        m = self.config["map"]
        if m["kind"] == "nerf":
            from nerf_slam_tpu_torch.fusion import NerfFusion, NerfFusionConfig
            from nerf_slam_tpu_torch.fusion.hashgrid import HashGridConfig
            from nerf_slam_tpu_torch.fusion.ngp import NGPConfig
            ngp = NGPConfig(encoding=m["encoding"],
                            grid=HashGridConfig(**m["grid"]),
                            hidden=m["hidden"], n_uniform=m["n_uniform"],
                            n_depth=m["n_depth"], lr=m["lr"],
                            rgb_weight=m["rgb_weight"],
                            depth_weight=m["depth_weight"])
            cfg = NerfFusionConfig(
                buffer=self.fcfg.buffer, height=self.H, width=self.W,
                batch_rays=m["batch_rays"], iters_per_spin=m["iters_per_spin"],
                mask_type=m["mask_type"], ngp=ngp, scale=m["scene_scale"],
                offset=tuple(m["scene_offset"]))
            return NerfFusion(cfg, seed=self.seed % 2 ** 31,
                              device=self.device), "nerf"
        from nerf_slam_tpu_torch.fusion import TsdfFusion, TsdfFusionConfig
        keys = ("depth_mask_type", "grid_size", "volume_extent",
                "sdf_trunc_voxels", "max_depth", "max_weight",
                "max_depth_sigma_thresh")
        cfg = TsdfFusionConfig(volume_origin=tuple(m["volume_origin"]),
                               **{k: m[k] for k in keys})
        return TsdfFusion(cfg, device=self.device), m["mode"]


def _source_class():
    from nerf_slam_tpu_torch.pipeline.module import PipelineModule

    class Source(PipelineModule):
        """The closed-loop source: one frame outstanding."""

        def __init__(self, cell: Cell, order, proxy: TrackerProxy,
                     window: Optional[Window]):
            super().__init__("data", True)
            self.cell, self.order, self.proxy = cell, order, proxy
            self.window = window
            self.i = 0
            self.stages: list = []

        def spin_once(self, _):
            while not self.proxy.ready.wait(0.25):
                if self.shutdown:
                    return None
            closed = self.window is not None and self.window.closed()
            if closed or self.proxy.stop_condition() \
                    or self.i >= len(self.order):
                self.shutdown_module()
                if closed:
                    for m in self.stages:
                        m.shutdown_module()
                return None
            self.proxy.ready.clear()
            k, c = self.order[self.i], self.cell
            # "t_cams" carries the frame's index in the pre-made sequence
            pkt = {"k": self.i, "t_cams": float(k), "images": c.images[k],
                   "intrinsics": c.K, "poses": c.poses[k],
                   "is_last_frame": self.i == len(self.order) - 1,
                   **c.rig_packet(k)}
            self.i += 1
            self.proxy.t_hand = time.perf_counter()
            return pkt

    return Source


def run_session(cell: Cell, order, run: Optional[Run], session: int,
                window: Optional[Window], probes: "Probes",
                counters: Optional[Counters] = None) -> TrackerProxy:
    """One session over the frames ``order`` with a fresh tracker and map;
    returns the tracker's proxy (its rows hold the session's poses)."""
    from nerf_slam_tpu_torch.pipeline import (EvalSink, FusionModule,
                                              SlamModule, connect,
                                              run_parallel)
    fe = cell.frontend()
    probes.wrap_iterate(fe)
    fusion, mode = cell.fusion()
    if mode == "nerf":
        probes.wrap_train_step(fusion)
    proxy = TrackerProxy(fe, run, session, probes)
    if counters is not None:
        counters.active = lambda: fe.graph.n_edges
    src = _source_class()(cell, order, proxy, window)
    slam_m = SlamModule(proxy)
    fusion_m = FusionModule(FusionProxy(fusion, run, probes), mode=mode,
                            iters_per_spin=cell.config["map"].get(
                                "iters_per_spin", 10),
                            extra_spins_after_done=1)
    sink = EvalSink()
    modules = [src, slam_m, fusion_m, sink]
    src.stages = modules
    connect(src, slam_m, "data")
    connect(slam_m, sink, "slam")
    connect(slam_m, fusion_m, "slam")
    run_parallel(modules, timeout_s=3600.0)
    if any(m.failed for m in modules):
        raise RuntimeError("a pipeline stage failed")
    return proxy


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: Optional[float] = None,
             overrides: Optional[dict] = None, root: Path = REPO,
             faults: Optional[Callable[[Any], None]] = None):
    """Set-up, warm-up, the window and, with ``trace``, the profiler.

    Returns (run, probes, cell, sessions' pose rows).  ``overrides``
    replace configuration and traffic entries, the warm-up's frame count
    and the map step's least number (the CPU tests' small sizes); ``faults`` is called with the
    cell before the window (the tests that break the timed path)."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench, entry, config, traffic = load_cell(workload, root)
    for key, val in (overrides or {}).get("config", {}).items():
        config[key] = val
    for key, val in (overrides or {}).get("traffic", {}).items():
        traffic[key] = val
    dev = torch.device(device)
    if dev.type == "cuda":
        from nerf_slam_tpu_torch.ops import build
        build.build(["corr_lookup"])
    cell = Cell(config, traffic, seed, dev)
    run = Run(workload, config, traffic, seed, seconds, trace)
    run.device_name = (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu")

    # warm-up: one short session over the cell's own frames, at about
    # the orbit's motion, thrown away
    n = len(cell.images)
    stride = max(1, int(round(WARMUP_DEG_PER_FRAME
                              / traffic["deg_per_frame"])))
    warm = list(range(0, n, stride))[:(overrides or {}).get(
        "warmup_frames", WARMUP_FRAMES)]
    run_session(cell, warm, None, 0, None, Probes(seed, None, seconds))
    if faults is not None:
        faults(cell)
    _sync(dev)

    order = list(range(n))
    prof = counters = None
    if trace:
        prof = _start_profiler(dev)
    t_open = time.perf_counter()
    window = Window(t_open, seconds)
    if trace:
        counters = Counters(run, window, lambda: 0)
        counters.install(cell.net, cell.fcfg.e_active)
    run.setup_s = t_open - t_start
    run.t_open, run.t_close = window.t_open, window.t_close
    probes = Probes(seed, window, seconds, (overrides or {}).get(
        "map_step_min", MAP_STEP_MIN))
    rows = []
    while not window.closed():
        run.sessions += 1
        proxy = run_session(cell, order, run, run.sessions, window, probes,
                            counters)
        rows.append(proxy.rows)
    _sync(dev)
    if prof is not None:
        prof.stop()
        run.device_events = _device_events(prof, window)
    return run, probes, cell, rows


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _start_profiler(dev):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] if dev.type == "cuda" \
        else [ProfilerActivity.CPU]
    prof = profile(activities=acts)
    prof.start()
    return prof


def _device_events(prof, window: Window) -> List[tuple]:
    """(name, start, end) of the device's kernels, copies and sets that
    start inside the window, in ``time.perf_counter`` seconds."""
    off = time.time_ns() - time.perf_counter_ns()
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        s = (e.start_ns() - off) * 1e-9
        if window.t_open <= s < window.t_close:
            out.append((e.name(), s, s + e.duration_ns() * 1e-9))
    return out


def breakdown(run: Run, top: int = 10) -> dict:
    """The device operations with the most time, and the longest idle
    gaps labelled by the harness span open at the time."""
    by_name: Dict[str, float] = {}
    for name, s, e in run.device_events:
        key = name[:160]
        by_name[key] = by_name.get(key, 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    idle = yardstick.gaps([(s, e) for _, s, e in run.device_events],
                          run.t_open, run.t_close)
    idle = sorted(idle, key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[n, v] for n, v in ops],
            "idle_gaps": [[f"{host_activity(run, (s + e) / 2)} at "
                           f"{s - run.t_open:.3f}s", e - s]
                          for s, e in idle]}


def host_activity(run: Run, t: float) -> str:
    """What the host was doing at ``t``: in a tracker call, in a fusion
    call, waiting for the lock (a frame handed off and not yet started),
    or none of these."""
    if any(f.t_start <= t < f.t_end for f in run.frames):
        return "tracker call"
    if any(c.t_start <= t < c.t_end for c in run.fusion if c.with_packet
           or c.iters):
        return "fusion call"
    if any(f.t_hand <= t < f.t_start for f in run.frames):
        return "lock wait"
    return "none"


def loaded_forbidden() -> List[str]:
    """Modules whose top-level name is JAX's, its libraries' or the JAX
    package's, compared whole."""
    bad = {"jax", "jaxlib", "flax", "nerf_slam_tpu"}
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in bad)


def tiny_overrides(config: dict) -> dict:
    """Small sizes at which a run goes through every stage on the CPU in
    seconds (the tests' rehearsal; never a measurement)."""
    m = dict(config["map"])
    if m["kind"] == "nerf":
        m.update(batch_rays=256, iters_per_spin=2,
                 grid=dict(m["grid"], log2_table_size=14))
    else:
        m.update(grid_size=48)
    return {"config": {"height": 96, "width": 128, "map": m},
            "traffic": {"session_frames": 40}, "warmup_frames": 12,
            "map_step_min": 2}
