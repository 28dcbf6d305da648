"""The span recorder of ``utils/runtime.py``, the spans the program opens
at its layer boundaries, and the benchmark's readers of them.

The CPU tests need no card.  The tests marked ``cuda`` count syncs and
read the device's clock on the card and skip without one; they import no
JAX, so they run where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_spans.py
"""
import queue
import threading
import time
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from nerf_slam_tpu_torch.pipeline import modules as stages
from nerf_slam_tpu_torch.pipeline.module import ModuleThread
from nerf_slam_tpu_torch.utils import runtime
from portbench import harness

TRACKER_SPANS = {"track.frame", "track.ingest", "track.motion", "track.graph",
                 "track.iter", "track.dba", "track.kf_dist", "track.export",
                 "track.cov", "track.viz_out", "track.reset"}
MAP_SPANS = {"map.tsdf", "map.reset", "map.ingest", "map.step", "map.draw",
             "map.forward", "map.backward", "map.optim"}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several test processes on a
    few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_nothing_is_recorded_without_a_profiler():
    with _cpu_profile():
        with runtime.span("kept"):
            pass
    before = runtime.spans()
    a, b = runtime.span("a", k=1), runtime.span("b")
    assert a is b and not isinstance(a, runtime.Span)
    with a as inner, runtime.span("c"):
        assert inner is None
        torch.ones(4).sum().item()
    assert runtime.spans() == before and [s.name for s in before] == ["kept"]
    assert runtime.RECORDER.stack() == []


def test_nesting_parents_ids_and_self_time(tmp_path):
    with runtime.profile_trace(str(tmp_path)):
        with runtime.span("outer", k=3, session=7) as outer:
            time.sleep(0.01)
            with runtime.span("inner", iteration=1) as a:
                with runtime.span("leaf") as leaf:
                    time.sleep(0.02)
            with runtime.span("inner", iteration=2) as b:
                time.sleep(0.01)
    got = runtime.spans()
    # closed in order: leaf, a, b, outer
    assert got == [leaf, a, b, outer]
    assert runtime.spans("inner") == [a, b]
    assert outer.parent is None and a.parent is outer and b.parent is outer
    assert leaf.parent is a and outer.children == [a, b]
    assert outer.ids == {"k": 3, "session": 7} and b.ids == {"iteration": 2}
    assert {s.stage for s in got} == {threading.current_thread().name}
    assert outer.t0 <= a.t0 < a.t1 <= b.t0 < b.t1 <= outer.t1
    assert leaf.t0 >= a.t0 and leaf.t1 <= a.t1
    assert outer.self_ns == (outer.t1 - outer.t0) - (a.t1 - a.t0) \
        - (b.t1 - b.t0)
    assert a.self_ns == (a.t1 - a.t0) - (leaf.t1 - leaf.t0)
    assert leaf.self_ns == leaf.t1 - leaf.t0 >= 0.02e9
    assert outer.self_ns >= 0.01e9
    assert outer.subtree_syncs() == 0 and runtime.RECORDER.loose_syncs == 0


def test_self_time_takes_the_union_of_children():
    parent = runtime.Span("p", {}, None, "x")
    parent.t0, parent.t1 = 0, 100
    for t0, t1 in ((10, 30), (20, 40), (90, 120)):
        c = runtime.Span("c", {}, parent, "x")
        c.t0, c.t1 = t0, t1
        parent.children.append(c)
    # covered: [10, 40) and [90, 100)
    assert parent.self_ns == 100 - 30 - 10


def test_two_threads_spans_never_nest_into_each_other():
    both_open = threading.Barrier(2, timeout=30)
    out = {}

    def work(tag):
        with runtime.span("work", tag=tag) as s:
            both_open.wait()
            with runtime.span("step") as inner:
                both_open.wait()
        out[tag] = (s, inner)

    with _cpu_profile():
        threads = [threading.Thread(target=work, args=(t,), name=f"stage{t}")
                   for t in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    for tag in (0, 1):
        s, inner = out[tag]
        assert s.parent is None and inner.parent is s
        assert s.children == [inner]
        assert s.stage == inner.stage == f"stage{tag}"
    # the two threads' spans overlap in time
    assert out[0][0].t0 < out[1][0].t1 and out[1][0].t0 < out[0][0].t1


class _Frontend:
    def __init__(self):
        self.calls = 0

    def __call__(self, k, batch):
        with runtime.span("track.frame", k=k, session=1):
            self.calls += 1
        return {"k": k}

    def stop_condition(self):
        return self.calls > 0


class _Map:
    iteration = 0

    def fuse(self, pkt):
        return True


class _Gui:
    def visualize(self, pkt):
        pass

    def pop_commands(self):
        return []


class _CountingLock:
    def __init__(self):
        self.lock = threading.RLock()
        self.acquired = 0

    def acquire(self):
        self.acquired += 1
        return self.lock.acquire()

    def release(self):
        self.lock.release()


def test_lock_spans_carry_the_stage(monkeypatch):
    """``lock.wait`` and ``lock.hold`` around each stage's device work,
    on the stage's own thread, with the lock looked up at each spin."""
    lock = _CountingLock()
    monkeypatch.setattr(runtime, "DEVICE_LOCK", lock)
    mods = [stages.SlamModule(_Frontend()),
            stages.FusionModule(_Map(), mode="sigma"),
            stages.GuiModule(_Gui())]
    pkt = {"k": 0, "is_last_frame": True}
    for m, name in zip(mods, ("data", "slam", "slam")):
        q = queue.Queue()
        q.put(pkt)
        m.register_input_queue(name, q)
    with _cpu_profile():
        threads = [ModuleThread(m) for m in mods]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert lock.acquired == 3
    got = runtime.spans()
    for stage in ("slam", "fusion", "gui"):
        waits = [s for s in got if s.name == "lock.wait" and s.stage == stage]
        holds = [s for s in got if s.name == "lock.hold" and s.stage == stage]
        assert len(waits) == len(holds) == 1, stage
        assert waits[0].t1 <= holds[0].t0
    frame, = runtime.spans("track.frame")
    assert frame.stage == "slam" and frame.parent.name == "lock.hold"


def _tiny_cell(name: str, traffic: str = "orbit"):
    config = harness.load_json(harness.ROOT / "configs" / f"{name}.json")
    tiny = harness.tiny_overrides(config)
    config.update(tiny["config"])
    traffic = dict(harness.load_json(harness.ROOT / "traffic"
                                     / f"{traffic}.json"), session_frames=14)
    return harness.Cell(config, traffic, 5, "cpu")


def test_tiny_tracker_and_maps_record_every_span_their_path_reaches():
    """Twelve orbit frames through the tracker (initialization, kept
    keyframes with the export, the keyframe distance), each packet into
    the TSDF map and the NeRF map (two steps a packet)."""
    cell = _tiny_cell("sigma_mono_384x512")
    nerf_cell = _tiny_cell("ngp_mono_344x616")
    with _cpu_profile():
        fe = cell.frontend()
        tsdf, _ = cell.fusion()
        nerf, _ = nerf_cell.fusion()
        for k in range(12):
            pkt = {"k": k, "t_cams": float(k), "images": cell.images[k],
                   "intrinsics": cell.K, "poses": cell.poses[k],
                   "is_last_frame": False}
            out = fe(k, pkt)
            if out is not None and "cam0_poses" in out:
                tsdf.fuse(out)
                nerf.fuse_and_fit(out, 2)
    got = runtime.spans()
    names = {s.name for s in got}
    assert names >= TRACKER_SPANS | MAP_SPANS, \
        (TRACKER_SPANS | MAP_SPANS) - names
    frames = runtime.spans("track.frame")
    assert [s.ids["k"] for s in frames] == list(range(12))
    assert {s.ids["session"] for s in frames} == {fe.session}
    steps = runtime.spans("map.step")
    assert [s.ids["iteration"] for s in steps] == list(range(len(steps)))
    for s in got:
        if s.name in TRACKER_SPANS - {"track.frame", "track.reset"}:
            top = s
            while top.parent is not None:
                top = top.parent
            assert top.name == "track.frame", s.name
    for name, parent in (("track.dba", "track.iter"),
                         ("track.cov", "track.export"),
                         ("track.motion", "track.ingest"),
                         ("map.backward", "map.step")):
        assert {s.parent.name for s in runtime.spans(name)} == {parent}
    # monocular packets: nothing sensed, no depth pixel in any solve
    assert "track.sense" not in names
    assert {(s.ids["sensed_px"], s.ids["depth_px"])
            for s in runtime.spans("track.dba")} == {(0, 0)}


def test_sense_spans_and_the_solves_pixel_counts():
    """Twelve orbit frames through the tracker of a tiny RGB-D cell, each
    packet with its depths (the monocular cell's test above checks the
    converse): ``track.sense`` once for each depth packet; each
    ``track.dba`` span's ``sensed_px`` and ``depth_px`` equal to the
    valid depth pixels of the solve's depth slots, counted on the host
    from the frames' depths; and the tracker's per-slot counts move with
    its state when a keyframe is removed."""
    cell = _tiny_cell("sigma_rgbd_384x512")
    fe = cell.frontend()
    dsf = fe.cfg.dsf
    expected = []
    iterate = fe._iterate

    def watched(n, c, plan, shards):
        slots = plan.kx[plan.k_valid > 0].tolist()
        px = sum(int((cell.depths[int(fe.state.timestamps[s])][
            dsf // 2::dsf, dsf // 2::dsf] > 1e-3).sum()) for s in slots)
        expected.extend([{"sensed_px": px, "depth_px": px}] * n)
        return iterate(n, c, plan, shards)
    fe._iterate = watched
    with _cpu_profile():
        for k in range(12):
            fe(k, {"k": k, "t_cams": float(k), "images": cell.images[k],
                   "intrinsics": cell.K, "poses": cell.poses[k],
                   "is_last_frame": False, **cell.rig_packet(k)})
    senses = runtime.spans("track.sense")
    got = [s.ids for s in runtime.spans("track.dba")]
    assert len(got) == len(expected) > 0 and got == expected
    assert len(senses) == 12
    assert {s.parent.name for s in senses} == {"track.frame"}
    n = fe.kf_idx
    assert (fe.depth_px[:n] == fe.sensed_px[:n]).all()
    assert (fe.sensed_px[:n] == (fe.state.idepths_sensed[:n] > 0).sum(
        (1, 2)).numpy()).all()
    # distinct counts a slot, so that the roll shows
    fe.sensed_px[:n], fe.depth_px[:n] = np.arange(n), 100 + np.arange(n)
    fe.rm_keyframe(2)
    keep = np.r_[0:2, 3:n]
    assert (fe.sensed_px[:n - 1] == keep).all()
    assert (fe.depth_px[:n - 1] == 100 + keep).all()


# ---------------------------------------------------------------------------
# the benchmark's readers, on spans made by hand
# ---------------------------------------------------------------------------

def _span(name, t0_s, t1_s, stage="slam", parent=None, syncs=0, **ids):
    s = runtime.Span(name, ids, parent, stage)
    s.t0, s.t1, s.syncs = int(t0_s * 1e9), int(t1_s * 1e9), syncs
    if parent is not None:
        parent.children.append(s)
    return s


class _Run:
    t_open, t_close = 10.0, 20.0
    device_events = []


def test_span_readers(monkeypatch):
    f1 = _span("track.frame", 10.5, 10.7, syncs=1, k=1)
    it = _span("track.iter", 10.55, 10.6, parent=f1, syncs=2)
    _span("track.dba", 10.57, 10.58, parent=it, syncs=3)
    f2 = _span("track.frame", 11.0, 11.1, syncs=4, k=2)
    late = _span("track.frame", 20.5, 20.6, syncs=100, k=3)
    done = [f1, f2, late, it,
            _span("lock.wait", 10.4, 10.5), _span("lock.wait", 10.9, 11.0),
            _span("lock.wait", 10.0, 10.3, stage="fusion"),
            _span("map.step", 12.0, 12.01, stage="fusion", syncs=2),
            _span("map.step", 12.1, 12.13, stage="fusion", syncs=0)]
    monkeypatch.setattr(runtime.RECORDER, "done", done)
    run = _Run()
    read = harness.load_reader
    assert read("lock_wait_ms.track")(run) == pytest.approx(100.0)
    assert read("lock_wait_ms.track.contended")(run) == pytest.approx(100.0)
    assert read("syncs_per_frame.track")(run) == pytest.approx(5.0)
    assert read("track_ms.iter")(run) == pytest.approx(50.0)
    assert read("map_ms.step")(run) == pytest.approx(20.0)
    assert read("syncs_per_step.map")(run) == pytest.approx(1.0)
    assert read("idle_ms.track")(run) is None
    # busy [10.5, 10.6) and [10.65, 11.05): idle 50 ms in f1, 50 ms in f2
    run.device_events = [("k", 10.5, 10.6), ("k", 10.65, 11.0),
                         ("k", 10.9, 11.05)]
    assert read("idle_ms.track")(run) == pytest.approx(50.0)


def test_span_readers_read_nothing_without_spans(monkeypatch):
    names = ("lock_wait_ms.track", "syncs_per_frame.track", "idle_ms.track",
             "track_ms.iter", "map_ms.step", "syncs_per_step.map")
    monkeypatch.setattr(runtime.RECORDER, "done", [])
    for name in names:
        assert harness.load_reader(name)(_Run()) is None, name
    # a program without the recorder (the benchmark's files over an older
    # checkout): nothing, and no error
    monkeypatch.delattr(runtime, "spans")
    for name in names:
        assert harness.load_reader(name)(_Run()) is None, name


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (counts CUDA syncs, reads the "
                    "device's clock)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_planted_syncs_are_counted_in_their_span(dev):
    x = torch.arange(1000, dtype=torch.float32, device=dev)
    host = np.ones(64, np.float32)
    mode = torch.cuda.get_sync_debug_mode()
    with profile(activities=[ProfilerActivity.CUDA]):
        assert torch.cuda.get_sync_debug_mode() == 1
        with runtime.span("planted") as s:
            float(x.sum())
            x.max().item()
            x[:8].cpu()
            torch.as_tensor(host, device=dev)
            torch.as_tensor(host * 2, device=dev)
            x.mul_(2)
    assert s.syncs == 5 and s.subtree_syncs() == 5
    assert torch.cuda.get_sync_debug_mode() == mode


@pytest.mark.cuda
def test_tracker_syncs_match_the_sync_debug_mode(dev):
    """Twelve frames at ``sigma_mono_384x512``'s shape on a fresh tracker:
    the syncs counted in the ``track.frame`` spans equal the warnings CUDA's
    sync debug mode gives over the same calls on a second fresh tracker
    (the tracker repeats its work to the bit)."""
    bench, entry, config, traffic = harness.load_cell(
        "sigma_mono_384x512.orbit")
    cell = harness.Cell(config, traffic, 11, dev)
    pkts = [{"k": k, "t_cams": float(k), "images": cell.images[k],
             "intrinsics": cell.K, "poses": cell.poses[k],
             "is_last_frame": False} for k in range(12)]
    fe = cell.frontend()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]):
        for k, pkt in enumerate(pkts):
            fe(k, pkt)
    frames = runtime.spans("track.frame")
    counted = sum(s.subtree_syncs() for s in frames)
    assert len(frames) == 12 and fe.kf_idx > 8

    fe2 = cell.frontend()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as log:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for k, pkt in enumerate(pkts):
                fe2(k, pkt)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    reported = sum(str(w.message).startswith(runtime.SYNC_WARNING)
                   for w in log)
    print(f"syncs over 12 frames: counted {counted}, reported {reported}")
    assert counted == reported > 0


@pytest.mark.cuda
def test_span_contains_its_kernel_on_the_device_clock(dev):
    """A span around a planted kernel and a synchronize holds the kernel's
    device event, mapped onto the host clock as the benchmark maps it."""
    prof = harness._start_profiler(dev)
    # the profiler may miss the first kernel after its start: give it one
    torch.ones(1, device=dev).add_(1)
    torch.cuda.synchronize()
    time.sleep(0.1)
    t_open = time.perf_counter()
    with runtime.span("sleep") as s:
        torch.cuda._sleep(50_000_000)
        torch.cuda.synchronize()
    torch.ones(1, device=dev).add_(1)
    torch.cuda.synchronize()
    prof.stop()
    events = harness._device_events(prof, harness.Window(t_open, 60.0))
    spin = [(a, b) for name, a, b in events if "spin_kernel" in name]
    assert len(spin) == 1, [(n[:60], a - t_open, b - t_open)
                            for n, a, b in events]
    a, b = spin[0]
    assert b - a > 0.005
    assert s.t0 * 1e-9 - 1e-3 <= a and b <= s.t1 * 1e-9 + 1e-3
