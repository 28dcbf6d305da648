"""``sense_ms.track`` and ``sensed_share.dba``: on spans made by hand, and
on a traced tiny run of the RGB-D cell and of a monocular one on the
CPU (a rehearsal of the readers, never a measurement)."""
from types import SimpleNamespace

import pytest

from nerf_slam_tpu_torch.utils import runtime
from portbench import harness

NAMES = ("sense_ms.track", "sensed_share.dba")


def _span(name, t0_s, t1_s, **ids):
    s = runtime.Span(name, ids, None, "slam")
    s.t0, s.t1 = int(t0_s * 1e9), int(t1_s * 1e9)
    return s


def test_readers_on_spans_made_by_hand(monkeypatch):
    run = SimpleNamespace(t_open=10.0, t_close=20.0)
    done = [_span("track.sense", 10.1, 10.102),
            _span("track.sense", 11.0, 11.004),
            _span("track.sense", 9.0, 9.5),         # before the window
            _span("track.dba", 10.5, 10.51, sensed_px=300, depth_px=400),
            _span("track.dba", 11.5, 11.51, sensed_px=100, depth_px=400),
            _span("track.dba", 20.5, 20.51, sensed_px=0, depth_px=999)]
    monkeypatch.setattr(runtime.RECORDER, "done", done)
    assert harness.load_reader("sense_ms.track")(run) == pytest.approx(3.0)
    assert harness.load_reader("sensed_share.dba")(run) == pytest.approx(
        50.0)
    # the prior dropped from every solve: 0, not nothing
    monkeypatch.setattr(runtime.RECORDER, "done", [
        _span("track.dba", 10.5, 10.51, sensed_px=0, depth_px=400)])
    assert harness.load_reader("sensed_share.dba")(run) == 0.0


@pytest.mark.parametrize("done", [
    [],
    # a monocular cell: solves with no depth pixels, no sensing
    [_span("track.dba", 10.5, 10.51, sensed_px=0, depth_px=0)],
    # a program whose solves carry no counts
    [_span("track.dba", 10.5, 10.51)],
])
def test_readers_read_nothing_where_nothing_was_sensed(monkeypatch, done):
    run = SimpleNamespace(t_open=10.0, t_close=20.0)
    monkeypatch.setattr(runtime.RECORDER, "done", done)
    for name in NAMES:
        assert harness.load_reader(name)(run) is None, name


def test_readers_without_the_recorder(monkeypatch):
    monkeypatch.delattr(runtime, "spans")
    run = SimpleNamespace(t_open=10.0, t_close=20.0)
    for name in NAMES:
        assert harness.load_reader(name)(run) is None, name


@pytest.mark.parametrize("workload,sensed", [
    ("sigma_rgbd_384x512.orbit", True),
    ("sigma_mono_384x512.orbit", False),
])
def test_readers_on_a_traced_tiny_run(workload, sensed):
    """Every frame of the RGB-D cell carries a depth over the whole room,
    so every solve's depth pixels carry the prior: the share is 100%; the
    sensing time is the mean of the window's ``track.sense`` spans.  The
    monocular cell gives neither."""
    _, _, config, _ = harness.load_cell(workload)
    run, _, _, _ = harness.run_cell(workload, 3000000017, 6.0, True, "cpu",
                                    overrides=harness.tiny_overrides(config))
    share = harness.load_reader("sensed_share.dba")(run)
    ms = harness.load_reader("sense_ms.track")(run)
    if not sensed:
        assert share is None and ms is None
        return
    lo, hi = run.t_open * 1e9, run.t_close * 1e9
    spans = [s for s in runtime.spans("track.sense") if lo <= s.t0 < hi]
    assert share == 100.0
    assert ms == pytest.approx(
        sum(1e-6 * (s.t1 - s.t0) for s in spans) / len(spans))
    # one span a frame; the frame in flight at the close may sense after
    assert 0 < len(spans) <= len(run.window_frames()) <= len(spans) + 1
