"""``graph_share.dba`` on synthetic spans."""
import importlib.util
from pathlib import Path
from types import SimpleNamespace

from nerf_slam_tpu_torch.utils import runtime

READER = Path(__file__).resolve().parent.parent / "metrics" \
    / "graph_share.dba.py"


def _read(run):
    spec = importlib.util.spec_from_file_location("m_graph_share_dba",
                                                  READER)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def _dba(t0_s, child=None):
    """A closed ``track.dba`` span starting at ``t0_s`` seconds, with a
    child span of that name if one is given."""
    s = runtime.Span("track.dba", {}, None, "slam")
    s.t0, s.t1 = int(t0_s * 1e9), int((t0_s + 0.01) * 1e9)
    if child is not None:
        c = runtime.Span(child, {}, s, "slam")
        c.t0, c.t1 = s.t0 + 1000, s.t1 - 1000
        s.children.append(c)
    return s


def test_share_of_window_calls_with_a_replay(monkeypatch):
    run = SimpleNamespace(t_open=10.0, t_close=20.0)
    done = [_dba(11.0, "dba.replay"), _dba(12.0, "dba.capture"),
            _dba(13.0), _dba(19.5, "dba.replay"),
            _dba(9.0, "dba.replay"), _dba(20.0)]      # outside the window
    monkeypatch.setattr(runtime.RECORDER, "done", done)
    assert _read(run) == 50.0
    monkeypatch.setattr(runtime.RECORDER, "done", done[:1] + done[3:5])
    assert _read(run) == 100.0


def test_nothing_without_spans(monkeypatch):
    run = SimpleNamespace(t_open=10.0, t_close=20.0)
    monkeypatch.setattr(runtime.RECORDER, "done", [])
    assert _read(run) is None
    monkeypatch.setattr(runtime.RECORDER, "done", [_dba(5.0, "dba.replay")])
    assert _read(run) is None
