"""Headless visualization of the SLAM stream and its live HTTP viewer."""
from .headless import HeadlessGui, backproject_packet, write_ply  # noqa
from .viewer import LiveViewer  # noqa: F401
