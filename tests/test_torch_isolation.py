"""The port stands alone: no module of ``nerf_slam_tpu_torch`` and not
``chip_smoke.py`` imports JAX, flax, optax or the JAX package, nor, at
import time, the optional readers the card may lack (OpenCV, PyYAML,
Pillow, pyrealsense2).

Checked in a fresh interpreter, whose ``sys.modules`` would hold any of
them after importing every module of the port."""
import os
import subprocess
import sys

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "nerf_slam_tpu")
OPTIONAL = ("cv2", "yaml", "PIL", "pyrealsense2")

_PROBE = """
import importlib, pkgutil, sys
sys.path.insert(0, {root!r})
before = [m for m in sys.modules if m.split('.')[0] in {names!r}]
import nerf_slam_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    nerf_slam_tpu_torch.__path__, 'nerf_slam_tpu_torch.')]
for name in names + ['chip_smoke']:
    importlib.import_module(name)
after = sorted(m for m in sys.modules if m.split('.')[0] in {names!r})
print(len(names), before, after)
print(" ".join(names))
"""


def _probe(names):
    return subprocess.run(
        [sys.executable, "-c", _PROBE.format(root=ROOT, names=names)],
        cwd=ROOT, capture_output=True, text=True, timeout=300)


# modules the walk must reach (a package without __init__.py is skipped)
REACHED = ("nerf_slam_tpu_torch.slam.imu",
           "nerf_slam_tpu_torch.slam.meta_slam",
           "nerf_slam_tpu_torch.solver.factor_graph",
           "nerf_slam_tpu_torch.solver.nonlinear",
           "nerf_slam_tpu_torch.solver.ba", "nerf_slam_tpu_torch.solver.schur",
           "nerf_slam_tpu_torch.models.training",
           "nerf_slam_tpu_torch.models.weights",
           "nerf_slam_tpu_torch.cli.train_droid_synthetic")


def test_port_imports_no_jax():
    out = _probe(FORBIDDEN)
    assert out.returncode == 0, out.stderr
    counts, walked = out.stdout.strip().split("\n")
    assert set(REACHED) <= set(walked.split()), walked
    n, before, after = counts.split(" ", 2)
    assert int(n) >= 37, out.stdout          # every module was imported
    assert before == "[]", before            # the interpreter started clean
    assert after == "[]", after


def test_port_imports_no_optional_reader():
    out = _probe(OPTIONAL)
    assert out.returncode == 0, out.stderr
    n, before, after = out.stdout.strip().split("\n")[0].split(" ", 2)
    assert int(n) >= 49, out.stdout          # the readers' modules too
    assert before == "[]", before
    assert after == "[]", after
