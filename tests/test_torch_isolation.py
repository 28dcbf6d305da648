"""The port stands alone: no module of ``nerf_slam_tpu_torch`` and not
``chip_smoke.py`` imports JAX, flax, optax or the JAX package.

Checked in a fresh interpreter, whose ``sys.modules`` would hold any of
them after importing every module of the port."""
import os
import subprocess
import sys

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "nerf_slam_tpu")

_PROBE = f"""
import importlib, pkgutil, sys
sys.path.insert(0, {ROOT!r})
before = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]
import nerf_slam_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    nerf_slam_tpu_torch.__path__, 'nerf_slam_tpu_torch.')]
for name in names + ['chip_smoke']:
    importlib.import_module(name)
after = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})
print(len(names), before, after)
"""


def test_port_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n, before, after = out.stdout.strip().split(" ", 2)
    assert int(n) >= 30, out.stdout          # every module was imported
    assert before == "[]", before            # the interpreter started clean
    assert after == "[]", after
