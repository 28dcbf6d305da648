"""A run with the timed path broken underneath comes out not correct,
and so does the control (the reference one precision lower in the
program's place).  Tiny sizes on the CPU: the harness's look for a card
is skipped, the rest of a run is driven as on the card, and each number
is held to the limits set from the card's readings."""
import argparse
import time

import pytest
import torch

from portbench import harness
from portbench import run as prun

SEED = 2 ** 31 + 1234


def measure(workload, faults=None, control=False, seconds=40.0):
    bench, entry, config, _ = harness.load_cell(workload)
    args = argparse.Namespace(workload=workload, seed=SEED, seconds=seconds,
                              trace=0, control=control)
    return prun.measure(args, bench, entry, config, time.perf_counter(),
                        device="cpu", overrides=harness.tiny_overrides(config),
                        faults=faults)


def failed(res):
    return [k for k, v in res["checks"].items()
            if v["limit"] is not None and v["value"] is not None
            and v["value"] > v["limit"]]


def state_unchanged(cell):
    """Every BA step returns the poses and depths it was given."""
    from nerf_slam_tpu_torch.solver import dba
    orig = dba.dba_iterations

    def unchanged(poses, disps, *a, **k):
        return poses, disps
    dba.dba_iterations = unchanged
    cell.restore = lambda: setattr(dba, "dba_iterations", orig)


def answer_altered(cell):
    """The motion filter's magnitude, 5% high where it is produced."""
    from nerf_slam_tpu_torch.tracking.frontend import RaftVisualFrontend
    orig = RaftVisualFrontend._motion_mag

    def altered(self, feat, kf):
        return orig(self, feat, kf) * 1.05
    RaftVisualFrontend._motion_mag = altered
    cell.restore = lambda: setattr(RaftVisualFrontend, "_motion_mag", orig)


def half_batch(cell):
    """The map's loss over half of the batch: every ray is rendered, the
    means are taken over the first half of them (the program's loss
    otherwise)."""
    from nerf_slam_tpu_torch.fusion import nerf_fusion
    from nerf_slam_tpu_torch.fusion.nerf_fusion import NerfFusion
    orig = NerfFusion.loss

    def half(self, batch, depth_mult=1.0, pose_grad=True):
        cfg, ts = self.cfg, self.train_set
        xi = torch.round(batch.uv[:, 0] * (cfg.width - 1)).long()
        yi = torch.round(batch.uv[:, 1] * (cfg.height - 1)).long()
        fx, fy, cx, cy = ts.intrinsics[batch.img_idx].unbind(-1)
        dirs_cam = torch.stack([(xi + 0.5 - cx) / fx, (yi + 0.5 - cy) / fy,
                                torch.ones_like(fx)], dim=-1)
        tgt_rgb = ts.images[batch.img_idx, yi, xi]
        tgt_depth = ts.depths[batch.img_idx, yi, xi]
        tgt_cov = ts.depths_cov[batch.img_idx, yi, xi]
        d_valid = (tgt_depth > 0).float()
        c2w = ts.c2w[batch.img_idx]
        dirs = torch.einsum("rij,rj->ri", c2w[:, :3, :3], dirs_cam)
        t = nerf_fusion.sample_along_rays(tgt_depth, d_valid, cfg.ngp,
                                          batch.samples)
        rgb, depth, acc, _ = nerf_fusion.render_rays(
            self.field, cfg.ngp, c2w[:, :3, 3], dirs, t)
        n = rgb.shape[0] // 2
        rgb, depth, acc, tgt_rgb, tgt_depth, tgt_cov, d_valid = (
            x[:n] for x in (rgb, depth, acc, tgt_rgb, tgt_depth, tgt_cov,
                            d_valid))
        l_rgb = ((rgb - tgt_rgb) ** 2).mean()
        depth = depth / torch.clamp(acc, min=0.25)
        w = d_valid / (tgt_cov / (cfg.scale ** 2) + 1e-2)
        nv = torch.clamp(d_valid.sum(), min=1.0)
        l_d = (w * (depth - tgt_depth) ** 2).sum() / nv
        l_acc = (d_valid * (1.0 - acc) ** 2).sum() / nv
        loss = cfg.ngp.rgb_weight * l_rgb + cfg.ngp.depth_weight \
            * depth_mult * (l_d + l_acc)
        return loss, l_rgb, l_d
    NerfFusion.loss = half
    cell.restore = lambda: setattr(NerfFusion, "loss", orig)


def map_step_unchanged(cell):
    """Each map step computes its loss and gradient, and leaves the field's
    parameters as it found them."""
    from nerf_slam_tpu_torch.fusion.nerf_fusion import NerfFusion
    orig = NerfFusion.train_step

    def unchanged(self, batch=None):
        saved = [p.detach().clone() for p in self.field.parameters()]
        loss = orig(self, batch)
        with torch.no_grad():
            for p, s in zip(self.field.parameters(), saved):
                p.copy_(s)
        return loss
    NerfFusion.train_step = unchanged
    cell.restore = lambda: setattr(NerfFusion, "train_step", orig)


def integration_altered(cell):
    """Each depth reading 1% long where the TSDF integrates it."""
    from nerf_slam_tpu_torch.fusion.tsdf_fusion import TsdfFusion
    orig = TsdfFusion._integrate

    def altered(self, volume, w2c, intr, depth, weight, color):
        return orig(self, volume, w2c, intr, depth * 1.01, weight, color)
    TsdfFusion._integrate = altered
    cell.restore = lambda: setattr(TsdfFusion, "_integrate", orig)


@pytest.mark.parametrize("workload,fault,caught_by", [
    ("sigma_mono_384x512.orbit", state_unchanged, "dba_gap"),
    ("sigma_mono_384x512.orbit", answer_altered, "motion_gap"),
    ("sigma_mono_384x512.orbit", integration_altered, "tsdf_gap"),
    ("ngp_mono_344x616.orbit", half_batch, "map_step_gap"),
    ("ngp_mono_344x616.orbit", map_step_unchanged, "map_step_gap"),
])
def test_broken_timed_path_is_not_correct(workload, fault, caught_by):
    holder = {}

    def install(cell):
        fault(cell)
        holder["cell"] = cell
    try:
        res = measure(workload, faults=install)
    finally:
        if "cell" in holder:
            holder["cell"].restore()
    assert res["correct"] is False
    assert caught_by in failed(res), res["checks"]


@pytest.mark.parametrize("workload", ["sigma_mono_384x512.orbit",
                                      "ngp_mono_344x616.orbit"])
def test_control_is_not_correct(workload):
    res = measure(workload, control=True)
    assert res["correct"] is False
    assert failed(res), res["checks"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control at the cell's size")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["ngp_mono_344x616.orbit",
                                      "sigma_mono_384x512.orbit",
                                      "ngp_mono_344x616.handheld",
                                      "sigma_mono_384x512.handheld"])
def test_control_at_the_cells_size_is_not_correct(card, workload):
    bench, entry, config, _ = harness.load_cell(workload)
    for seed in (SEED, SEED + 1, SEED + 2):
        args = argparse.Namespace(workload=workload, seed=seed, seconds=20.0,
                                  trace=0, control=True)
        res = prun.measure(args, bench, entry, config, time.perf_counter())
        assert res["correct"] is False
        assert failed(res), res["checks"]
