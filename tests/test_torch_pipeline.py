"""The port's main path end to end on the CPU against the JAX package's:
DataModule -> SlamModule(RaftVisualFrontend) -> FusionModule(NerfFusion)
and EvalSink, run sequentially on the same 48x64 synthetic frames with
the trained weights and the filters off.

Tracking at 48x64 is chaotic (see tests/test_torch_frontend.py: the JAX
frontend alone moves its poses by ~0.2 under a 1e-6 relative perturbation
of its intrinsics), so the two pipelines' trajectories are not compared
pose by pose; their ATE-RMSE against ground truth must agree within
0.15 m, about a fifth of the ATE at this size (measured: 0.752 m against
0.754 m here; free-running 12-frame runs differed by up to 0.09 m).
Everything discrete must match exactly.
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import torch

from nerf_slam_tpu.datasets import SyntheticConfig, SyntheticDataset
from nerf_slam_tpu.fusion import NerfFusion as JaxFusion
from nerf_slam_tpu.fusion import NerfFusionConfig as JaxFusionConfig
from nerf_slam_tpu.models import DroidNet as JaxDroidNet
from nerf_slam_tpu.pipeline import modules as jmod
from nerf_slam_tpu.pipeline import runner as jrun
from nerf_slam_tpu.tracking import frontend as jfe
from nerf_slam_tpu.utils import evaluation as jeval
from nerf_slam_tpu.utils.checkpoint import load_arrays, unflatten_into
from nerf_slam_tpu_torch.datasets import SyntheticConfig as TSynthCfg
from nerf_slam_tpu_torch.datasets import SyntheticDataset as TSynth
from nerf_slam_tpu_torch.fusion import NerfFusion, NerfFusionConfig
from nerf_slam_tpu_torch.models import DroidNet, load_flax_weights
from nerf_slam_tpu_torch.pipeline import modules as tmod
from nerf_slam_tpu_torch.pipeline import runner as trun
from nerf_slam_tpu_torch.tracking import frontend as tfe
from nerf_slam_tpu_torch.utils import evaluation as teval

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

H, W, N_FRAMES = 48, 64, 10
WEIGHTS = os.path.join(os.path.dirname(__file__), "..",
                       "weights_synthetic.npz")
FRONTEND = dict(buffer=12, e_active=24, e_inactive=16, p_window=12,
                k_depth=14, keyframe_warmup=4, max_factors=20,
                motion_filter_thresh=-1.0, keyframe_thresh=-1.0, iters1=1,
                iters2=1, gn_iters=1, damping_scale=1.0,
                damping_offset=1e-4)
FUSION = dict(buffer=12, height=H, width=W, batch_rays=256,
              iters_per_spin=2)


class _JaxF32(jfe.RaftVisualFrontend):
    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.net = JaxDroidNet(dtype=jnp.float32)

    def _alloc_edges(self):
        e = super()._alloc_edges()
        return e._replace(hidden=e.hidden.astype(jnp.float32))


def _wire(mod, run, ds, frontend, fusion):
    data = mod.DataModule(ds)
    slam = mod.SlamModule(frontend)
    fuse = mod.FusionModule(fusion, extra_spins_after_done=2)
    sink = mod.EvalSink()
    run.connect(data, slam, "data")
    run.connect(slam, sink, "slam")
    run.connect(slam, fuse, "slam")
    run.run_sequential([data, slam, fuse, sink])
    return sink


def test_pipeline_matches_jax():
    flat, _ = load_arrays(WEIGHTS)
    jparams = unflatten_into(JaxDroidNet(dtype=jnp.float32).init_params(
        jax.random.PRNGKey(0), H, W), flat)
    jf = _JaxF32(jparams, jfe.FrontendConfig(**FRONTEND), (H, W))
    jfus = JaxFusion(JaxFusionConfig(**FUSION), seed=0)
    jsink = _wire(jmod, jrun, SyntheticDataset(SyntheticConfig(
        n_frames=N_FRAMES, height=H, width=W)), jf, jfus)

    tnet = load_flax_weights(DroidNet(dtype=torch.float32), flat)
    tf = tfe.RaftVisualFrontend(tnet, tfe.FrontendConfig(**FRONTEND),
                                (H, W), device="cpu")
    tfus = NerfFusion(NerfFusionConfig(**FUSION), seed=0, device="cpu")
    tsink = _wire(tmod, trun, TSynth(TSynthCfg(n_frames=N_FRAMES, height=H,
                                               width=W)), tf, tfus)

    assert tf.kf_idx == jf.kf_idx == N_FRAMES - 1
    assert tf.stop and jf.stop
    assert len(tsink.packets) == len(jsink.packets)
    assert tsink.last_full["viz_count"] == jsink.last_full["viz_count"]
    np.testing.assert_array_equal(tsink.last_full["viz_idx"],
                                  jsink.last_full["viz_idx"])
    assert tfus.iteration == jfus.iteration > 0
    np.testing.assert_array_equal(tfus.train_set.valid.numpy(),
                                  np.asarray(jfus.train_set.valid))

    est_t, gt_t = teval.trajectory_from_packet(tsink.last_full)
    est_j, gt_j = jeval.trajectory_from_packet(jsink.last_full)
    np.testing.assert_allclose(gt_t, gt_j, atol=1e-6)
    assert np.isfinite(est_t).all()
    ate_t, ate_j = teval.ate_rmse(est_t, gt_t), jeval.ate_rmse(est_j, gt_j)
    assert abs(ate_t - ate_j) <= 0.15, (ate_t, ate_j)
    # the map trained: rendering a training view gives finite images
    row = tfus.evaluate_training_views(max_views=2)
    assert np.isfinite(row["psnr"])


def test_ate_matches_jax_on_the_same_trajectory():
    """The evaluation helpers agree on a given trajectory (f64: 1e-9)."""
    rng = np.random.RandomState(0)
    poses = rng.randn(12, 7).astype(np.float32)
    poses[:, 3:] /= np.linalg.norm(poses[:, 3:], axis=-1, keepdims=True)
    gt = np.tile(np.eye(4, dtype=np.float32), (12, 1, 1))
    gt[:, :3, 3] = rng.randn(12, 3)
    pkt = {"cam0_poses": poses, "gt_poses": gt, "viz_count": 10}
    est_t, g_t = teval.trajectory_from_packet(pkt)
    est_j, g_j = jeval.trajectory_from_packet(pkt)
    np.testing.assert_allclose(est_t, est_j, atol=1e-5)
    np.testing.assert_allclose(teval.ate_rmse(est_t, g_t),
                               jeval.ate_rmse(est_j, g_j), rtol=1e-5)
    R, t, s = teval.umeyama_alignment(est_t, g_t)
    Rj, tj, sj = jeval.umeyama_alignment(est_t, g_t)
    np.testing.assert_allclose(R, Rj, atol=1e-9)
    np.testing.assert_allclose(t, tj, atol=1e-9)
    np.testing.assert_allclose(s, sj, rtol=1e-9)
