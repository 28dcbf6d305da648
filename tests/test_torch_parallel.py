"""The port's ``parallel/`` against the JAX package's, and its edge-sharded
tracker against its unsharded one, on the CPU.

JAX runs its ``shard_map`` steps on the 8 virtual CPU devices of
tests/conftest.py; the port runs its shards in one process, every shard
on the CPU (``parallel.tracking.shard_devices``).  The sharded DBA step
is held to JAX's tolerances against both JAX's sharded step and its
single-device step; the data-parallel NGP step starts from JAX's initial
parameters and takes each shard's ray samples from JAX's ``fold_in``
keys.  Also: Adam's update against optax's, the GRU's pool over edge
shards, ``fusion_device`` and ``NERF_SLAM_TPU_NO_LOCK``.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from nerf_slam_tpu.fusion import hashgrid as jhash
from nerf_slam_tpu.fusion import ngp as jngp
from nerf_slam_tpu.geometry import camera as jcam
from nerf_slam_tpu.geometry import se3 as jse3
from nerf_slam_tpu.parallel import mapping as jmapping
from nerf_slam_tpu.parallel import tracking as jtracking
from nerf_slam_tpu.solver import dba as jdba
from nerf_slam_tpu_torch.datasets import SyntheticConfig, SyntheticDataset
from nerf_slam_tpu_torch.fusion import hashgrid as thash
from nerf_slam_tpu_torch.fusion import ngp as tngp
from nerf_slam_tpu_torch.models import DroidNet
from nerf_slam_tpu_torch.parallel import mapping, tracking
from nerf_slam_tpu_torch.solver import dba as tdba
from nerf_slam_tpu_torch.tracking import FrontendConfig, RaftVisualFrontend
from nerf_slam_tpu_torch.utils import runtime

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several test processes on a
    few cores, where many threads a process contend and slow every test
    far more than one thread does."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _dba_inputs():
    """tests/test_parallel.py's one-step problem: 4 keyframes, 6 edges in
    8 slots, one GN step from perturbed poses."""
    n, h, w = 4, 6, 8
    key = jax.random.PRNGKey(0)
    poses_gt = jse3.exp(0.05 * jax.random.normal(key, (n, 6)))
    disps = 0.8 * jnp.ones((n, h, w))
    intr = jnp.tile(jnp.array([[10.0, 10.0, w / 2, h / 2]]), (n, 1))
    ii = np.array([0, 1, 2, 1, 2, 3])
    jj = np.array([1, 2, 3, 0, 1, 2])
    E = 8
    target, valid, _ = jcam.projective_transform(
        poses_gt, disps, intr, jnp.asarray(ii), jnp.asarray(jj))
    tpad = jnp.zeros((E, h, w, 2)).at[: len(ii)].set(target)
    wpad = jnp.zeros((E, h, w, 2)).at[: len(ii)].set(
        jnp.ones_like(target) * valid)
    poses0 = jse3.retr(poses_gt, 0.01 * jax.random.normal(key, (n, 6))
                       .at[0].set(0.0))
    eta = 1e-4 * jnp.ones((n, h, w))
    sens = jnp.zeros((n, h, w))
    return (ii, jj, E, n), (poses0, disps, intr, tpad, wpad, eta, sens)


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_dba_step_matches_jax(n):
    """One edge-sharded GN step: within JAX's tolerances of JAX's sharded
    step and of its single-device step (poses 5e-5, disps 5e-4)."""
    (ii, jj, E, N), args = _dba_inputs()
    jplan = jdba.plan(ii, jj, 0, N, E=E, P=N, K=N)
    single = jdba.dba_iterations(*args[:5], args[5], args[6], jplan,
                                 iters=1, ep=0.1, lm=1e-4,
                                 compute_covariances=False)
    jstep = jtracking.make_sharded_dba_step(
        Mesh(np.array(jax.devices()[:n]), ("edge",)))
    jp, jd = jstep(*args, jplan)
    tplan = tdba.plan(ii, jj, 0, N, E=E, P=N, K=N, device="cpu")
    tp, td = tracking.make_sharded_dba_step(["cpu"] * n)(
        *[_t(a) for a in args], tplan)
    for want_p, want_d in ((jp, jd), (single.poses, single.disps)):
        np.testing.assert_allclose(tp.numpy(), np.asarray(want_p),
                                   atol=5e-5)
        np.testing.assert_allclose(td.numpy(), np.asarray(want_d),
                                   atol=5e-4)


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_dba_dryrun_converges(n):
    ratio = tracking.dryrun(n, device="cpu")
    assert ratio < 0.7, ratio


def test_sharded_dba_step_rejects_uneven_edges():
    (ii, jj, E, N), args = _dba_inputs()
    tplan = tdba.plan(ii, jj, 0, N, E=E, P=N, K=N, device="cpu")
    with pytest.raises(ValueError, match="divide"):
        tracking.make_sharded_dba_step(["cpu"] * 3)(
            *[_t(a) for a in args], tplan)


def test_torch_adam_matches_optax_adam():
    """torch.optim.Adam(lr=1e-2) and optax.adam(1e-2) take the same steps
    (the same formula, rounded in a different order: a few f32 ulps of
    parameters below 4 in magnitude)."""
    rng = np.random.RandomState(0)
    p0 = rng.randn(64).astype(np.float32)
    grads = [rng.randn(64).astype(np.float32) * s for s in (1.0, 1e-3, 10.0)]
    opt = optax.adam(1e-2)
    pj = jnp.asarray(p0)
    state = opt.init(pj)
    pt = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    topt = torch.optim.Adam([pt], lr=1e-2)
    for g in grads:
        upd, state = opt.update(jnp.asarray(g), state, pj)
        pj = optax.apply_updates(pj, upd)
        pt.grad = torch.from_numpy(g)
        topt.step()
        np.testing.assert_allclose(pt.detach().numpy(), np.asarray(pj),
                                   rtol=0, atol=4 * 2.4e-7)


def _dp_setup(n):
    """jax mapping.dryrun's configuration, batch and initial parameters."""
    cfg = jngp.NGPConfig(n_uniform=8, n_depth=4, encoding="hash")._replace(
        grid=jhash.HashGridConfig(n_levels=2, log2_table_size=8,
                                  base_resolution=4, finest_resolution=8))
    params, field = jngp.init_ngp(jax.random.PRNGKey(0), cfg)
    R = 8 * n
    key = jax.random.PRNGKey(1)
    batch = {"origins": jnp.full((R, 3), 0.5),
             "dirs": jax.random.normal(key, (R, 3)) * 0.3,
             "rgb": jax.random.uniform(key, (R, 3)),
             "depth": jnp.full((R,), 0.4),
             "depth_w": jnp.ones((R,))}
    return cfg, params, field, batch, key


def _fields_state(tfield):
    return {k: v.detach().float().numpy()
            for k, v in tfield.state_dict().items()}


@pytest.mark.parametrize("n", [2, 4])
def test_dp_train_step_matches_jax(n):
    """One data-parallel step from JAX's initial parameters, each shard's
    samples drawn from JAX's fold_in(key, shard) keys: the losses agree
    within 1e-5 relative (measured: 7e-8).  After the Adam step the
    parameters agree within 2e-6, but for at most 0.5% of them, which
    agree within 1e-3 (measured: 15 of 8,787 entries, up to 4.8e-4):
    Adam's first step is lr * g / (|g| + 1e-8), so an entry whose
    gradient is near 1e-8 moves by a fraction of lr = 1e-2 that the
    gradient's last bits decide, and those bits come from bf16 MLPs that
    the two packages round at different places."""
    cfg_j, params, jfield, batch, key = _dp_setup(n)
    opt = optax.adam(1e-2)
    jstep = jmapping.make_dp_train_step(
        Mesh(np.array(jax.devices()[:n]), ("data",)), jfield, cfg_j, opt)
    params1, _, loss_j = jstep(params, opt.init(params), batch, key)

    cfg_t = tngp.NGPConfig(n_uniform=8, n_depth=4, encoding="hash",
                           grid=thash.HashGridConfig(
                               n_levels=2, log2_table_size=8,
                               base_resolution=4, finest_resolution=8))
    tfield = tngp.load_ngp_params(tngp.NGPField(cfg_t), params.table,
                                  params.mlp)
    Rs = batch["origins"].shape[0] // n
    draws = []
    for s in range(n):
        k1, k2 = jax.random.split(jax.random.fold_in(key, s))
        draws.append(tuple(_t(x) for x in (
            jax.random.uniform(k1, (Rs, cfg_j.n_uniform)),
            jax.random.normal(k2, (Rs, cfg_j.n_depth)),
            jax.random.uniform(k2, (Rs, cfg_j.n_depth)))))
    step = mapping.make_dp_train_step(
        ["cpu"] * n, tfield, cfg_t,
        torch.optim.Adam(tfield.parameters(), lr=1e-2))
    loss_t = step({k: _t(v) for k, v in batch.items()}, seed=0,
                  draws=draws)
    assert abs(float(loss_t) - float(loss_j)) <= 1e-5 * abs(float(loss_j))

    want = _fields_state(tngp.load_ngp_params(tngp.NGPField(cfg_t),
                                              params1.table, params1.mlp))
    got = _fields_state(tfield)
    off = sum(int((np.abs(got[k] - want[k]) > 2e-6).sum()) for k in want)
    total = sum(v.size for v in want.values())
    assert off <= 0.005 * total, (off, total)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-3)


@pytest.mark.parametrize("n", [2, 4])
def test_dp_dryrun_and_generators(n):
    """The port's dryrun gives a finite loss; two steps from the same
    seed repeat to the bit, and the shards draw different samples."""
    assert np.isfinite(mapping.dryrun(n, device="cpu"))
    g = [mapping.shard_generator(3, s, "cpu") for s in range(n)]
    a = [torch.rand(4, generator=x) for x in g]
    assert not torch.equal(a[0], a[1])
    assert torch.equal(torch.rand(4, generator=mapping.shard_generator(
        3, 1, "cpu")), a[1])


def test_sharded_pool_matches_unsharded():
    """update and aggregate with the edges split over 2 shards (one
    segment's edges in both, in unequal numbers) match the unsharded call
    within bf16 rounding; a pool that divided per shard would not."""
    torch.manual_seed(0)
    net = DroidNet(dtype=torch.bfloat16).eval()
    E, h, w, K = 8, 5, 6, 3
    g = torch.Generator().manual_seed(1)

    def rnd(*shape):
        return torch.randn(shape, generator=g).to(torch.bfloat16)

    hid, inp, corr, flow = (rnd(E, h, w, 128), rnd(E, h, w, 128),
                            rnd(E, h, w, 196), rnd(E, h, w, 4))
    seg = torch.tensor([0, 0, 0, 1, 0, 1, 2, -1])
    with torch.no_grad():
        want = net.update(hid, inp, corr, flow, seg, K)
        halves = (slice(0, 4), slice(4, 8))
        outs = [net.update(hid[sl], inp[sl], corr[sl], flow[sl])
                for sl in halves]
        nets, segs = [o[0] for o in outs], [seg[sl] for sl in halves]
        eta, upmask = net.aggregate(nets, segs, K)
        eta_only = net.eta(nets, segs, K)
        # the mean of the shards' means: what a per-shard division gives
        wrong = 0.5 * (net.aggregate(nets[0], segs[0], K)[0]
                       + net.aggregate(nets[1], segs[1], K)[0])
    for i in range(3):
        assert torch.equal(torch.cat([o[i] for o in outs]), want[i])
    np.testing.assert_allclose(eta.numpy(), want[3].numpy(), rtol=2e-2,
                               atol=1e-5)
    np.testing.assert_allclose(upmask.numpy(), want[4].numpy(), rtol=2e-2,
                               atol=2e-2)
    assert torch.equal(eta, eta_only)
    assert float((wrong - want[3]).abs().max()) > \
        10 * float((eta - want[3]).abs().max())


# tests/test_parallel.py's sharded-tracker setting (random weights, bf16)
_SMALL = dict(buffer=10, e_active=24, e_inactive=16, p_window=10,
              k_depth=12, keyframe_warmup=4, max_factors=20,
              motion_filter_thresh=-1.0, keyframe_thresh=-1.0, iters1=1,
              iters2=1, gn_iters=1)


def _track(net, frames, shards, corr_impl):
    fe = RaftVisualFrontend(net, FrontendConfig(
        edge_shards=shards, corr_impl=corr_impl, **_SMALL),
        frames[0]["images"].shape[:2], device="cpu")
    for k, pkt in enumerate(frames):
        fe(k, pkt)
    n, st = fe.kf_idx, fe.state
    return (st.cam_T_world[:n].clone(), st.idepths[:n].clone(),
            st.pose_cov[:n].clone(), n)


@pytest.mark.parametrize("corr_impl", ["pallas4g", "onehot"])
def test_sharded_tracker_matches_unsharded(capsys, corr_impl):
    """The tracker with edge_shards=4 against edge_shards=1 at the JAX
    test's setting and tolerances (48x64, 8 frames; poses 1e-3, disps
    2e-2, covariances rtol 0.15) and the same keyframe count; two runs at
    2 shards give the same bits.  "pallas4g" runs kernel #1's plain
    version on each shard's slots with the shard's own active count."""
    torch.manual_seed(0)
    net = DroidNet(dtype=torch.bfloat16)
    ds = SyntheticDataset(SyntheticConfig(n_frames=8, height=48, width=64))
    frames = [ds[k] for k in range(len(ds))]
    p1, d1, c1, n1 = _track(net, frames, 1, corr_impl)
    p4, d4, c4, n4 = _track(net, frames, 4, corr_impl)
    a = _track(net, frames, 2, corr_impl)
    b = _track(net, frames, 2, corr_impl)
    assert "edge_shards=4 over 1 device: cpu x4" in capsys.readouterr().out
    assert n1 == n4 == a[3] == b[3] and n1 >= 6
    np.testing.assert_allclose(p4.numpy(), p1.numpy(), atol=1e-3)
    np.testing.assert_allclose(d4.numpy(), d1.numpy(), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(c4.numpy(), c1.numpy(), rtol=0.15, atol=1e-6)
    assert all(torch.equal(x, y) for x, y in zip(a[:3], b[:3]))


def test_tracker_refuses_uneven_shards():
    """e_active and e_inactive must divide edge_shards, as JAX asserts."""
    with pytest.raises(ValueError,
                       match="e_active/e_inactive must divide edge_shards=3"):
        RaftVisualFrontend(DroidNet(dtype=torch.float32),
                           FrontendConfig(edge_shards=3, **_SMALL),
                           (48, 64), device="cpu")


def test_shard_placement(monkeypatch):
    """Round robin over the visible devices of the base device's type,
    shard 0 on the base device itself."""
    assert tracking.shard_devices(3, "cpu") == [torch.device("cpu")] * 3
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    devs = tracking.shard_devices(4, "cuda:0")
    assert [str(d) for d in devs] == ["cuda:0", "cuda:1", "cuda:0",
                                      "cuda:1"]
    assert tracking.placement(devs) == \
        "over 2 devices: cuda:0 x2, cuda:1 x2"


def test_fusion_device(monkeypatch, capsys):
    """Mapping goes to the second device of the base's type under the
    split, else stays (None) with JAX's line."""
    line = ("device_split requested but only one device visible; "
            "falling back to shared-device scheduling")
    assert runtime.fusion_device(False, "cuda") is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert runtime.fusion_device(True, "cuda") == torch.device("cuda", 1)
    assert capsys.readouterr().out == ""
    assert runtime.fusion_device(True, "cpu") is None
    assert line in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert runtime.fusion_device(True, "cuda") is None
    assert line in capsys.readouterr().out


@pytest.mark.parametrize("env,kind", [("1", "_NullLock"), ("", "RLock")])
def test_no_lock_env(env, kind):
    """NERF_SLAM_TPU_NO_LOCK=1 makes DEVICE_LOCK a no-op (a fresh
    interpreter: the lock is chosen at import); pipeline re-exports it."""
    probe = ("from nerf_slam_tpu_torch.utils import runtime\n"
             "from nerf_slam_tpu_torch import pipeline\n"
             "assert pipeline.DEVICE_LOCK is runtime.DEVICE_LOCK\n"
             "with runtime.DEVICE_LOCK:\n"
             "    print(type(runtime.DEVICE_LOCK).__name__)\n")
    envv = {k: v for k, v in os.environ.items()
            if k != "NERF_SLAM_TPU_NO_LOCK"}
    if env:
        envv["NERF_SLAM_TPU_NO_LOCK"] = env
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=envv,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert kind in out.stdout
