"""The port's DROID training path against the JAX package on the CPU: the
BA of the training unroll (``solver/ba.py``, ``solver/schur.py``) with
its gradients, the one-hot correlation lookup, ``droid_loss`` and its
gradients in f32 and bf16, optax's optimizer chain and the EMA, the
``droid.pth`` converter and the trainer's weight files.

The same inputs, made from a numpy seed (and the JAX parameters carried
across by ``models/convert.py``), go through the JAX function and its
port.  The JAX training oracle runs at 48x64, 4 frames, the edges of
tests/test_training.py and two update iterations."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerf_slam_tpu.datasets import SyntheticConfig as JSynCfg
from nerf_slam_tpu.datasets import SyntheticDataset as JSyn
from nerf_slam_tpu.geometry import camera as jcam
from nerf_slam_tpu.geometry import se3 as jse3
from nerf_slam_tpu.models import DroidNet as JNet
from nerf_slam_tpu.models import training as jtr
from nerf_slam_tpu.models import weights as jweights
from nerf_slam_tpu.ops import corr as jcorr
from nerf_slam_tpu.solver import ba as jba
from nerf_slam_tpu.solver import schur as jschur
from nerf_slam_tpu.utils.checkpoint import _flatten, unflatten_into
from nerf_slam_tpu_torch.cli import slam_demo
from nerf_slam_tpu_torch.cli import train_droid_synthetic as trainer
from nerf_slam_tpu_torch.models import (DroidNet, flax_to_state_dict,
                                        load_flax_weights,
                                        state_dict_to_flax)
from nerf_slam_tpu_torch.models import training as ttr
from nerf_slam_tpu_torch.models import weights as tweights
from nerf_slam_tpu_torch.ops import corr as tcorr
from nerf_slam_tpu_torch.solver import ba as tba
from nerf_slam_tpu_torch.solver import schur as tschur
from nerf_slam_tpu_torch.utils.checkpoint import load_arrays

torch.backends.cuda.matmul.allow_tf32 = False

H, W = 48, 64
h, w = H // 8, W // 8
WEIGHTS = os.path.join(os.path.dirname(__file__), "..",
                       "weights_synthetic.npz")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _t(x, dtype=None):
    return torch.as_tensor(np.array(x), dtype=dtype)


def _close_rel(got, want, rel):
    """Within ``rel`` of the largest magnitude of ``want``."""
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


def _rel_l2(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _edges(n, radius):
    pairs = [(a, b) for a in range(n) for b in range(n)
             if a != b and abs(a - b) <= radius]
    return (np.array([p[0] for p in pairs]), np.array([p[1] for p in pairs]))


# -- BA ----------------------------------------------------------------------

def _ba_problem(seed, n=5, hh=10, ww=14):
    """tests/test_ba.py's toy problem from a numpy seed: GT poses and
    depths, flow targets, perturbed poses and depths (host f32)."""
    rng = np.random.RandomState(seed)
    xi = (0.08 * rng.randn(n, 6)).astype(np.float32)
    xi[0] = 0.0
    poses_gt = np.asarray(jse3.exp(jnp.asarray(xi)))
    disps_gt = (0.6 + 0.4 * rng.rand(n, hh, ww)).astype(np.float32)
    intr = np.tile(np.array([[30.0, 30.0, ww / 2, hh / 2]], np.float32),
                   (n, 1))
    ii, jj = _edges(n, 2)
    target, valid, _ = jcam.projective_transform(
        jnp.asarray(poses_gt), jnp.asarray(disps_gt), jnp.asarray(intr),
        jnp.asarray(ii), jnp.asarray(jj))
    target = np.asarray(target) + 0.3 * rng.randn(*target.shape).astype(
        np.float32)
    weight = (rng.rand(*target.shape) * np.asarray(valid)).astype(np.float32)
    noise = (0.02 * rng.randn(n, 6)).astype(np.float32)
    noise[0] = 0.0
    poses = np.asarray(jse3.retr(jnp.asarray(poses_gt), jnp.asarray(noise)))
    disps = np.maximum(disps_gt + 0.05 * rng.randn(n, hh, ww), 0.1).astype(
        np.float32)
    eta = (1e-4 + 1e-3 * rng.rand(n, hh, ww)).astype(np.float32)
    return dict(target=target.astype(np.float32), weight=weight, eta=eta,
                poses=poses, disps=disps, intr=intr, ii=ii, jj=jj)


def test_build_system_matches_jax():
    """Every per-edge block of the linearization within 1e-4 of each
    block's largest magnitude."""
    p = _ba_problem(0)
    args = ("target", "weight", "poses", "disps", "intr")
    want = jba.build_system(*[jnp.asarray(p[k]) for k in args],
                            jnp.asarray(p["ii"]), jnp.asarray(p["jj"]))
    got = tba.build_system(*[_t(p[k]) for k in args], _t(p["ii"]),
                           _t(p["jj"]))
    for gw, ww_ in zip(got, want):
        for a, b in zip(gw, ww_):
            assert a.shape == b.shape
            _close_rel(a, b, 1e-4)


@pytest.mark.parametrize("fixedp", [1, 2])
def test_ba_and_moba_steps_match_jax(fixedp):
    """One full-BA step and one motion-only step: poses and depths within
    1e-4 of their largest magnitude; three full steps pull the flow
    residual down in both packages."""
    p = _ba_problem(1)
    kw = dict(fixedp=fixedp, ep=0.01, lm=1e-4)
    jargs = [jnp.asarray(p[k]) for k in ("target", "weight", "eta", "poses",
                                         "disps", "intr", "ii", "jj")]
    targs = [_t(p[k]) for k in ("target", "weight", "eta", "poses", "disps",
                                "intr", "ii", "jj")]
    for a, b in zip(tba.ba_step(*targs, **kw), jba.ba_step(*jargs, **kw)):
        _close_rel(a, b, 1e-4)
    no_eta = [0, 1, 3, 4, 5, 6, 7]
    _close_rel(tba.moba_step(*[targs[i] for i in no_eta], **kw),
               jba.moba_step(*[jargs[i] for i in no_eta], **kw), 1e-4)


def test_schur_solve_pd_matches_jax():
    """A positive-definite system with a diagonal depth block: the same
    (dx, dz) within 1e-4 relative, and the dense solution."""
    rng = np.random.RandomState(0)
    P, M, D, HW = 3, 4, 6, 5
    J = rng.randn(40, P * D + M * HW).astype(np.float32)
    Hf = J.T @ J + 0.5 * np.eye(P * D + M * HW, dtype=np.float32)
    vf = rng.randn(P * D + M * HW).astype(np.float32)
    Hpp, Epm = Hf[:P * D, :P * D], Hf[:P * D, P * D:]
    Cmm = np.diagonal(Hf[P * D:, P * D:]) + 50.0
    Hs = Hpp.reshape(P, D, P, D).transpose(0, 2, 1, 3)
    E = Epm.reshape(P, D, M, HW).transpose(0, 2, 1, 3)
    args = (Hs, E, Cmm.reshape(M, HW), vf[:P * D].reshape(P, D),
            vf[P * D:].reshape(M, HW))
    want = jschur.schur_solve(*map(jnp.asarray, args), ep=0.0, lm=0.0)
    got = tschur.schur_solve(*map(_t, args), ep=0.0, lm=0.0)
    for a, b in zip(got, want):
        _close_rel(a, b, 1e-4)
    dense = np.block([[Hpp, Epm], [Epm.T, np.diag(Cmm)]]).astype(np.float64)
    sol = np.linalg.solve(dense, vf.astype(np.float64))
    np.testing.assert_allclose(_np(got[0]).reshape(-1), sol[:P * D],
                               rtol=1e-4, atol=1e-4)


def test_schur_solve_not_pd_is_a_zero_step_as_in_jax():
    """A reduced system that is not positive definite: JAX's Cholesky
    gives NaN and its solve a zero step; the port's too (no exception,
    no NaN)."""
    rng = np.random.RandomState(1)
    P, M, D, HW = 2, 3, 6, 4
    Hs = np.zeros((P, P, D, D), np.float32)
    for i in range(P):
        Hs[i, i] = -np.eye(D)
    E = rng.randn(P, M, D, HW).astype(np.float32)
    C = (1.0 + rng.rand(M, HW)).astype(np.float32)
    v = rng.randn(P, D).astype(np.float32)
    wv = rng.randn(M, HW).astype(np.float32)
    want = jschur.schur_solve(*map(jnp.asarray, (Hs, E, C, v, wv)))
    got = tschur.schur_solve(*map(_t, (Hs, E, C, v, wv)))
    for a, b in zip(got, want):
        assert not np.abs(_np(b)).any()
        np.testing.assert_array_equal(_np(a), _np(b))


def test_ba_step_gradients_match_jax():
    """Gradients of a fixed random scalar of ba_step's output (poses and
    depths) with respect to the target, the weight, eta and the depths:
    within 1e-3 relative L2 of jax.grad's."""
    p = _ba_problem(2)
    rng = np.random.RandomState(3)
    Rp = rng.randn(*p["poses"].shape).astype(np.float32)
    Rd = rng.randn(*p["disps"].shape).astype(np.float32)
    kw = dict(fixedp=1, ep=0.01, lm=1e-4)

    def jscalar(target, weight, eta, disps):
        po, do = jba.ba_step(target, weight, eta, jnp.asarray(p["poses"]),
                             disps, jnp.asarray(p["intr"]),
                             jnp.asarray(p["ii"]), jnp.asarray(p["jj"]), **kw)
        return jnp.sum(po * Rp) + jnp.sum(do * Rd)

    names = ("target", "weight", "eta", "disps")
    gj = jax.jit(jax.grad(jscalar, argnums=(0, 1, 2, 3)))(
        *[jnp.asarray(p[k]) for k in names])
    ins = [_t(p[k]).requires_grad_(True) for k in names]
    po, do = tba.ba_step(ins[0], ins[1], ins[2], _t(p["poses"]), ins[3],
                         _t(p["intr"]), _t(p["ii"]), _t(p["jj"]), **kw)
    gt = torch.autograd.grad((po * _t(Rp)).sum() + (do * _t(Rd)).sum(), ins)
    for n, a, b in zip(names, gt, gj):
        b = np.asarray(b)
        assert np.linalg.norm(b) > 0, n
        assert _rel_l2(_np(a), b) < 1e-3, (n, _rel_l2(_np(a), b))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_lookup_level_onehot_matches_jax(dtype):
    """The training lookup: equal to JAX's one-hot lookup and to the
    port's gather lookup (exact: each tap sums one volume value), and its
    gradient into the volume equal to JAX's VJP within f32 rounding."""
    rng = np.random.RandomState(0)
    E, H1, W1, H2, W2 = 2, 5, 6, 5, 6
    vol = rng.randn(E, H1, W1, H2, W2).astype(np.float32)
    coords = (rng.rand(E, H1, W1, 2) * [W2 + 6, H2 + 6] - 3).astype(
        np.float32)
    ct = rng.randn(E, 49, H1, W1).astype(np.float32)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32" else
                (jnp.bfloat16, torch.bfloat16))
    out_j, vjp = jax.vjp(lambda v: jcorr.lookup_level_onehot(
        v, jnp.asarray(coords)), jnp.asarray(vol).astype(jdt))
    (gj,) = vjp(jnp.asarray(ct))
    vt = _t(vol).to(tdt).requires_grad_(True)
    out_t = tcorr.lookup_level_onehot(vt, _t(coords))
    np.testing.assert_array_equal(
        _np(out_t), _np(tcorr.lookup_level(vt.detach().float(),
                                           _t(coords))))
    np.testing.assert_allclose(_np(out_t), _np(out_j), rtol=0, atol=1e-5)
    (gt,) = torch.autograd.grad(out_t, vt, _t(ct))
    tol = 1e-5 if dtype == "f32" else 2 ** -7 * np.abs(_np(gj)).max()
    np.testing.assert_allclose(_np(gt), _np(gj), rtol=0, atol=tol)


# -- the training forward, its loss and gradients -----------------------------

def _scene():
    ds = JSyn(JSynCfg(n_frames=4, height=H, width=W))
    imgs, poses, disps, intr = [], [], [], []
    for k in range(4):
        p = ds[k]
        imgs.append(p["images"])
        poses.append(np.linalg.inv(p["poses"]))
        d = p["depths"][::8, ::8]
        disps.append(1.0 / np.maximum(d, 0.1))
        intr.append(p["intrinsics"] / 8.0)
    pg = np.asarray(jse3.from_matrix(jnp.asarray(np.stack(poses))))
    arrays = (np.stack(imgs), pg, np.stack(disps).astype(np.float32),
              np.stack(intr).astype(np.float32))
    ii, jj = _edges(4, 2)
    return arrays, ii, jj


@pytest.fixture(scope="module")
def oracle():
    """The JAX loss, metrics and gradients (value_and_grad, two update
    iterations) under an f32 and a bf16 DroidNet, from the same f32
    parameters.  The f32 oracle runs op by op: jitted, XLA's CPU compiler
    moves some gradient leaves by up to 5% from the op-by-op result (the
    flow encoder's biases), which the port matches within 4e-4."""
    arrays, ii, jj = _scene()
    jb = jtr.TrainBatch(*map(jnp.asarray, arrays))
    iij, jjj = jnp.asarray(ii), jnp.asarray(jj)
    params = JNet().init(
        jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)),
        jnp.zeros((1, h, w, 128)), jnp.zeros((1, h, w, 128)),
        jnp.zeros((1, h, w, 196)), jnp.zeros((1, h, w, 4)),
        jnp.array([0]), 1)
    out = {"arrays": arrays, "ii": ii, "jj": jj,
           "flat": {k: np.asarray(v) for k, v in _flatten(params).items()},
           "params": params}
    for name, dt in (("f32", None), ("bf16", jnp.bfloat16)):
        net = JNet(dtype=dt)
        f = jax.value_and_grad(
            lambda p: jtr.droid_loss(net, p, jb, iij, jjj, num_steps=2),
            has_aux=True)
        if name == "bf16":
            f = jax.jit(f)
        (loss, metrics), grads = f(params)
        out[name] = ({k: float(v) for k, v in metrics.items()},
                     {k: v.numpy() for k, v in flax_to_state_dict(
                         {k: np.asarray(v) for k, v in
                          _flatten(grads).items()}).items()},
                     grads)
    return out


def _port(oracle, dtype, remat=False):
    """(net, metrics, {name: grad}) of the port from the oracle's
    parameters."""
    net = (DroidNet(dtype=torch.float32) if dtype == "f32" else
           DroidNet(dtype=torch.bfloat16, param_dtype=torch.float32))
    load_flax_weights(net, oracle["flat"])
    tb = ttr.TrainBatch(*map(_t, oracle["arrays"]))
    g, m = ttr.grad_fn(net, tb, _t(oracle["ii"]), _t(oracle["jj"]),
                       num_steps=2, remat=remat)
    names = [n for n, _ in net.named_parameters()]
    return net, {k: float(v) for k, v in m.items()}, dict(zip(names, g))


# feature-encoder biases feed instance norms (their exact gradient is 0)
# and the upsample head is not in the loss: these leaves' gradients are
# rounding noise (f32) or zero
def _noise_leaf(name):
    return name.startswith("update_net.agg.upmask_0") or (
        name.startswith("feature_net") and name.endswith(".bias")
        and name != "feature_net.conv2.bias")


def test_droid_loss_f32_matches_jax(oracle):
    """droid_loss and every metric within 1e-4 relative under an f32
    DroidNet on both sides."""
    _, mt, _ = _port(oracle, "f32")
    mj = oracle["f32"][0]
    assert set(mt) == set(mj)
    for k, v in mj.items():
        assert abs(mt[k] - v) <= 1e-4 * abs(v), (k, mt[k], v)


def test_droid_grads_f32_match_jax(oracle):
    """Every gradient leaf within 1e-2 relative L2 of jax.value_and_grad's;
    the leaves whose exact gradient is zero stay below 1e-6 of the global
    norm on both sides."""
    _, _, gt = _port(oracle, "f32")
    gj = oracle["f32"][1]
    assert set(gt) == set(gj)
    gnorm = np.sqrt(sum(np.sum(v * v) for v in gj.values()))
    for k, b in gj.items():
        a = _np(gt[k])
        if _noise_leaf(k):
            assert np.linalg.norm(a) < 1e-6 * gnorm, k
            assert np.linalg.norm(b) < 1e-6 * gnorm, k
        else:
            assert _rel_l2(a, b) < 1e-2, (k, _rel_l2(a, b))


def test_droid_bf16_matches_jax(oracle):
    """Under bf16 compute (f32 weights) on both sides: the loss within
    2e-2 relative; every gradient leaf at cosine similarity >= 0.99 to
    JAX's, but the feature encoder's.  Its gradient is rounded to bf16
    through every instance norm: JAX's own bf16 gradient there sits at
    cosine 0.96-0.98 to its f32 gradient, so two bf16 roundings agree to
    about 0.99; there the port's bf16 gradient must agree with JAX's to
    0.98 and with the f32 gradient as closely as JAX's does (within
    0.01).  Its biases' gradients are rounding noise (exactly 0 in exact
    arithmetic): below 1e-4 of the global norm."""
    _, mt, gt = _port(oracle, "bf16")
    mj, gj, _ = oracle["bf16"]
    g32 = oracle["f32"][1]
    assert abs(mt["loss"] - mj["loss"]) <= 2e-2 * abs(mj["loss"])

    def cos(a, b):
        return float(np.sum(a * b) / max(np.linalg.norm(a)
                                          * np.linalg.norm(b), 1e-30))
    gnorm = np.sqrt(sum(np.sum(v * v) for v in gj.values()))
    for k, b in gj.items():
        a = _np(gt[k])
        if k.startswith("update_net.agg.upmask_0"):
            assert not a.any() and not b.any(), k
        elif _noise_leaf(k):
            assert np.linalg.norm(a) < 1e-4 * gnorm, k
        elif k.startswith("feature_net"):
            assert cos(a, b) >= 0.98, (k, cos(a, b))
            assert cos(a, g32[k]) >= cos(b, g32[k]) - 0.01, k
        else:
            assert cos(a, b) >= 0.99, (k, cos(a, b))


def test_remat_gives_the_same_gradients(oracle):
    """Recomputing each iteration in the backward (checkpoint) changes no
    bit of the gradients on the CPU."""
    _, m0, g0 = _port(oracle, "f32", remat=False)
    _, m1, g1 = _port(oracle, "f32", remat=True)
    assert m0 == m1
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


def test_training_steps_reduce_the_loss(oracle):
    """tests/test_training.py's check on the port: six Adam steps at 2e-4
    lower the loss of the scene (bf16 compute, as the JAX test)."""
    net = DroidNet(dtype=torch.bfloat16, param_dtype=torch.float32)
    load_flax_weights(net, oracle["flat"])
    tb = ttr.TrainBatch(*map(_t, oracle["arrays"]))
    opt = ttr.Optimizer(list(net.parameters()), 2e-4, max_norm=1e9)
    losses = []
    for _ in range(6):
        g, m = ttr.grad_fn(net, tb, _t(oracle["ii"]), _t(oracle["jj"]),
                           num_steps=2)
        ttr.apply_fn(net, opt, g, 1.0)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0], losses


# -- optimizer ---------------------------------------------------------------

def _optax_chain(lr):
    return optax.chain(optax.zero_nans(), optax.clip_by_global_norm(1.0),
                       optax.adam(lr))


@pytest.mark.parametrize("case", ["clipped", "unclipped", "nan"])
def test_optimizer_matches_optax(oracle, case):
    """zero_nans -> clip_by_global_norm(1.0) -> adam under the trainer's
    warmup-cosine schedule: two steps from the same parameters and
    gradients, the port's updates within 1e-6 of optax's (the gradients
    scaled above the norm, below it, or with NaNs)."""
    sched_j = optax.warmup_cosine_decay_schedule(0.0, 3e-5, 2, 8,
                                                 end_value=1.5e-6)
    sched_t = ttr.warmup_cosine_decay_schedule(0.0, 3e-5, 2, 8,
                                               end_value=1.5e-6)
    g = {k: v.copy() for k, v in oracle["f32"][1].items()}
    if case == "unclipped":
        g = {k: v * 1e-3 for k, v in g.items()}
    if case == "nan":
        g["update_net.delta_2.bias"][0] = np.nan
    names = list(g)
    params = flax_to_state_dict(oracle["flat"])
    tx = _optax_chain(sched_j)
    pj = {k: jnp.asarray(params[k].numpy()) for k in names}
    state = tx.init(pj)
    update = jax.jit(tx.update)
    opt = ttr.Optimizer([params[k] for k in names], sched_t)
    for step in range(2):
        gs = {k: v * (1 + step) for k, v in g.items()}
        uj, state = update({k: jnp.asarray(v) for k, v in gs.items()},
                           state, pj)
        ut = opt.update([torch.as_tensor(gs[k]) for k in names])
        for k, u in zip(names, ut):
            assert np.isfinite(_np(u)).all()
            np.testing.assert_allclose(_np(u), np.asarray(uj[k]), rtol=0,
                                       atol=1e-6, err_msg=k)
    assert ttr.Optimizer([], 1.0).count == 0


def test_warmup_cosine_schedule_matches_optax():
    """The trainer's schedule (p2b's: peak 3e-5, 100 warmup steps, 600
    steps, end 5% of the peak) at every step, within f32 rounding."""
    want = optax.warmup_cosine_decay_schedule(0.0, 3e-5, 100, 600,
                                              end_value=1.5e-6)
    got = ttr.warmup_cosine_decay_schedule(0.0, 3e-5, 100, 600,
                                           end_value=1.5e-6)
    steps = list(range(0, 620, 7)) + [99, 100, 101, 599, 600]
    np.testing.assert_allclose([got(s) for s in steps],
                               [float(want(s)) for s in steps],
                               rtol=2e-7, atol=0)


def test_apply_with_ema_matches_jax(oracle):
    """make_apply_fn's step: parameters and EMA after one step from the
    same grads (two scenes accumulated) within 1e-6."""
    tx = _optax_chain(1e-4)
    apply_j = jtr.make_apply_fn(tx, ema_decay=0.99)
    params = oracle["params"]
    grads = oracle["f32"][2]
    g_sum = jax.tree.map(lambda g: 2.0 * g, grads)
    pj, _, ej = apply_j(params, tx.init(params), g_sum, jnp.float32(0.5),
                        params)
    net = load_flax_weights(DroidNet(dtype=torch.float32), oracle["flat"])
    names = [n for n, _ in net.named_parameters()]
    ema = [p.detach().clone() for p in net.parameters()]
    gsd = oracle["f32"][1]
    opt = ttr.Optimizer(list(net.parameters()), 1e-4)
    ttr.apply_fn(net, opt, [torch.as_tensor(2.0 * gsd[n]) for n in names],
                 0.5, ema, 0.99)
    want_p = flax_to_state_dict({k: np.asarray(v) for k, v in
                                 _flatten(pj).items()})
    want_e = flax_to_state_dict({k: np.asarray(v) for k, v in
                                 _flatten(ej).items()})
    for n, p, e in zip(names, net.parameters(), ema):
        np.testing.assert_allclose(_np(p), want_p[n].numpy(), rtol=0,
                                   atol=1e-6, err_msg=n)
        np.testing.assert_allclose(_np(e), want_e[n].numpy(), rtol=0,
                                   atol=1e-6, err_msg=n)


# -- weights -----------------------------------------------------------------

def _reference_state_dict(seed=0):
    """A state dict in droid.pth's naming (``to_reference``), from the
    port's own DroidNet (random weights), with 3-channel weight/delta
    heads that the converter truncates to 2."""
    torch.manual_seed(seed)
    sd = DroidNet(dtype=torch.float32).state_dict()
    ref = tweights.to_reference({k: v.clone() for k, v in sd.items()})
    for k, v in ref.items():
        if k.startswith(("module.update.weight.2.",
                         "module.update.delta.2.")):
            ref[k] = torch.cat([v, torch.randn_like(v[:1])], 0)
    return sd, ref


def test_droid_pth_conversion_matches_jax():
    """The port's converter and JAX's convert() on the same reference-named
    arrays (carried across by flax_to_state_dict): equal to the bit, and
    equal to the DroidNet the names were taken from."""
    sd, ref = _reference_state_dict()
    got = tweights.convert(ref)
    want = flax_to_state_dict({k: np.asarray(v) for k, v in _flatten(
        jweights.convert({k: v.numpy() for k, v in ref.items()})).items()})
    assert set(got) == set(want) == set(sd)
    for k in sd:
        assert torch.equal(got[k], want[k]), k
        assert torch.equal(got[k], sd[k]), k


def test_cli_loads_a_droid_pth(tmp_path, capsys, monkeypatch):
    """``slam_demo --weights x.pth`` loads the converted weights into the
    tracker's DroidNet and runs."""
    sd, ref = _reference_state_dict(1)
    path = str(tmp_path / "droid.pth")
    torch.save(ref, path)
    for k, v in tweights.load_droid_pth(path).items():
        assert torch.equal(v, sd[k]), k
    built = []
    build = slam_demo.build_frontend
    monkeypatch.setattr(slam_demo, "build_frontend",
                        lambda *a: built.append(build(*a)) or built[-1])
    res = slam_demo.run(slam_demo.parse_args(
        ["--device", "cpu", "--height", "48", "--width", "64",
         "--n_frames", "4", "--buffer", "8", "--fusion", "none",
         "--weights", path]))
    assert res["n_keyframes"] >= 1
    for k, v in built[0].net.state_dict().items():
        assert torch.equal(v, sd[k]), k


TINY_PHASE = dict(name="q2", H=H, W=W, frames=4, scenes=2, steps=3,
                  gru_steps=2, lr=2e-4, deg_lo=2.0, deg_hi=12.0,
                  max_objects=2, remat=True, accum=2, ema=0.99, holdout=1,
                  plain_frac=0.5)


def test_trainer_weights_load_in_jax(tmp_path):
    """A phase of the trainer on the CPU writes flat flax keys with the
    damping sidecar; the JAX package loads them (load_arrays +
    unflatten_into) and its f32 features equal the port's within 1e-5
    of their largest magnitude."""
    out = str(tmp_path / "w.npz")
    summary = trainer.run_phase(dict(TINY_PHASE), WEIGHTS, out,
                                device="cpu", log=lambda s: None)
    assert summary["grads_finite"] and np.isfinite(
        summary["metrics"]["loss"])
    flat, meta = load_arrays(out)
    assert meta["damping_scale"] == 1.0 and meta["damping_offset"] == 1e-4
    jnet = JNet()
    params = unflatten_into(jnet.init_params(jax.random.PRNGKey(1), H, W),
                            flat)
    tnet = load_flax_weights(DroidNet(dtype=torch.float32), flat)
    imgs = np.random.RandomState(0).randn(2, H, W, 3).astype(np.float32)
    want = jnet.apply(params, jnp.asarray(imgs), method=JNet.features)
    with torch.no_grad():
        got = tnet.features(_t(imgs))
    _close_rel(got, want, 1e-5)
    # the weights moved from the warm start
    start = load_arrays(WEIGHTS)[0]
    assert any(not np.array_equal(flat[k], start[k]) for k in flat)


def test_trainer_resumes_to_the_same_weights(tmp_path):
    """A phase stopped at its in-phase checkpoint and rerun ends with the
    same weights, to the bit, as the phase run through."""
    a, b = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    kw = dict(device="cpu", save_every=1, log=lambda s: None)
    trainer.run_phase(dict(TINY_PHASE), WEIGHTS, a, **kw)
    stopped = trainer.run_phase(dict(TINY_PHASE), WEIGHTS, b,
                                stop_after=1, **kw)
    assert stopped == {"stopped_at": 1}
    assert os.path.exists(b + ".q2.ckpt.npz")
    trainer.run_phase(dict(TINY_PHASE), WEIGHTS, b, **kw)
    assert not os.path.exists(b + ".q2.ckpt.npz")
    fa, fb = load_arrays(a)[0], load_arrays(b)[0]
    assert set(fa) == set(fb)
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def test_state_dict_to_flax_inverts_flax_to_state_dict():
    flat = load_arrays(WEIGHTS)[0]
    back = state_dict_to_flax(flax_to_state_dict(flat))
    assert set(back) == {k for k in flat if k.startswith("params.")}
    for k, v in back.items():
        np.testing.assert_array_equal(v, flat[k].astype(np.float32))
