"""Port train step (yolo_scratch_tpu_torch: nn.modules.BatchNorm2d,
train.optim, train.state, train.steps) vs the JAX package's
``build_train_step_custom(..., matmul_precision="highest")``.

Crater YOLO11n at 64 px, B=4, the JAX initial weights carried across by
the weight bridge, a seeded synthetic batch, f32. Stated tolerances:

* BN in train mode: the running statistics of the port's ``BatchNorm2d``
  equal flax's ``nn.BatchNorm(momentum=0.97)`` on a small batch, rtol 1e-6,
  and differ from ``nn.BatchNorm2d``'s (unbiased variance) by the factor
  n/(n-1) of the batch variance.
* One step from the initial state, and a second step from the JAX state
  after the first (parameters, BN statistics, Adam moments, EMA and counts
  carried across), each against the JAX step from the same state:
  - the loss and its triplet ``rtol = 1e-4``;
  - BN running variances ``rtol = 1e-4``, running means within ``1e-5``
    absolute. A running mean is 0.03 of a batch mean, near 0 in many
    channels, so a relative test would measure cancellation. The P5 blocks'
    batch variances (16 values a channel at 64 px) differ by up to 2.3e-3
    between the frameworks, as their train-mode maps do (up to 3.8e-4 of
    max|ref|), which moves ``0.97 + 0.03 * var`` by up to 7e-5;
  - gradients within ``G_TOL * max|ref|`` per tensor, where ``G_TOL = 5e-3``,
    and Adam's first moment at the same tolerance; the second moment
    within ``2 * G_TOL * max|ref|``. A tensor whose gradient is 0 in exact
    arithmetic (a BN bias that feeds another BN) is held against 1e-4 of
    the largest gradient instead. Why not 1e-4: the JAX package's f32
    gradients themselves lie up to 2.5e-3 of max|g| per tensor from the
    precise ones, where the port's f32 gradients lie within 3.7e-4
    (``test_torch_train_step_f64.py`` measures both against the JAX
    network in float64, and holds the port's float64 step to that
    reference at 1e-5 of max|g|); the loss agrees to 6e-6. The error is
    f32 rounding in the BN backward of small maps, not a difference of
    function: a wrong term shows at O(1) of max|g|;
  - parameters and EMA within ``lr * |u_port - u_jax| + 1e-6``, where
    ``u = mu_hat / (sqrt(nu_hat) + eps)`` is the Adam direction that each
    side's own moments give: the update rule, the LR of the step and the
    weight decay exactly, the moments' difference as held above (an Adam
    step is about ±lr whatever the gradient's size, so a near-zero
    gradient of the other sign moves a parameter by up to 2 lr);
  - the step counter, the optimizer's count and the LR applied (the
    schedule of the JAX package) equal.
* ``remat=True`` against ``remat=False`` on the port: two steps, BN
  statistics, gradients and parameters exactly equal.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from yolo_scratch_tpu.losses.v8_loss import DetectionLossConfig as JLossConfig
from yolo_scratch_tpu.models.builder import build_yolo11 as jax_build
from yolo_scratch_tpu.train.checkpoints import CheckpointManager as JaxCheckpointManager
from yolo_scratch_tpu.train.optim import cosine_epoch_schedule as jax_schedule
from yolo_scratch_tpu.train.optim import make_optimizer as jax_optimizer
from yolo_scratch_tpu.train.state import create_train_state as jax_state
from yolo_scratch_tpu.train.steps import build_train_step_custom as jax_step
from yolo_scratch_tpu.train.steps import v8_loss_adapter as jax_adapter
from yolo_scratch_tpu_torch.data.loader import Loader
from yolo_scratch_tpu_torch.data.synthetic import SyntheticDataset
from yolo_scratch_tpu_torch.losses.v8_loss import DetectionLossConfig
from yolo_scratch_tpu_torch.models.builder import CONFIGS, build_yolo11
from yolo_scratch_tpu_torch.nn.modules import BatchNorm2d
from yolo_scratch_tpu_torch.train.checkpoints import CheckpointManager
from yolo_scratch_tpu_torch.train.optim import cosine_epoch_schedule, make_optimizer
from yolo_scratch_tpu_torch.train.state import create_train_state
from yolo_scratch_tpu_torch.train.steps import build_train_step_custom, v8_loss_adapter
from yolo_scratch_tpu_torch.utils.weights import state_dict_from_jax

IMG, B, LR, WD = 64, 4, 1e-3, 5e-4
G_TOL = 5e-3
JAX_CFG = "yolo_scratch_tpu/configs/yolo11_crater.yaml"
LOSS_KEYS = ("loss", "box_loss", "cls_loss", "dfl_loss")


def jax_schedule_args():
    # one step an epoch: the warmup LR differs between the two steps
    return dict(lr_max=LR, epochs=10, steps_per_epoch=1)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for torch in this module. The suite runs six
    workers on the host's cores, and torch's thread pool in each would
    oversubscribe them (the trainer tests took 14x their time alone in a
    six-worker run); these small CPU shapes run as fast on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- BatchNorm

def test_bn_running_stats_follow_flax_biased_update():
    """A (2, 2, 2, 3) batch: flax moves ``var`` toward the biased
    batch variance, ``nn.BatchNorm2d`` toward the unbiased one."""
    x = np.random.RandomState(0).randn(2, 2, 2, 3).astype(np.float32)  # NHWC
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.97, epsilon=1e-3)
    v = bn.init(jax.random.PRNGKey(0), x)
    y_ref, mut = bn.apply(v, x, mutable=["batch_stats"])
    ref_mean, ref_var = (np.asarray(mut["batch_stats"][k]) for k in ("mean", "var"))

    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    port = BatchNorm2d(3, eps=1e-3, momentum=0.03).train()
    y = port(xt)
    np.testing.assert_allclose(port.running_mean.numpy(), ref_mean, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(port.running_var.numpy(), ref_var, rtol=1e-6)
    np.testing.assert_allclose(y.permute(0, 2, 3, 1).detach().numpy(), np.asarray(y_ref),
                               rtol=1e-5, atol=1e-5)
    plain = torch.nn.BatchNorm2d(3, eps=1e-3, momentum=0.03).train()
    plain(xt)
    n = x.shape[0] * x.shape[1] * x.shape[2]
    np.testing.assert_allclose((plain.running_var.numpy() - 0.97) / 0.03,
                               (ref_var - 0.97) / 0.03 * n / (n - 1), rtol=1e-4)
    # eval mode: the running statistics, unchanged by the forward
    port.eval()
    before = port.running_var.clone()
    port(xt)
    assert torch.equal(port.running_var, before)


# ------------------------------------------------------------- the step

@pytest.fixture(scope="module")
def setup():
    """(batch, JAX model, JAX initial state, JAX step, JAX grad fn)."""
    jm = jax_build(JAX_CFG, ch=1, nc=5, scale="n")
    tx = jax_optimizer(jax_schedule(**jax_schedule_args()))
    state = jax_state(jm, jax.random.PRNGKey(0), np.zeros((1, IMG, IMG, 1), np.float32), tx,
                      use_ema=True)
    batch = next(iter(Loader(SyntheticDataset(n=8, img_size=IMG), B, max_gt=8, prefetch=0)))
    loss_fn = jax_adapter(JLossConfig(nc=5, strides=jm.strides))
    step = jax.jit(jax_step(jm, loss_fn, matmul_precision="highest"))

    def loss(params, stats):
        feats, _ = jm.apply({"params": params, "batch_stats": stats}, batch["img"],
                            train=True, mutable=["batch_stats"])
        return loss_fn(feats, batch)[0]

    def grads(params, stats):
        with jax.default_matmul_precision("highest"):
            return jax.grad(loss)(params, stats)

    return batch, jm, state, step, jax.jit(grads)


def _sd(tree):
    """A JAX params/batch_stats pair, or a params-shaped tree, -> port keys."""
    return state_dict_from_jax(jax.device_get(tree))


def _params_sd(params):
    return state_dict_from_jax({"params": jax.device_get(params), "batch_stats": {}})


def _port_state(jstate, dtype=torch.float32):
    """A port model + train state in ``dtype`` holding the JAX state's
    weights, BN statistics, Adam moments, EMA and counts."""
    tm = build_yolo11(CONFIGS / "yolo11_crater.json", ch=1, nc=5, scale="n")
    tm.load_state_dict(_sd({"params": jstate.params, "batch_stats": jstate.batch_stats}))
    tm.to(dtype)
    ts = create_train_state(tm, make_optimizer(cosine_epoch_schedule(**jax_schedule_args())),
                            use_ema=True)
    adam = jstate.opt_state[1][0]  # chain: (clip, adamw = (scale_by_adam, wd, lr))
    mu, nu, ema = _params_sd(adam.mu), _params_sd(adam.nu), _params_sd(jstate.ema_params)
    with torch.no_grad():
        for (n, _), m, v in zip(tm.named_parameters(), ts.opt_state.mu, ts.opt_state.nu):
            m.copy_(mu[n])
            v.copy_(nu[n])
            ts.ema[n].copy_(ema[n])
    ts.step = int(jstate.step)
    ts.opt_state.count = int(adam.count)
    return tm, ts


def _port_step(tm):
    return build_train_step_custom(
        tm, v8_loss_adapter(DetectionLossConfig(nc=5, strides=tm.strides)),
        matmul_precision="highest")


def _close_per_tensor(got, ref, tol, what):
    """|got - ref| <= tol * scale per tensor, scale = max|ref| of the tensor,
    at least 1e-4 of the largest over all tensors: a tensor whose value is 0
    in exact arithmetic (a BN bias that feeds another BN) holds rounding
    noise only."""
    floor = 1e-4 * max(float(r.abs().max()) for r in ref.values())
    worst = 0.0
    for k, r in ref.items():
        scale = max(float(r.abs().max()), floor)
        err = float((got[k] - r).abs().max())
        worst = max(worst, err / scale)
        assert err <= tol * scale, f"{what} {k}: {err:.3g} > {tol} * {scale:.3g}"
    print(f"{what}: worst {worst:.3g} of max|ref|")
    return worst


def _check_step(jstate, setup, port=None):
    """One port step against one JAX step from ``jstate``; ``port``: the
    port's (model, train state) holding ``jstate``, else built from it."""
    batch, _, _, jstep, jgrads = setup
    j_next, j_metrics = jstep(jstate, batch)
    g_ref = _params_sd(jgrads(jstate.params, jstate.batch_stats))

    tm, ts = _port_state(jstate) if port is None else port
    step = _port_step(tm)
    lr = ts.tx.lr(ts.opt_state.count)
    assert lr == float(jax_schedule(**jax_schedule_args())(jnp.int32(ts.opt_state.count)))
    ts, metrics = step(ts, batch)
    assert ts.step == int(j_next.step) and ts.opt_state.count == int(j_next.opt_state[1][0].count)
    for k in LOSS_KEYS:
        np.testing.assert_allclose(float(metrics[k]), float(j_metrics[k]), rtol=1e-4, err_msg=k)

    grads = {n: p.grad for n, p in tm.named_parameters()}
    _close_per_tensor(grads, g_ref, G_TOL, "grad")

    adam = j_next.opt_state[1][0]
    mu_ref, nu_ref = _params_sd(adam.mu), _params_sd(adam.nu)
    names = [n for n, _ in tm.named_parameters()]
    _close_per_tensor(dict(zip(names, ts.opt_state.mu)), mu_ref, G_TOL, "mu")
    _close_per_tensor(dict(zip(names, ts.opt_state.nu)), nu_ref, 2 * G_TOL, "nu")

    ref = _sd({"params": j_next.params, "batch_stats": j_next.batch_stats})
    sd = tm.state_dict()
    for k, r in ref.items():
        if k.endswith("running_var"):
            np.testing.assert_allclose(sd[k].numpy(), r.numpy(), rtol=1e-4, err_msg=k)
        elif k.endswith("running_mean"):
            np.testing.assert_allclose(sd[k].numpy(), r.numpy(), rtol=0, atol=1e-5, err_msg=k)

    # parameters and EMA: the Adam direction each side's moments give
    c = ts.opt_state.count
    mu, nu = dict(zip(names, ts.opt_state.mu)), dict(zip(names, ts.opt_state.nu))

    def direction(m, v):
        return (m / (1 - 0.9 ** c)) / ((v / (1 - 0.999 ** c)).sqrt() + 1e-8)

    ema_ref = _params_sd(j_next.ema_params)
    for n, p in tm.named_parameters():
        bound = lr * (direction(mu[n], nu[n]) - direction(mu_ref[n], nu_ref[n])).abs() + 1e-6
        for got, want, what in ((p.detach(), ref[n], "param"), (ts.ema[n], ema_ref[n], "ema")):
            assert bool(((got - want).abs() <= bound).all()), f"{what} {n}"
    return j_next


def test_one_step_matches_jax(setup):
    _check_step(setup[2], setup)


def test_second_step_matches_jax(setup):
    batch, _, state, jstep, _ = setup
    s1, _ = jstep(state, batch)
    _check_step(s1, setup)


def test_step_after_resume_from_jax_matches_jax(setup, tmp_path):
    """The JAX state after one step, saved by the JAX package's
    ``CheckpointManager.save_epoch`` (orbax) and resumed by the port's
    ``try_resume``: weights, BN statistics, EMA, moments and counts equal
    what ``_port_state`` carries across, exactly; then one step of each side
    from it, at the tolerances above."""
    batch, _, state, jstep, _ = setup
    s1, _ = jstep(state, batch)
    mgr = JaxCheckpointManager(str(tmp_path), async_save=False)
    mgr.save_epoch(jax.device_get(s1), 0, {}, {"loss": 1.0}, float("inf"), 0.0)
    mgr.wait()
    tm = build_yolo11(CONFIGS / "yolo11_crater.json", ch=1, nc=5, scale="n", seed=3)
    ts = create_train_state(tm, make_optimizer(cosine_epoch_schedule(**jax_schedule_args())),
                            use_ema=True)
    ts, start, _, _ = CheckpointManager(str(tmp_path)).try_resume(ts)
    ref_tm, ref_ts = _port_state(s1)
    assert start == 1 and ts.step == ref_ts.step and ts.opt_state.count == ref_ts.opt_state.count
    ref = ref_tm.state_dict()
    assert all(torch.equal(v, ref[k]) for k, v in tm.state_dict().items())
    for a, b in zip(ts.opt_state.mu + ts.opt_state.nu, ref_ts.opt_state.mu + ref_ts.opt_state.nu):
        assert torch.equal(a, b)
    assert all(torch.equal(v, ref_ts.ema[k]) for k, v in ts.ema.items())
    _check_step(s1, setup, port=(tm, ts))


def test_remat_equals_plain_bn_updated_once(setup):
    batch, _, state, _, _ = setup
    runs = []
    for remat in (False, True):
        tm, ts = _port_state(state)
        step = build_train_step_custom(
            tm, v8_loss_adapter(DetectionLossConfig(nc=5, strides=tm.strides)),
            remat=remat, matmul_precision="highest")
        for _ in range(2):
            ts, metrics = step(ts, batch)
        runs.append((copy.deepcopy(tm.state_dict()),
                     {n: p.grad.clone() for n, p in tm.named_parameters()},
                     float(metrics["loss"])))
    (sd0, g0, l0), (sd1, g1, l1) = runs
    assert l0 == l1
    for k in sd0:
        assert torch.equal(sd0[k], sd1[k]), k
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
