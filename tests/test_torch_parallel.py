"""The port's data-parallel train step (``parallel/mesh.py``,
``train/steps.py::TrainStep`` with a mesh, sync-BN in
``nn/modules.py::BatchNorm2d``) on 2 gloo ranks on the CPU, each a process
of its own (``parallel/distributed.py::spawn_ranks``, a ``file://``
rendezvous under ``tmp_path``, joined within 90 s or killed).

Against the JAX package on a 2-device virtual CPU mesh, one step from the
same weights as the one-process step tests (crater YOLO11n at 64 px, ch 1,
the JAX init of ``test_torch_train_step.py``; YOLOX-nano at 64 px, ch 3,
the seed-3 init of ``test_torch_yolox_train.py``, in
``test_torch_parallel_yolox.py``):

* sync mode (``bn_mode="sync"``) against ``make_sharded_train_step`` on a
  global batch of 4;
* local mode against ``make_ddp_train_step(sync_bn_stats=True)`` and
  ``(False)`` on a global batch of 8: 4 images a rank, so that each rank's
  BN normalises as many values as ``test_torch_train_step.py``'s batch
  (the JAX package's f32 gradients lie 1.5e-2 of max|g| from exact at 2
  images, 2.5e-3 at 4: ``test_torch_train_step_f64.py``).

Stated tolerances, those of
``test_torch_train_step.py::test_one_step_matches_jax``: the loss and every
metric ``rtol 1e-4``; Adam's first moment within ``G_TOL = 5e-3`` of
max|ref| per tensor, the second within ``2 * G_TOL``; BN running variances
``rtol 1e-4``, means within ``1e-5``; parameters and EMA within ``lr *
|u_port - u_jax| + 1e-6`` (``u`` the Adam direction of each side's
moments). Both ranks' results equal each other exactly. The moments'
tolerance rests on the JAX side's own f32 gradient error, which the
weights move: on these weights it lies 2.3e-3 to 3.4e-3 of max|g| from the
port's float64 step (sync and local), the port's f32 within 6e-4; on
YOLOX-nano's seed-0 init at 4 images the JAX package's reaches 7.3e-3.

Sync mode is the global batch exactly: in float64 the 2-rank step equals
the port's one-process step on the same 4 images within ``1e-9`` of each
tensor's max|·| (at least 1e-4 of the largest of its kind: a gradient that
is 0 in exact arithmetic holds rounding noise only) for the loss, metrics,
gradients, BN running mean and variance, parameters, moments and EMA; also
with ``grad_accum=2`` (each rank's block of the strided microbatches) and
with augmentation (mosaic + mixup on the global batch, rows crossing
ranks). Measured: 1e-14 (loss), 1e-11 (gradients, parameters), 4e-13 (BN).
A copy that moves ``running_var`` toward the unbiased variance (as
``nn.SyncBatchNorm`` does) or that averages per-rank losses fails it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_parallel_ranks as R
from tests.test_torch_train_step import G_TOL, _close_per_tensor, _sd
from tests.test_torch_train_step import setup  # noqa: F401 (fixture)
from tests.test_torch_yolox import jax_variables
from yolo_scratch_tpu.losses.simota import YOLOXLossConfig as JYOLOXLossConfig
from yolo_scratch_tpu.losses.v8_loss import DetectionLossConfig as JLossConfig
from yolo_scratch_tpu.models.builder import build_yolo11 as jax_build
from yolo_scratch_tpu.models.yolox import YOLOXModel as JYOLOX
from yolo_scratch_tpu.parallel import mesh as JM
from yolo_scratch_tpu.train.optim import cosine_epoch_schedule as jax_schedule
from yolo_scratch_tpu.train.optim import make_optimizer as jax_optimizer
from yolo_scratch_tpu.train.state import TrainState
from yolo_scratch_tpu.train.steps import v8_loss_adapter as jax_v8_adapter
from yolo_scratch_tpu.train.steps import yolox_loss_adapter as jax_yolox_adapter
from yolo_scratch_tpu.utils.torch_import import convert_reference_state_dict
from yolo_scratch_tpu_torch.data.loader import Loader
from yolo_scratch_tpu_torch.data.synthetic import SyntheticDataset
from yolo_scratch_tpu_torch.parallel import distributed as D
from yolo_scratch_tpu_torch.parallel.mesh import Mesh
from yolo_scratch_tpu_torch.utils.weights import state_dict_from_jax

JAX_CFG = "yolo_scratch_tpu/configs/yolo11_crater.yaml"
CH = {"yolo11": 1, "yolox": 3}
TOL64 = 1e-9
F64_CASES = {"plain": {}, "grad_accum": {"grad_accum": 2}, "augment": {"augment": True}}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs six workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(family: str, B: int, shuffle: bool = False) -> dict:
    ds = SyntheticDataset(n=8, img_size=64, channels=CH[family], num_classes=5)
    return next(iter(Loader(ds, B, max_gt=8, shuffle=shuffle, prefetch=0)))


def local_scenarios(family: str, state) -> dict:
    return {f"{family}_local_{sbs}": dict(family=family, state=state, batch=_batch(family, 8),
                                          bn_mode="local", sync_bn_stats=sbs)
            for sbs in (True, False)}


def spawn_runs(tmp_path_factory, scs: dict):
    """Every scenario run once on 2 CPU ranks: (scenarios by name, the
    directory of the ranks' .npz files)."""
    d = tmp_path_factory.mktemp("parallel_steps")
    for name, sc in scs.items():
        sc["name"] = name
    torch.save(list(scs.values()), d / "spec.pt")
    D.spawn_ranks(R.steps_rank, 2, (2, f"file://{d}/rendezvous", str(d / "spec.pt"), str(d)),
                  timeout=90)
    return scs, d


@pytest.fixture(scope="module")
def runs(tmp_path_factory, setup):  # noqa: F811
    jstate = setup[2]
    sd = _sd({"params": jstate.params, "batch_stats": jstate.batch_stats})
    scs = {"yolo11_sync": dict(family="yolo11", state=sd, batch=_batch("yolo11", 4)),
           **local_scenarios("yolo11", sd)}
    for case, kw in F64_CASES.items():
        scs[f"f64_{case}"] = dict(family="yolo11", state=sd, batch=_batch("yolo11", 4),
                                  f64=True, **kw)
    return spawn_runs(tmp_path_factory, scs)


def _ranks(runs, name):
    """Both ranks' results, which must be equal exactly; rank 0's."""
    out = [R.load(runs[1], name, r) for r in range(2)]
    for k in out[0]:
        np.testing.assert_array_equal(out[0][k], out[1][k], err_msg=f"{name} {k}: ranks differ")
    return out[0]


def _jax_state(family, sd):
    tx = jax_optimizer(jax_schedule(lr_max=R.LR, epochs=10, steps_per_epoch=1))
    if family == "yolo11":
        params, stats = convert_reference_state_dict(sd)
    else:
        v = jax_variables(sd)
        params, stats = v["params"], v["batch_stats"]
    return TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                      opt_state=tx.init(params),
                      ema_params=jax.tree_util.tree_map(jnp.copy, params), tx=tx)


def _jax_model_and_loss(family):
    if family == "yolo11":
        jm = jax_build(JAX_CFG, ch=1, nc=5, scale="n")
        return jm, jax_v8_adapter(JLossConfig(nc=5, strides=jm.strides))
    jm = JYOLOX.from_scale("nano", nc=5)
    return jm, jax_yolox_adapter(JYOLOXLossConfig(nc=5, strides=tuple(jm.strides)))


def _sub(out, prefix):
    return {k[len(prefix):]: torch.from_numpy(v) for k, v in out.items() if k.startswith(prefix)}


def _check_against_jax(got, j_next, j_metrics):
    """``got`` (a rank's results) against the JAX step's next state and
    metrics at ``test_one_step_matches_jax``'s tolerances."""
    for k, v in j_metrics.items():
        mine = got["loss"] if k == "loss" else got[f"m.{k}"]
        np.testing.assert_allclose(float(mine), float(v), rtol=1e-4, err_msg=k)
    adam = j_next.opt_state[1][0]
    params_sd = lambda t: state_dict_from_jax({"params": jax.device_get(t),  # noqa: E731
                                               "batch_stats": {}})
    mu_ref, nu_ref, ema_ref = params_sd(adam.mu), params_sd(adam.nu), params_sd(j_next.ema_params)
    mu, nu, ema, sd = (_sub(got, p) for p in ("mu.", "nu.", "ema.", "sd."))
    _close_per_tensor(mu, mu_ref, G_TOL, "mu")
    _close_per_tensor(nu, nu_ref, 2 * G_TOL, "nu")
    ref = state_dict_from_jax(jax.device_get({"params": j_next.params,
                                              "batch_stats": j_next.batch_stats}))
    for k, r in ref.items():
        if k.endswith("running_var"):
            np.testing.assert_allclose(sd[k].numpy(), r.numpy(), rtol=1e-4, err_msg=k)
        elif k.endswith("running_mean"):
            np.testing.assert_allclose(sd[k].numpy(), r.numpy(), rtol=0, atol=1e-5, err_msg=k)
    c = int(adam.count)
    lr = float(jax_schedule(lr_max=R.LR, epochs=10, steps_per_epoch=1)(c - 1))

    def direction(m, v):
        return (m / (1 - 0.9 ** c)) / ((v / (1 - 0.999 ** c)).sqrt() + 1e-8)

    for n in mu_ref:
        bound = lr * (direction(mu[n], nu[n]) - direction(mu_ref[n], nu_ref[n])).abs() + 1e-6
        for g, want, what in ((sd[n], ref[n], "param"), (ema[n], ema_ref[n], "ema")):
            assert bool(((g - want).abs() <= bound).all()), f"{what} {n}"


def check_sync_step(runs, family):
    """2-rank sync-BN step == ``make_sharded_train_step`` on a 2-device
    mesh, global batch 4."""
    sc = runs[0][f"{family}_sync"]
    jm, loss_fn = _jax_model_and_loss(family)
    mesh = JM.make_mesh(2)
    step = JM.make_sharded_train_step(jm, None, mesh, donate=False, loss_fn=loss_fn)
    j_next, j_metrics = step(JM.replicate(_jax_state(family, sc["state"]), mesh),
                             JM.shard_batch(sc["batch"], mesh))
    _check_against_jax(_ranks(runs, f"{family}_sync"), j_next, j_metrics)


def check_local_step(runs, family, sync_bn_stats):
    """2-rank DDP (local BN) step == ``make_ddp_train_step`` on a 2-device
    mesh, global batch 8: BN statistics averaged over the ranks or rank
    0's."""
    name = f"{family}_local_{sync_bn_stats}"
    sc = runs[0][name]
    jm, loss_fn = _jax_model_and_loss(family)
    mesh = JM.make_mesh(2)
    step = JM.make_ddp_train_step(jm, loss_fn, mesh, sync_bn_stats=sync_bn_stats, donate=False)
    j_next, j_metrics = step(JM.replicate(_jax_state(family, sc["state"]), mesh),
                             JM.shard_batch(sc["batch"], mesh))
    _check_against_jax(_ranks(runs, name), j_next, j_metrics)


def test_sync_step_matches_jax_sharded_step(runs):
    check_sync_step(runs, "yolo11")


@pytest.mark.parametrize("sync_bn_stats", [True, False])
def test_local_step_matches_jax_ddp_step(runs, sync_bn_stats):
    check_local_step(runs, "yolo11", sync_bn_stats)


@pytest.mark.parametrize("case", list(F64_CASES))
def test_sync_step_is_the_global_batch_step_f64(runs, case):
    """In float64 the 2-rank sync step equals the one-process step on the
    same global batch within 1e-9 of each tensor's max|·|."""
    name = f"f64_{case}"
    got, ref = _ranks(runs, name), R.run_step(runs[0][name])
    assert sorted(got) == sorted(ref)
    kinds = {}
    for k, r in ref.items():
        kind = "bn" if k.endswith(("running_mean", "running_var")) else k.split(".")[0]
        kinds.setdefault(kind, {})[k] = r
    for kind, tensors in kinds.items():
        floor = 1e-4 * max(float(np.abs(r).max()) for r in tensors.values())
        worst = 0.0
        for k, r in tensors.items():
            err = float(np.abs(got[k] - r).max()) / max(float(np.abs(r).max()), floor, 1e-300)
            worst = max(worst, err)
            assert err <= TOL64, f"{name} {k}: {err:.3g} of max|ref|"
        print(f"{name} {kind}: worst {worst:.3g} of max|ref|")


def test_local_mode_rejects_grad_accum():
    """``grad_accum > 1`` is a sync-mode feature, as in the JAX Trainer."""
    from yolo_scratch_tpu_torch.train.steps import build_train_step_custom

    model, loss_fn = R.build("yolo11")
    mesh = Mesh((torch.device("cpu"),) * 2, group=object())
    with pytest.raises(ValueError, match="grad_accum>1"):
        build_train_step_custom(model, loss_fn, grad_accum=2, mesh=mesh, bn_mode="local")
