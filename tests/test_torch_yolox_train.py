"""YOLOX through the port's train step, Trainer, checkpoints and the three
CLIs (``train.cli``, ``val``, ``infer`` with ``--model yolox``), on the CPU
at 64 px with YOLOX-nano; the analogs of ``tests/test_yolox_trainer.py``
and ``tests/test_yolox_deploy.py``.

Stated tolerances: the step against the JAX step from the same weights on
the same batch: the loss and each aux term ``rtol 1e-4``, ``num_fg`` equal,
each gradient within ``5e-3 * max|ref|`` (``test_torch_train_step.py``'s
``G_TOL``: the JAX package's own f32 gradients lie up to 2.5e-3 of max|g|
from float64 ones), BN running variances ``rtol 1e-4`` and means within
``1e-5``. ``val.main --model yolox`` against the JAX ``val.main`` on the
same weights: the loss ``rtol 1e-4``, the metrics within ``1e-4``
(``test_torch_trainer.py``'s tolerance: scores agree to a few ulp, which can
swap two detections of nearly equal score). Everything else is exact
(files, counters, phases, resumed weights).
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_train_step import one_torch_thread  # noqa: F401 (autouse fixture)
from tests.test_torch_yolox import jax_variables
from yolo_scratch_tpu import val as jval
from yolo_scratch_tpu.losses import simota as JS
from yolo_scratch_tpu.models.yolox import YOLOXModel as JYOLOX
from yolo_scratch_tpu_torch import infer as tinfer
from yolo_scratch_tpu_torch import val as tval
from yolo_scratch_tpu_torch.data.augment import AugmentConfig
from yolo_scratch_tpu_torch.data.loader import Loader
from yolo_scratch_tpu_torch.data.synthetic import SyntheticDataset
from yolo_scratch_tpu_torch.losses.simota import YOLOXLossConfig
from yolo_scratch_tpu_torch.models.builder import CONFIGS, build_yolo11
from yolo_scratch_tpu_torch.models.yolox import YOLOXModel, build_yolox
from yolo_scratch_tpu_torch.train import cli as tcli
from yolo_scratch_tpu_torch.train.checkpoints import CheckpointManager
from yolo_scratch_tpu_torch.train.optim import make_optimizer
from yolo_scratch_tpu_torch.train.state import create_train_state
from yolo_scratch_tpu_torch.train.steps import build_train_step_custom, yolox_loss_adapter
from yolo_scratch_tpu_torch.train.trainer import Trainer, TrainerConfig
from yolo_scratch_tpu_torch.utils.weights import state_dict_from_jax

G_TOL = 5e-3
AUX = ("cls_loss", "iou_loss", "l1_loss", "num_fg", "obj_loss")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs six workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _loaders(n=8, val=True, shuffle=True):
    ds = SyntheticDataset(n=n, img_size=64, channels=3, num_classes=5)
    train = Loader(ds, batch_size=4, max_gt=8, shuffle=shuffle, prefetch=0)
    return train, (Loader(ds, batch_size=4, max_gt=8, prefetch=0, indices=[0, 1]) if val
                   else None)


def _trainer(tmp_path=None, epochs=2, seed=0, shuffle=True, **kw):
    train, val = _loaders(val=kw.pop("val", True), shuffle=shuffle)
    cfg = TrainerConfig(epochs=epochs, lr=1e-3, val_conf=0.01, pre_nms_topk=64, max_det=20,
                        save_dir=str(tmp_path) if tmp_path else None, **kw)
    return Trainer(build_yolox("nano", nc=5, ch=3, seed=seed), train, val, cfg, seed=seed,
                   model_kind="yolox")


# ------------------------------------------------------------- the step

@functools.partial(jax.jit, static_argnums=0)
def _jax_step_grads(jm, variables, img, gl, gb, gm):
    def f(p):
        outs, mut = jm.apply({"params": p, "batch_stats": variables["batch_stats"]}, img,
                             train=True, mutable=["batch_stats"])
        total, aux = JS.yolox_loss(outs, gl, gb, gm, JS.YOLOXLossConfig(nc=5))
        return total, (aux, mut["batch_stats"])

    with jax.default_matmul_precision("highest"):
        return jax.value_and_grad(f, has_aux=True)(variables["params"])


def test_step_matches_jax_yolox_step():
    """One YOLOX train step's loss, aux terms, gradients and BN statistics
    against the JAX step's, from the same weights on the same batch."""
    model = build_yolox("nano", nc=5, ch=3, seed=3)
    v = jax_variables(model.state_dict())
    batch = next(iter(_loaders()[0]))
    (ref_total, (ref_aux, ref_stats)), ref_grads = _jax_step_grads(
        JYOLOX.from_scale("nano", nc=5), v, batch["img"], batch["gt_labels"],
        batch["gt_bboxes"], batch["gt_mask"])

    step = build_train_step_custom(model, yolox_loss_adapter(YOLOXLossConfig(nc=5)),
                                   matmul_precision="highest")
    loss, aux = step.grads({k: torch.from_numpy(a) for k, a in batch.items()})
    np.testing.assert_allclose(float(loss), float(ref_total), rtol=1e-4)
    assert sorted(aux) == sorted(ref_aux) == list(AUX)
    for k in AUX:
        np.testing.assert_allclose(float(aux[k]), float(ref_aux[k]), rtol=1e-4, err_msg=k)
    assert float(aux["num_fg"]) == float(ref_aux["num_fg"]) > 0
    ref_g = state_dict_from_jax({"params": ref_grads})
    floor = 1e-4 * max(float(g.abs().max()) for g in ref_g.values())
    for name, p in model.named_parameters():
        r = ref_g[name]
        err = float((p.grad - r).abs().max()) / max(float(r.abs().max()), floor)
        assert err <= G_TOL, (name, err)
    stats = state_dict_from_jax({"params": v["params"], "batch_stats": ref_stats})
    for k, t in model.state_dict().items():
        if k.endswith("running_var"):
            np.testing.assert_allclose(t.numpy(), stats[k].numpy(), rtol=1e-4, err_msg=k)
        elif k.endswith("running_mean"):
            np.testing.assert_allclose(t.numpy(), stats[k].numpy(), rtol=0, atol=1e-5,
                                       err_msg=k)


def test_step_augments_on_the_device_batch_and_marks_the_phase():
    """``TrainStep(augment=...)`` maps the device batch after H2D and before
    the forward, and reports an ``augment`` phase."""
    model = build_yolox("nano", nc=5, ch=3)
    state = create_train_state(model, make_optimizer())
    step = build_train_step_custom(model, yolox_loss_adapter(YOLOXLossConfig(nc=5)))
    seen, phases = [], []
    step.on_phase = phases.append
    batch = next(iter(_loaders()[0]))

    def aug(b):
        seen.append(b["img"].device.type)
        return {**b, "img": b["img"] * 0.5}

    step(state, batch, augment=aug)
    assert seen == ["cpu"]
    assert phases == ["h2d", "augment", "forward", "loss", "backward", "clip_adamw_ema"]


# ------------------------------------------------------------- the Trainer

def test_trainer_fit_yolox(tmp_path):
    trainer = _trainer(tmp_path / "yx", epochs=2)
    hist = trainer.fit(resume=False)["history"]
    assert len(hist) == 2 and np.isfinite(hist[-1]["train"]["loss"])
    assert set(AUX) <= set(hist[-1]["train"]) and set(AUX) - {"num_fg"} <= set(hist[-1]["val"])
    assert "mAP50" in hist[-1]["val"] and "dfl_loss" not in hist[-1]["train"]
    assert hist[-1]["train"]["loss"] < hist[0]["train"]["loss"]
    assert (tmp_path / "yx" / "last.pt").exists()


def test_final_phase_turns_l1_on_and_augmentation_off():
    """The YOLOX recipe: the last ``final_epochs`` train with augmentation
    off and the L1 loss on (the analog of
    ``tests/test_yolox_trainer.py::test_yolox_final_phase_enables_l1_and_disables_aug``)."""
    trainer = _trainer(epochs=2, final_epochs=1, val=False,
                       augment=AugmentConfig(mosaic_p=1.0, mixup_p=1.0))
    assert not trainer._in_final_phase(0) and trainer._in_final_phase(1)
    assert trainer.augmenter(0, 0) is not None and trainer.augmenter(1, 0) is None
    calls, inner = [], trainer._train_step

    def spy(state, batch, augment=None):
        calls.append(augment is not None)
        return inner(state, batch, augment=augment)

    trainer._train_step = spy
    hist = trainer.fit(resume=False)["history"]
    assert calls == [True, True]  # epoch 0's two batches; epoch 1 has its own step
    assert hist[0]["train"]["l1_loss"] == 0.0
    assert hist[1]["train"]["l1_loss"] > 0.0 and np.isfinite(hist[1]["train"]["loss"])
    assert trainer._train_step_final is not None


def test_fit_then_resume_equals_an_uninterrupted_fit_with_augmentation(tmp_path):
    """Each batch's augmentation is seeded by (seed + 1, epoch, batch
    index), so 2 epochs, a checkpoint and a resumed third give the weights
    of 3 epochs in one go. (The loader's shuffle follows how often it was
    iterated, in both packages, so the loaders here do not shuffle.)"""
    aug = AugmentConfig(mosaic_p=1.0, mixup_p=0.5, vflip_p=0.5)
    kw = dict(augment=aug, val=False, shuffle=False)
    whole = _trainer(tmp_path / "whole", epochs=3, **kw)
    h_whole = whole.fit(resume=False)["history"]
    first = _trainer(tmp_path / "split", epochs=2, **kw)
    first.fit(resume=False)
    second = _trainer(tmp_path / "split", epochs=3, **kw)
    h_second = second.fit(resume=True)["history"]
    assert [h["epoch"] for h in h_second] == [2]
    assert h_second[0]["train"]["loss"] == h_whole[2]["train"]["loss"]
    for k, t in whole.model.state_dict().items():
        assert torch.equal(t, second.model.state_dict()[k]), k
    # another seed draws other augmentations
    other = _trainer(None, epochs=1, seed=1, **kw)
    assert other.fit(resume=False)["history"][0]["train"]["loss"] != h_whole[0]["train"]["loss"]


def test_checkpoint_of_one_family_does_not_load_into_the_other(tmp_path):
    yolox = _trainer(tmp_path / "yx", epochs=1, val=False)
    yolox.fit(resume=False)
    yolo11 = build_yolo11(CONFIGS / "yolo11_crater.json", ch=3, nc=5, scale="n")
    state = create_train_state(yolo11, make_optimizer())
    with pytest.raises(ValueError, match="checkpoint lacks|do not match"):
        CheckpointManager(str(tmp_path / "yx")).try_resume(state)

    train, val = _loaders(val=False)
    y11 = Trainer(yolo11, train, val, TrainerConfig(epochs=1, save_dir=str(tmp_path / "y11")))
    y11.fit(resume=False)
    with pytest.raises(ValueError, match="do not match"):
        _trainer(tmp_path / "y11", epochs=2, val=False).resume()


# ------------------------------------------------------------- the CLIs

@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """``train.cli --model yolox`` with the YOLOX recipe, 2 epochs."""
    save = tmp_path_factory.mktemp("yolox_cli") / "run"
    out = tcli.main(["--device", "cpu", "--data", "synthetic", "--model", "yolox", "--scale",
                     "n", "--imgsz", "64", "--batch", "4", "--epochs", "2", "--final-epochs",
                     "1", "--mosaic", "1.0", "--mixup", "1.0", "--ema", "--max-val-batches",
                     "1", "--val-conf", "0.001", "--workers", "0", "--save-dir", str(save)])
    return save, out


def test_train_cli_yolox_recipe(trained):
    save, out = trained
    hist = out["history"]
    assert [h["train"]["l1_loss"] > 0 for h in hist] == [False, True]
    assert all(np.isfinite(h["train"]["loss"]) and np.isfinite(h["val"]["loss"]) for h in hist)
    tree = CheckpointManager(str(save)).load_raw("last")
    assert any(k.startswith("backbone.") for k in tree["model"]) and tree["ema"]
    lines = [json.loads(x) for x in (save / "metrics.jsonl").read_text().splitlines()]
    assert "train/obj_loss" in lines[-1]


def test_val_cli_yolox_on_the_trained_checkpoint(trained):
    save, _ = trained
    out = tval.main(["--device", "cpu", "--data", "synthetic", "--model", "yolox", "--scale",
                     "n", "--imgsz", "64", "--batch", "4", "--max-batches", "1", "--conf",
                     "0.001", "--ckpt", str(save), "--which", "last", "--ema"])
    assert np.isfinite(out["loss"]) and "mAP50-95" in out


def _jit_init(model):
    return jax.jit(functools.partial(type(model).init, model, train=False))


def test_val_cli_yolox_matches_jax(tmp_path, monkeypatch):
    """The JAX ``val.main --model yolox`` evaluates its seeded init
    (``PRNGKey(0)``); the port evaluates the same weights through
    ``--torch-ckpt``. At conf 0 every anchor is a candidate. (The JAX CLI's
    init runs jitted here: eager, it takes ~35 s on the CPU.)"""
    import yolo_scratch_tpu.train.state as jstate

    create = jstate.create_train_state

    def create_jitted(model, rng, sample, tx, **kw):
        init = _jit_init(model)
        object.__setattr__(model, "init", lambda r, x, train=False: init(r, x))
        return create(model, rng, sample, tx, **kw)

    monkeypatch.setattr(jstate, "create_train_state", create_jitted)
    jm = JYOLOX.from_scale("nano", nc=5)
    v = _jit_init(jm)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 1), jnp.float32))
    path = tmp_path / "w.pt"
    torch.save(state_dict_from_jax(jax.device_get(v)), path)
    args = ["--data", "synthetic", "--model", "yolox", "--scale", "nano", "--imgsz", "64",
            "--batch", "4", "--max-batches", "2", "--conf", "0.0", "--per-class"]
    ref = jval.main(args)
    got = tval.main(args + ["--device", "cpu", "--torch-ckpt", str(path)])
    assert list(got) == list(ref)
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-4)
    for k in ref:
        if k != "loss":
            assert got[k] == pytest.approx(ref[k], abs=1e-4), k


def test_load_deploy_model_reads_the_family_off_the_weights(tmp_path):
    yx = build_yolox("tiny", nc=7, ch=1, seed=1)
    torch.save(yx.state_dict(), tmp_path / "yx.pt")
    y11 = build_yolo11(CONFIGS / "yolo11_crater.json", ch=1, nc=5, scale="n")
    torch.save(y11.state_dict(), tmp_path / "y11.pt")

    m = tinfer.load_deploy_model(weights=tmp_path / "yx.pt", device="cpu")
    assert isinstance(m, YOLOXModel)
    assert (m.in_ch, m.nc, m.width) == (1, 7, 0.375) and round(m.depth * 3) == 1
    assert all(torch.equal(t, yx.state_dict()[k]) for k, t in m.state_dict().items())
    assert not isinstance(tinfer.load_deploy_model(weights=tmp_path / "y11.pt", device="cpu"),
                          YOLOXModel)
    seeded = tinfer.load_deploy_model(scale="n", device="cpu", model_kind="yolox")
    assert (seeded.in_ch, seeded.nc, seeded.width) == (3, 80, 0.25)
    with pytest.raises(ValueError, match="unknown YOLOX scale"):
        tinfer.load_deploy_model(scale="q", device="cpu", model_kind="yolox")


def test_infer_cli_serves_a_yolox_weights_file(tmp_path):
    """``infer --weights`` with no architecture flags: family, depth, width,
    ch and nc read off the file; gray images for a ch=1 model."""
    cv2 = pytest.importorskip("cv2")
    model = build_yolox("nano", nc=5, ch=1, seed=2)
    with torch.no_grad():  # priors at 0.5, so some detections pass --conf
        for i in range(3):
            for k in ("cls", "obj"):
                getattr(model.head, f"{k}_pred_{i}").bias.zero_()
    torch.save(model.state_dict(), tmp_path / "w.pt")
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    rng = np.random.RandomState(0)
    for i in range(3):
        cv2.imwrite(str(img_dir / f"{i}.png"), (rng.rand(70, 90) * 255).astype(np.uint8))
    out = tmp_path / "preds.json"
    results = tinfer.main(["--images", str(img_dir), "--weights", str(tmp_path / "w.pt"),
                           "--imgsz", "64", "--batch", "2", "--conf", "0.1", "--device", "cpu",
                           "--out", str(out)])
    data = json.loads(out.read_text())
    assert len(data) == len(results) == 3 and sum(len(r["scores"]) for r in data) > 0
    assert all(0 <= lab < 5 for r in data for lab in r["labels"])


def test_predictor_dispatches_yolox_to_the_f32_decode():
    """The Predictor's YOLOX detections are ``postprocess`` of the f32
    ``yolox_eval_decode`` of its own maps, at B > 1 (kernel #1's wrapper)
    and at B = 1 (kernel #2's)."""
    from yolo_scratch_tpu_torch.models.yolox import yolox_eval_decode
    from yolo_scratch_tpu_torch.ops.decode import postprocess

    model = build_yolox("nano", nc=5, ch=3, seed=4)
    cfg = tinfer.PredictorConfig(img_size=64, batch_size=2, conf_threshold=0.0, pre_nms_topk=64)
    pred = tinfer.Predictor(model, cfg, device="cpu")
    assert not pred.is_dfl and pred.in_ch == 3 and pred.dtype == torch.bfloat16
    x = np.random.RandomState(1).randint(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    for imgs in (x, x[:1]):
        feats = pred.forward_feats(imgs)
        assert feats[0].dtype == torch.bfloat16
        got = pred.postprocess_feats(feats)
        ref = tinfer.pack_detections(*postprocess(
            yolox_eval_decode([f.float() for f in feats], 5, model.strides), 64,
            conf_threshold=0.0, pre_nms_topk=64, nms_impl="kernel"))
        assert torch.equal(got, ref) and int(got[..., 6].sum()) > 0
