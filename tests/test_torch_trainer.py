"""Port trainer, checkpoints and CLIs (yolo_scratch_tpu_torch.train.trainer,
train.checkpoints, train.cli, val, utils.weights.merge_pretrained): the
analogs of ``test_trainer.py``, ``test_checkpoint_guard.py`` and
``test_pretrained_merge.py``, plus the CLI's surface against the JAX
parser's, on the CPU.

Stated tolerances: ``Trainer.validate`` against the JAX ``Trainer.validate``
on the same weights and val set: the same keys in the same order, the
losses ``rtol = 1e-4`` (``test_torch_eval.py``'s tolerance), the other
metrics within ``1e-4``: scores agree to 2 ulp (``test_torch_eval.py``),
which can swap two detections of nearly equal score in the AP ranking
(measured: mAP50 6.5e-6 apart, with device and with host matching). ``val.main --ckpt`` against ``val.main --torch-ckpt`` on
the same weights: equal. Everything else here is exact (files, counters,
policies, flags).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_torch_eval import _assert_batches_equal, eval_model
from tests.test_torch_train_step import one_torch_thread  # noqa: F401 (autouse fixture)
from yolo_scratch_tpu.train import cli as jcli
from yolo_scratch_tpu_torch import val as tval
from yolo_scratch_tpu_torch.data.loader import Loader
from yolo_scratch_tpu_torch.data.synthetic import SyntheticDataset
from yolo_scratch_tpu_torch.models.builder import CONFIGS, build_yolo11
from yolo_scratch_tpu_torch.parallel.mesh import Mesh
from yolo_scratch_tpu_torch.train import cli as tcli
from yolo_scratch_tpu_torch.train.checkpoints import CheckpointManager
from yolo_scratch_tpu_torch.train.optim import make_optimizer
from yolo_scratch_tpu_torch.train.state import create_train_state, ema_state_dict
from yolo_scratch_tpu_torch.train.trainer import Trainer, TrainerConfig
from yolo_scratch_tpu_torch.utils.weights import merge_pretrained

CFG = CONFIGS / "yolo11_crater.json"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs six workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(nc=5, seed=0):
    return build_yolo11(CFG, ch=1, nc=nc, scale="n", seed=seed)


def _make_trainer(tmp_path, epochs=2, use_ckpt=True, model=None, **kw):
    ds = SyntheticDataset(n=8, img_size=64, channels=1, num_classes=5)
    train_loader = Loader(ds, batch_size=4, max_gt=8, shuffle=True, prefetch=0)
    val_loader = Loader(ds, batch_size=4, max_gt=8, prefetch=0, indices=[0, 1, 2, 3])
    cfg = TrainerConfig(epochs=epochs, lr=1e-3, val_conf=0.01,
                        save_dir=str(tmp_path / "run") if use_ckpt else None,
                        pre_nms_topk=64, max_det=20, **kw)
    return Trainer(model if model is not None else _model(), train_loader, val_loader, cfg)


def _scripted(trainer, values):
    calls = iter(values)
    trainer.validate = lambda: {"loss": 1.0, "mAP50": next(calls), "mAP50-95": 0.0,
                                "precision": 0, "recall": 0}


# ------------------------------------------------------------- trainer

def test_fit_and_resume(tmp_path):
    trainer = _make_trainer(tmp_path, epochs=2, use_ema=True, eval_with_ema=True)
    result = trainer.fit(resume=False)
    assert len(result["history"]) == 2
    for h in result["history"]:
        assert np.isfinite(h["train"]["loss"])
        assert "mAP50" in h["val"]
    run = tmp_path / "run"
    meta = json.loads((run / "last.meta.json").read_text())
    assert meta["epoch"] == 1 and (run / "last.pt").exists()
    lines = (run / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(x)["step"] for x in lines] == [0, 1]

    trainer2 = _make_trainer(tmp_path, epochs=3, use_ema=True, eval_with_ema=True)
    assert trainer2.resume()
    assert trainer2.start_epoch == 2
    assert trainer2.state.step == 4 == trainer2.state.opt_state.count  # 2 epochs x 2 steps
    for (n, p), q in zip(trainer2.model.named_parameters(), trainer.model.parameters()):
        assert torch.equal(p, q), n
        assert torch.equal(trainer2.state.ema[n], trainer.state.ema[n]), n
    for a, b in zip(trainer2.state.opt_state.mu, trainer.state.opt_state.mu):
        assert torch.equal(a, b)
    r2 = trainer2.fit(resume=True)
    assert [h["epoch"] for h in r2["history"]] == [2] and trainer2.state.step == 6


def test_checkpoint_best_policy(tmp_path):
    trainer = _make_trainer(tmp_path, epochs=1, use_ckpt=False)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    bl, bm, saved = mgr.save_epoch(trainer.state, 0, {}, {"mAP50": 0.5, "loss": 1.0},
                                   float("inf"), 0.0)
    mgr.wait()  # the write runs in the background
    assert saved and bm == 0.5 and (tmp_path / "ck" / "best.pt").exists()
    bl, bm, saved = mgr.save_epoch(trainer.state, 1, {}, {"mAP50": 0.3, "loss": 0.5}, bl, bm)
    assert not saved and bm == 0.5
    assert mgr.load_meta("best")["epoch"] == 0 and mgr.load_meta("last")["epoch"] == 1
    # loss-gated fallback when mAP is absent
    bl, bm, saved = mgr.save_epoch(trainer.state, 2, {}, {"loss": 0.4}, bl, bm)
    assert saved and bl == 0.4 and mgr.load_meta("best")["epoch"] == 2


def test_early_stopping_patience(tmp_path):
    trainer = _make_trainer(tmp_path, epochs=10, patience=2)
    # a cold plateau (must not count), a peak, then regression: stop 2 after it
    _scripted(trainer, [0.0, 0.0, 0.0, 0.5, 0.6, 0.55, 0.50, 0.45, 0.44, 0.43])
    assert len(trainer.fit(resume=False)["history"]) == 7


def test_early_stopping_survives_resume(tmp_path):
    curve = [0.0, 0.0, 0.0, 0.5, 0.6, 0.55, 0.50, 0.45, 0.44, 0.43]
    t1 = _make_trainer(tmp_path, epochs=6, patience=2)
    _scripted(t1, curve[:6])
    assert len(t1.fit(resume=False)["history"]) == 6
    meta = json.loads((tmp_path / "run" / "last.meta.json").read_text())
    assert meta["patience"] == {"since_improve": 1, "best": 0.6}

    t2 = _make_trainer(tmp_path, epochs=10, patience=2)
    _scripted(t2, curve[6:])
    r2 = t2.fit(resume=True)
    assert t2.start_epoch == 6
    assert t2.since_improve == 2 and t2.patience_best == 0.6
    assert len(r2["history"]) == 1  # only epoch index 6 ran


def test_early_stopping_resets_on_fresh_fit(tmp_path):
    trainer = _make_trainer(tmp_path, epochs=4, patience=2)
    _scripted(trainer, [0.6, 0.5, 0.4, 0.3])
    assert len(trainer.fit(resume=False)["history"]) == 3
    assert trainer.since_improve >= 2
    _scripted(trainer, [0.1, 0.2, 0.3, 0.4])  # improving: the full budget
    r2 = trainer.fit(resume=False)
    assert len(r2["history"]) == 4 and r2["best_mAP50"] == 0.4
    assert json.loads((tmp_path / "run" / "best.meta.json").read_text())["best_mAP50"] == 0.4


def test_checkpoint_meta_is_strict_json(tmp_path):
    trainer = _make_trainer(tmp_path, epochs=1, patience=2)
    trainer.validate = lambda: {}
    trainer.fit(resume=False)
    raw = (tmp_path / "run" / "last.meta.json").read_text()
    assert "Infinity" not in raw and "NaN" not in raw
    meta = json.loads(raw)
    assert meta["best_loss"] is None
    assert meta["patience"] == {"since_improve": 0, "best": None}
    t2 = _make_trainer(tmp_path, epochs=2, patience=2)
    assert t2.resume()
    assert t2.best_loss == float("inf") and t2.patience_best == -float("inf")


def test_checkpoint_reads_back_with_weights_only(tmp_path):
    trainer = _make_trainer(tmp_path, epochs=1, use_ema=True)
    trainer.fit(resume=False)
    tree = torch.load(tmp_path / "run" / "last.pt", map_location="cpu", weights_only=True)
    assert set(tree) == {"model", "opt_state", "ema", "step"}
    assert tree["step"] == 2 and tree["opt_state"]["count"] == 2
    assert set(tree["ema"]) == {n for n, _ in trainer.model.named_parameters()}


def test_trainer_options_not_ported_raise(tmp_path):
    """Every Trainer option is ported: augmentation and ``model_kind="yolox"``
    (``test_torch_yolox_train.py``), ``mesh`` and ``bn_mode="local"``
    (``test_torch_parallel_train.py``). ``bn_mode="local"`` without a mesh
    warns and trains, as the JAX Trainer does; an unknown family or BN
    mode, and a mesh whose device is not the model's, raise."""
    with pytest.warns(UserWarning, match="no effect without a mesh"):
        _make_trainer(tmp_path, bn_mode="local")
    ds = SyntheticDataset(n=4, img_size=64)
    loader = Loader(ds, batch_size=4, max_gt=8, prefetch=0)
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="rank's device"):
        Trainer(_model(), loader, None, TrainerConfig(), mesh=Mesh((meta, meta)))
    with pytest.raises(ValueError, match="model_kind"):
        Trainer(_model(), loader, None, TrainerConfig(), model_kind="yolov5")
    with pytest.raises(ValueError, match="bn_mode"):
        Trainer(_model(), loader, None, TrainerConfig(bn_mode="global"))


@pytest.mark.parametrize("device_matching", [True, False])
def test_validate_matches_jax_trainer(tmp_path, device_matching):
    """The port's ``Trainer.validate`` against the JAX ``Trainer.validate``
    on the same weights (``test_torch_eval.py``'s model, whose boxes land
    on the synthetic GTs), EMA off, on 6 val images in batches of 4 (the
    second batch wrap-padded) with ``val_fetch_chunk=1``. The shuffled
    training batches of the first epoch equal the JAX trainer's too (both
    draw one batch at construction)."""
    from yolo_scratch_tpu.data.loader import Loader as JLoader
    from yolo_scratch_tpu.data.synthetic import SyntheticDataset as JSynthetic
    from yolo_scratch_tpu.models.builder import build_yolo11 as jax_build
    from yolo_scratch_tpu.train.trainer import Trainer as JTrainer
    from yolo_scratch_tpu.train.trainer import TrainerConfig as JTrainerConfig
    from yolo_scratch_tpu.utils.torch_import import convert_reference_state_dict

    model = eval_model()
    kw = dict(epochs=1, device_matching=device_matching, val_fetch_chunk=1)
    ds_kw = dict(n=8, img_size=64, channels=1, num_classes=5)
    idx = [0, 1, 2, 3, 4, 5]
    port = Trainer(model, Loader(SyntheticDataset(**ds_kw), 4, max_gt=8, prefetch=0,
                                 shuffle=True),
                   Loader(SyntheticDataset(**ds_kw), 4, max_gt=8, prefetch=0, indices=idx),
                   TrainerConfig(**kw))
    jm = jax_build("yolo_scratch_tpu/configs/yolo11_crater.yaml", ch=1, nc=5, scale="n")
    jt = JTrainer(jm, JLoader(JSynthetic(**ds_kw), 4, max_gt=8, prefetch=0, shuffle=True),
                  JLoader(JSynthetic(**ds_kw), 4, max_gt=8, prefetch=0, indices=idx),
                  JTrainerConfig(**kw))
    params, stats = convert_reference_state_dict(model.state_dict())
    jt.state = jt.state.replace(params=params, batch_stats=stats)
    _assert_batches_equal(list(port.train_loader), list(jt.train_loader))
    got, ref = port.validate(), jt.validate()
    assert list(got) == list(ref)
    for k in ref:
        if "loss" in k:
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, err_msg=k)
        else:
            assert got[k] == pytest.approx(ref[k], abs=1e-4), k
    assert ref["mAP50"] > 0


# ------------------------------------------------------------- checkpoints

def _state(nc=5, use_ema=False, seed=0):
    return create_train_state(_model(nc, seed), make_optimizer(), use_ema=use_ema)


def _save(tmp_path, state):
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save_epoch(state, 0, {}, {"mAP50": 0.5}, float("inf"), 0.0)
    return mgr


VAL_CKPT = ["--which", "last", "--device", "cpu", "--imgsz", "64", "--max-batches", "1"]


def test_resume_wrong_arch_raises(tmp_path):
    mgr = _save(tmp_path, _state(nc=5))
    with pytest.raises(ValueError, match="params do not match"):
        mgr.try_resume(_state(nc=80), name="last")
    mgr80 = _save(tmp_path / "nc80", _state(nc=80))
    with pytest.raises(ValueError, match="params do not match"):  # val's nc=5 model
        tval.main(["--ckpt", str(mgr80.dir)] + VAL_CKPT)


def test_resume_missing_ema_raises(tmp_path):
    mgr = _save(tmp_path, _state(use_ema=False))
    with pytest.raises(ValueError, match="EMA"):
        mgr.try_resume(_state(use_ema=True), name="last")
    with pytest.raises(ValueError, match="EMA"):
        tval.main(["--ckpt", str(mgr.dir), "--ema"] + VAL_CKPT)


def test_resume_restores_weights_moments_and_counts(tmp_path):
    src = _state(use_ema=True, seed=1)
    src.apply_gradients([torch.full_like(p, 0.1) for p in src.model.parameters()])
    mgr = _save(tmp_path, src)
    dst = _state(use_ema=True, seed=2)
    dst, start, best_loss, best_map50 = mgr.try_resume(dst, name="best")
    assert (start, best_loss, best_map50) == (1, float("inf"), 0.5)
    assert dst.step == 1 and dst.opt_state.count == 1
    for (n, p), q in zip(dst.model.named_parameters(), src.model.parameters()):
        assert torch.equal(p, q) and torch.equal(dst.ema[n], src.ema[n]), n
    for a, b in zip(dst.opt_state.nu, src.opt_state.nu):
        assert torch.equal(a, b)


# ------------------------------------------------------------- pretrained

def test_merge_pretrained_skips_mismatches():
    init = {"a": torch.zeros(8, 1, 3, 3), "b": torch.zeros(5, 8, 1, 1), "c": torch.zeros(4)}
    loaded = {"a": torch.ones(8, 1, 3, 3), "b": torch.ones(80, 8, 1, 1)}  # nc mismatch, c gone
    merged, skipped = merge_pretrained(init, loaded)
    assert (merged["a"] == 1).all() and (merged["b"] == 0).all() and (merged["c"] == 0).all()
    assert skipped == ["b", "c"]
    with pytest.raises(ValueError):
        merge_pretrained(init, loaded, strict=True)
    with pytest.raises(KeyError):
        merge_pretrained({"c": torch.zeros(4)}, loaded, strict=True)


def test_merge_pretrained_full_roundtrip():
    a, b = _model(seed=0).state_dict(), _model(seed=1).state_dict()
    merged, skipped = merge_pretrained(a, b)
    assert not skipped
    assert all(torch.equal(merged[k], b[k]) for k in a)


def test_trainer_pretrained_warm_start(tmp_path):
    src = _state(seed=123)
    _save(tmp_path, src)
    tr = _make_trainer(tmp_path, epochs=1, use_ckpt=False, pretrained=str(tmp_path / "ckpt"))
    for (n, p), q in zip(tr.model.named_parameters(), src.model.parameters()):
        assert torch.equal(p, q), n
    # nc mismatch: the backbone loads, the nc-sized head rows keep their init
    init80 = _model(nc=80).state_dict()
    tr80 = _make_trainer(tmp_path, epochs=1, use_ckpt=False, model=_model(nc=80),
                         pretrained=str(tmp_path / "ckpt"))
    want = src.model.state_dict()
    loaded = kept = 0
    for k, v in tr80.model.state_dict().items():
        if k in want and want[k].shape == v.shape:
            assert torch.equal(v, want[k]), k
            loaded += 1
        else:
            assert torch.equal(v, init80[k]), k
            kept += 1
    assert loaded > 0 and kept > 0


def test_pretrained_ema_starts_from_the_init_as_jax(tmp_path):
    """With ``pretrained`` and ``use_ema`` the Trainer creates the state
    (the EMA a copy of the init) before it overlays the pretrained weights
    on the live model, as the JAX Trainer does. Both Trainers start from
    the JAX init (carried across by the weight bridge), load the same
    reference-layout ``.pt`` and take one step on the same batch, f32
    (``train_matmul_precision="highest"``); the EMA after it is held as in
    ``test_torch_train_step.py::test_one_step_matches_jax``: within ``lr *
    |u_port - u_jax| + 1e-6``, u the Adam direction each side's moments
    give. Overlaid before the state is created, the EMA would start from
    the pretrained weights: ~5e-4 (the first decay) x |init - pretrained|
    away."""
    from tests.test_torch_train_step import JAX_CFG, _params_sd
    from yolo_scratch_tpu.data.loader import Loader as JLoader
    from yolo_scratch_tpu.data.synthetic import SyntheticDataset as JSynthetic
    from yolo_scratch_tpu.models.builder import build_yolo11 as jax_build
    from yolo_scratch_tpu.train.trainer import Trainer as JTrainer
    from yolo_scratch_tpu.train.trainer import TrainerConfig as JTrainerConfig
    from yolo_scratch_tpu_torch.utils.weights import state_dict_from_jax

    torch.save({"model_state_dict": _model(seed=123).state_dict()}, tmp_path / "pre.pt")
    ds_kw = dict(n=4, img_size=64, channels=1, num_classes=5)
    kw = dict(epochs=1, lr=1e-3, use_ema=True, pretrained=str(tmp_path / "pre.pt"),
              train_matmul_precision="highest")
    jt = JTrainer(jax_build(JAX_CFG, ch=1, nc=5, scale="n"),
                  JLoader(JSynthetic(**ds_kw), 4, max_gt=8, prefetch=0), None,
                  JTrainerConfig(**kw))
    model = _model()
    model.load_state_dict(state_dict_from_jax({"params": jt.state.ema_params}), strict=False)
    tr = Trainer(model, Loader(SyntheticDataset(**ds_kw), 4, max_gt=8, prefetch=0), None,
                 TrainerConfig(**kw))
    pre = torch.load(tmp_path / "pre.pt", weights_only=True)["model_state_dict"]
    assert all(torch.equal(p, pre[n]) for n, p in tr.model.named_parameters())
    lr = tr.state.tx.lr(0)
    tr.train_epoch(0)
    jt.train_epoch(0)

    adam = jt.state.opt_state[1][0]
    mu_ref, nu_ref = _params_sd(adam.mu), _params_sd(adam.nu)
    ema_ref = _params_sd(jt.state.ema_params)
    names = [n for n, _ in tr.model.named_parameters()]
    mu, nu = dict(zip(names, tr.state.opt_state.mu)), dict(zip(names, tr.state.opt_state.nu))
    assert tr.state.step == int(jt.state.step) == 1

    def direction(m, v):
        return (m / (1 - 0.9)) / ((v / (1 - 0.999)).sqrt() + 1e-8)

    for n in names:
        bound = lr * (direction(mu[n], nu[n]) - direction(mu_ref[n], nu_ref[n])).abs() + 1e-6
        assert bool(((tr.state.ema[n] - ema_ref[n]).abs() <= bound).all()), n


# ------------------------------------------------------------- CLIs

def _actions(parser):
    return {a.dest: a for a in parser._actions if a.dest != "help"}


def test_cli_flags_and_defaults_equal_jax_parser():
    """Every flag of the JAX CLI with its name, type, choices and default;
    ``--device`` defaults to ``cuda`` and ``--cfg`` to the JSON twin of the
    JAX CLI's YAML config."""
    got, ref = _actions(tcli.build_parser()), _actions(jcli.build_parser())
    assert list(got) == list(ref)
    for dest, r in ref.items():
        g = got[dest]
        assert g.option_strings == r.option_strings, dest
        assert (type(g), g.type, g.choices, g.nargs) == (type(r), r.type, r.choices, r.nargs), dest
        if dest not in ("device", "cfg"):
            assert g.default == r.default, dest
    assert got["device"].default == "cuda"
    assert Path(got["cfg"].default).name == "yolo11_crater.json"
    assert Path(ref["cfg"].default).stem == "yolo11_crater"
    assert tcli.resolve_train_precision(None) == "high" == TrainerConfig.train_matmul_precision
    assert tcli.resolve_train_precision("default") is None
    assert tcli.resolve_train_precision("highest") == "highest"


@pytest.mark.parametrize("flags,error", [
    pytest.param(["--mesh", "2", "--batch", "3"], SystemExit, id="flags0-ROADMAP F"),
    pytest.param(["--multihost"], ValueError, id="flags1-ROADMAP F"),
])
def test_cli_unported_flags_raise_with_roadmap_item(tmp_path, flags, error, monkeypatch):
    """The multi-GPU flags (ROADMAP F) are ported and run
    (``test_torch_parallel_train.py``); they raise on what they cannot run:
    a batch that does not divide over the ranks, and ``--multihost`` with
    neither a coordinator nor torchrun's environment."""
    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(error):
        tcli.main(flags + ["--device", "cpu", "--imgsz", "64", "--save-dir", str(tmp_path)])


def test_cli_rejects_indivisible_grad_accum(tmp_path):
    with pytest.raises(SystemExit):
        tcli.main(["--batch", "4", "--grad-accum", "3", "--device", "cpu"])


def test_cli_defaults_to_cuda_and_never_falls_back(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tcli.main(["--imgsz", "64", "--scale", "n", "--save-dir", str(tmp_path)])
    assert not list(tmp_path.iterdir())  # nothing trained, nothing written


CLI = ["--device", "cpu", "--data", "synthetic", "--scale", "n", "--imgsz", "64",
       "--batch", "4", "--ema"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The README's CPU command: 2 epochs, then the same with --epochs 3."""
    d = tmp_path_factory.mktemp("cli") / "run"
    first = tcli.main(CLI + ["--epochs", "2", "--save-dir", str(d)])
    files = sorted(p.name for p in d.iterdir())
    second = tcli.main(CLI + ["--epochs", "3", "--save-dir", str(d)])
    return d, first, files, second


def test_cli_trains_writes_and_resumes(trained):
    d, first, files, second = trained
    assert [h["epoch"] for h in first["history"]] == [0, 1]
    saved_best = any(h["val"]["mAP50"] > 0 for h in first["history"])
    assert files == sorted(["last.pt", "last.meta.json", "metrics.jsonl"]
                           + (["best.pt", "best.meta.json"] if saved_best else []))
    assert [h["epoch"] for h in second["history"]] == [2]
    tree = torch.load(d / "last.pt", map_location="cpu", weights_only=True)
    assert tree["step"] == 3 * 13  # 52 train images of 64, 13 batches of 4 an epoch
    for h in first["history"] + second["history"]:
        assert np.isfinite(h["train"]["loss"]) and np.isfinite(h["val"]["loss"])


@pytest.mark.parametrize("ema", [False, True])
def test_val_ckpt_evaluates_what_the_trainer_wrote(trained, tmp_path, ema):
    """``val --ckpt D --which last [--ema]`` equals ``val --torch-ckpt`` on
    the checkpoint's model (or EMA) state dict."""
    d = trained[0]
    args = ["--device", "cpu", "--imgsz", "64", "--batch", "4", "--max-batches", "2"]
    got = tval.main(args + ["--ckpt", str(d), "--which", "last"] + (["--ema"] if ema else []))
    state = create_train_state(_model(), make_optimizer(), use_ema=True)
    CheckpointManager(str(d)).try_resume(state, name="last")
    sd = ema_state_dict(state) if ema else state.model.state_dict()
    torch.save(sd, tmp_path / "w.pt")
    ref = tval.main(args + ["--torch-ckpt", str(tmp_path / "w.pt")])
    assert got == ref
    with pytest.raises(FileNotFoundError):
        tval.main(args + ["--ckpt", str(tmp_path), "--which", "best"])
