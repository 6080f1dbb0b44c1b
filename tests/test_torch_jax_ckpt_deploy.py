"""The port's deploy and evaluation entry points on a run directory that the
JAX package wrote (``--ckpt DIR --which last``), on the CPU at 64 px.

The weights are ``tests/test_torch_infer.py``'s seeded model (randomised BN
statistics, zeroed class priors, so that detections pass the 0.25 gate)
carried to the JAX tree, given one JAX update and saved by the JAX
package's ``save_epoch``, as orbax and as the npz fallback.

Stated tolerances:

* ``load_deploy_model(ckpt=<jax dir>)`` through the port's f32 Predictor
  against the JAX package's ``load_deploy_model`` on the same directory
  through the JAX Predictor (f32, the Pallas NMS in interpret mode): keep
  sets, labels and valid masks exact, scores and normalised boxes within
  ``atol = 1e-5`` (``tests/test_torch_infer.py``'s Predictor tolerance);
* the npz form loads the same state dict as the orbax form, exactly;
* ``infer``, ``export`` and ``serve`` with ``--ckpt <jax dir>`` equal the
  same raw weights given as ``--weights``, and ``val --ckpt [--ema]`` equals
  ``val --torch-ckpt`` on the checkpoint's weights (or EMA), exactly (the
  same program on the same tensors); ``eval_quant --ckpt`` reads the EMA
  from the JAX directory and reports both variants.
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax

from tests.test_torch_deploy_ckpt import _serve_one
from tests.test_torch_infer import _assert_packed_close, _seeded_model
from yolo_scratch_tpu.infer import Predictor as JaxPredictor
from yolo_scratch_tpu.infer import PredictorConfig as JaxConfig
from yolo_scratch_tpu.infer import load_deploy_model as jax_load_deploy_model
from yolo_scratch_tpu.train.checkpoints import CheckpointManager as JaxCheckpointManager
from yolo_scratch_tpu.train.optim import make_optimizer as jax_optimizer
from yolo_scratch_tpu.train.state import create_train_state as jax_state
from yolo_scratch_tpu.utils.torch_import import convert_reference_state_dict
from yolo_scratch_tpu_torch import eval_quant
from yolo_scratch_tpu_torch import export as E
from yolo_scratch_tpu_torch import infer, val
from yolo_scratch_tpu_torch.models.builder import CONFIGS
from yolo_scratch_tpu_torch.train.checkpoints import CheckpointManager

IMG, B = 64, 2
JAX_CFG = str(CONFIGS.parent.parent / "yolo_scratch_tpu/configs/yolo11_crater.yaml")
CPU = ["--device", "cpu", "--imgsz", str(IMG), "--batch", str(B)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs six workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """(orbax run dir, npz run dir, ``--weights`` file of the raw weights,
    images dir)."""
    from PIL import Image

    root = tmp_path_factory.mktemp("jax_deploy")
    params, stats = convert_reference_state_dict(_seeded_model().state_dict())
    variables = {"params": params, "batch_stats": stats}
    state = jax_state(SimpleNamespace(init=lambda *a, **k: variables), None, None,
                      jax_optimizer(1e-3), use_ema=True)
    rng = np.random.RandomState(0)
    grads = jax.tree_util.tree_map(lambda p: (rng.randn(*p.shape) * 1e-2).astype(np.float32),
                                   params)
    state = jax.device_get(jax.jit(type(state).apply_gradients)(state, grads))
    for form, use_orbax in (("orbax", True), ("npz", False)):
        mgr = JaxCheckpointManager(str(root / form), use_orbax=use_orbax, async_save=False)
        mgr.save_epoch(state, 0, {"loss": 2.0}, {"loss": 1.5}, float("inf"), 0.0)
        mgr.wait()
    torch.save(CheckpointManager(str(root / "orbax")).load_raw("last")["model"], root / "w.pt")
    imgs = root / "imgs"
    imgs.mkdir()
    for i, (h, w) in enumerate([(70, 90), (64, 64), (100, 60)]):
        Image.fromarray((rng.rand(h, w) * 255).astype(np.uint8)).save(imgs / f"i{i}.png")
    return root / "orbax", root / "npz", root / "w.pt", imgs


@pytest.mark.parametrize("seed", [0, 1])
def test_load_deploy_model_matches_the_jax_predictor(jax_run, seed):
    d = jax_run[0]
    cfg = dict(img_size=IMG, batch_size=B, conf_threshold=0.25, bf16=False)
    tp = infer.Predictor(infer.load_deploy_model(ckpt=d, which="last", device="cpu"),
                         infer.PredictorConfig(**cfg), device="cpu")
    jm, jv = jax_load_deploy_model(JAX_CFG, scale="n", imgsz=IMG, ckpt=str(d), which="last")
    jp = JaxPredictor(jm, jv, JaxConfig(**cfg, nms_impl="pallas"))
    x = np.random.RandomState(seed).randint(0, 256, (B, IMG, IMG, 1)).astype(np.uint8)
    got = tp.predict_batch(x).numpy()
    _assert_packed_close(got, jp._infer_packed(jp.variables, x))
    assert got[..., 6].sum(1).min() >= 3  # detections exist in every image


def test_npz_form_loads_the_same_weights(jax_run):
    d, d_npz, _, _ = jax_run
    a = infer.load_deploy_model(ckpt=d, which="last", device="cpu").state_dict()
    b = infer.load_deploy_model(ckpt=d_npz, which="best", device="cpu").state_dict()
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def test_infer_export_and_serve_read_the_jax_dir(jax_run, tmp_path):
    d, _, w, imgs = jax_run
    ckpt = ["--ckpt", str(d), "--which", "last"]
    conf = ["--conf", "0.0"]
    got = infer.main(["--images", str(imgs)] + ckpt + CPU + conf)
    assert got == infer.main(["--images", str(imgs), "--weights", str(w)] + CPU + conf)
    assert all(r["scores"] for r in got)

    x = np.random.RandomState(1).randint(0, 256, (B, IMG, IMG, 1), dtype=np.uint8)
    outs = []
    for src in (ckpt, ["--weights", str(w)]):
        path = str(tmp_path / f"m{len(outs)}.pt2")
        E.main(src + CPU + conf + ["--out", path, "--check"])
        outs.append(E.ArtifactPredictor(E.load_artifact(path)).predict_batch(x))
    assert torch.equal(outs[0], outs[1]) and outs[0][..., 6].sum() > 0

    path = sorted(imgs.glob("*.png"))[0]
    served = _serve_one(ckpt + ["--port", "0"] + CPU + conf, path.read_bytes())
    (ref,) = [r for r in got if r["path"] == str(path)]
    assert served == {k: ref[k] for k in ("boxes", "scores", "labels")}


@pytest.mark.parametrize("ema", [False, True], ids=["raw", "ema"])
def test_val_reads_the_jax_dir(jax_run, tmp_path, ema):
    d = jax_run[0]
    args = CPU + ["--max-batches", "1", "--conf", "0.001"]
    got = val.main(args + ["--ckpt", str(d), "--which", "last"] + (["--ema"] if ema else []))
    tree = CheckpointManager(str(d)).load_raw("last")
    torch.save({**tree["model"], **(tree["ema"] if ema else {})}, tmp_path / "w.pt")
    assert got == val.main(args + ["--torch-ckpt", str(tmp_path / "w.pt")])


def test_eval_quant_reads_the_jax_ema(jax_run, capsys):
    d = jax_run[0]
    out = eval_quant.main(["--data", "synthetic", "--ckpt", str(d), "--which", "last",
                           "--device", "cpu", "--imgsz", str(IMG), "--batch", str(B),
                           "--calib-batches", "1", "--max-batches", "1"])
    assert "using EMA params" in capsys.readouterr().err
    assert json.loads(json.dumps(out))  # a JSON line, as the CLI prints it
