"""Scale-out serving: ``Predictor.shard_over`` (the port's analog of
``tests/test_sharded_infer.py``) and ``parallel/mesh.py::make_mesh``.

Two replicas on the CPU (``Mesh((cpu, cpu))``) against the unsharded
Predictor on the same batch of 8, f32: the packed and the tuple outputs,
boxes and scores ``atol 1e-6``, labels and valid exact, for the crater
YOLO11n (96 px) and YOLOX-nano (64 px, BN leaves randomised). Against the
JAX ``shard_over`` on a 2-device virtual mesh with the same weights:
labels and valid exact; scores and normalised boxes ``atol 1e-5`` for
YOLO11 (``tests/test_torch_infer.py``'s cross-framework tolerance: the two
forwards sum conv products in different orders), ``1e-4`` for YOLOX, whose
maps agree to ``1e-4 * max|ref|`` (``tests/test_torch_yolox.py``) and whose
scores are products of two sigmoids of them (measured 4.4e-5).
"""

import numpy as np
import pytest
import torch

from tests.test_torch_infer import JAX_CFG, _seeded_model
from tests.test_torch_model import perturbed_variables
from tests.test_torch_yolox import jax_variables
from yolo_scratch_tpu.infer import Predictor as JaxPredictor
from yolo_scratch_tpu.infer import PredictorConfig as JaxConfig
from yolo_scratch_tpu.models.builder import build_yolo11 as jax_build
from yolo_scratch_tpu.models.yolox import YOLOXModel as JYOLOX
from yolo_scratch_tpu.parallel.mesh import make_mesh as jax_make_mesh
from yolo_scratch_tpu.utils.torch_import import convert_reference_state_dict
from yolo_scratch_tpu_torch.infer import Predictor, PredictorConfig
from yolo_scratch_tpu_torch.models.yolox import build_yolox
from yolo_scratch_tpu_torch.parallel.mesh import Mesh, make_mesh
from yolo_scratch_tpu_torch.utils.weights import state_dict_from_jax

B = 8
CPU2 = Mesh((torch.device("cpu"),) * 2)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs six workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _yolo11():
    tm = _seeded_model()
    params, stats = convert_reference_state_dict(tm.state_dict())
    cfg = dict(img_size=96, batch_size=B, conf_threshold=0.25, max_det=32, pre_nms_topk=128,
               bf16=False)
    return tm, jax_build(JAX_CFG, ch=1, nc=5, scale="n"), {"params": params,
                                                            "batch_stats": stats}, cfg, 1, 1e-5


def _yolox():
    v = perturbed_variables(jax_variables(build_yolox("nano", nc=5, ch=3).state_dict()))
    tm = build_yolox("nano", nc=5, ch=3)
    tm.load_state_dict(state_dict_from_jax(v))
    cfg = dict(img_size=64, batch_size=B, conf_threshold=0.01, max_det=32, pre_nms_topk=128,
               bf16=False)
    return tm.eval(), JYOLOX.from_scale("nano", nc=5), v, cfg, 3, 1e-4


FAMILIES = {"yolo11": _yolo11, "yolox": _yolox}


@pytest.fixture(scope="module", params=list(FAMILIES))
def family(request):
    return FAMILIES[request.param]()


def _images(seed, cfg, ch):
    S = cfg["img_size"]
    return np.random.RandomState(seed).randint(0, 256, (B, S, S, ch)).astype(np.uint8)


def _close(got, ref, atol):
    got, ref = [np.asarray(t) for t in got], [np.asarray(t) for t in ref]
    np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=atol)  # boxes
    np.testing.assert_allclose(got[1], ref[1], rtol=0, atol=atol)  # scores
    np.testing.assert_array_equal(got[2], ref[2])                  # labels
    np.testing.assert_array_equal(got[3], ref[3])                  # valid


def test_sharded_predictor_matches_single(family):
    tm, _, _, cfg, ch, _ = family
    x = _images(3, cfg, ch)
    single = Predictor(tm, PredictorConfig(**cfg), device="cpu")
    sharded = Predictor(tm, PredictorConfig(**cfg), device="cpu").shard_over(CPU2)
    first, second = sharded.replicas
    assert first.model is not second.model
    with torch.inference_mode():
        ref, got = single._infer(x), sharded._infer(x)
    assert int(ref[3].sum()) > 0
    _close(got, ref, 1e-6)
    packed, packed_ref = sharded.predict_batch(x), single.predict_batch(x)
    assert packed.shape == (B, cfg["max_det"], 7)
    np.testing.assert_allclose(packed.numpy(), packed_ref.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(packed[..., 5:].numpy(), packed_ref[..., 5:].numpy())


def test_sharded_predictor_matches_jax_shard_over(family):
    tm, jm, v, cfg, ch, jax_tol = family
    x = _images(5, cfg, ch)
    got = Predictor(tm, PredictorConfig(**cfg), device="cpu").shard_over(CPU2)
    ref = JaxPredictor(jm, v, JaxConfig(**cfg)).shard_over(jax_make_mesh(2))
    with torch.inference_mode():
        out = got._infer(x)
    ref_out = ref._infer(ref.variables, x)
    assert int(np.asarray(ref_out[3]).sum()) > 0
    _close(out, ref_out, jax_tol)


def test_shard_over_rejects_an_indivisible_batch():
    tm, _, _, cfg, _, _ = _yolo11()
    with pytest.raises(ValueError, match="not divisible"):
        Predictor(tm, PredictorConfig(**{**cfg, "batch_size": 6}), device="cpu").shard_over(
            Mesh((torch.device("cpu"),) * 4))


def test_make_mesh_raises_without_the_devices():
    """No fallback: a CUDA mesh larger than the visible cards raises, where
    the JAX ``make_mesh`` falls back to virtual CPU devices."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match="CUDA devices"):
        make_mesh(n + 1, "cuda")
    assert make_mesh(2, "cpu").devices == (torch.device("cpu"),) * 2
