"""The port's int8 PTQ tier (``nn/quant.py``, the ``ConvBNAct`` hooks,
``ops/int8_conv.py``) against the JAX package's (``nn/quant.py``), on the
CPU.

Stated tolerances:

* the int8 conv's int32 accumulators: exact against JAX's
  ``lax.conv_general_dilated(..., preferred_element_type=int32)`` and
  against the float64 plain version, dense, depthwise, strided, dilated and
  with K, N not multiples of 8;
* ``build_quant_tree`` on the same folded kernel and calibration: ``w_q``,
  ``s_w``, ``s_act`` exact; ``calibrate_quantile`` exact (the same f32
  interpolation); ``calibrate_absmax`` of the port's own f32 forward within
  rtol 1e-5 of JAX's (conv sums run in other orders, ~1e-6);
* the int8 forward on JAX's own quant tree, f32, at 96 px (YOLO11n) and
  64 px (YOLOX-nano): ``1e-5 * max|ref|`` per map. The int8 convs are
  exact; the float ops between them (SiLU, attention, the Detect 1x1
  convs) differ by ~1e-7 relative, and a flipped rounding at a
  quantisation step would show as ~1e-2 and fail (measured 2.8e-7);
* the port's own calibration and quantization against JAX's int8 forward:
  ``0.05 * max|ref|``, the JAX tests' int8-vs-float bound (its ``s_act``
  differ from JAX's by ulps, so some inputs round to the neighbouring
  step);
* the hand-computed block (dequant, BN, SiLU in numpy) against the block:
  JAX's own test's ``atol 2e-5, rtol 1e-4``.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_model import perturbed_variables
from tests.test_torch_train_step import one_torch_thread  # noqa: F401 (autouse fixture)
from tests.test_torch_yolox import jax_variables
from yolo_scratch_tpu.models.builder import build_yolo11 as jax_build
from yolo_scratch_tpu.models.yolox import YOLOXModel as JaxYOLOX
from yolo_scratch_tpu.nn import quant as JQ
from yolo_scratch_tpu.nn.fuse import fuse_conv_bn as jax_fuse
from yolo_scratch_tpu.nn.modules import ConvBNAct as JaxConvBNAct
from yolo_scratch_tpu.utils.torch_import import convert_reference_state_dict
from yolo_scratch_tpu_torch import export as E
from yolo_scratch_tpu_torch import infer
from yolo_scratch_tpu_torch.models import yolox as TX
from yolo_scratch_tpu_torch.models.builder import CONFIGS, build_yolo11
from yolo_scratch_tpu_torch.nn import quant as TQ
from yolo_scratch_tpu_torch.nn.fuse import fuse_conv_bn
from yolo_scratch_tpu_torch.nn.modules import ConvBNAct
from yolo_scratch_tpu_torch.ops.int8_conv import int8_conv2d, int8_conv2d_plain
from yolo_scratch_tpu_torch.utils.weights import _split_numeric, state_dict_from_jax

IMG = 96
JAX_CFG = str(CONFIGS.parent.parent / "yolo_scratch_tpu/configs/yolo11_crater.yaml")


# ------------------------------------------------------------ the int8 conv

# (name, c1, c2, k, stride, pad, dilation, groups, H, B)
CONV_CASES = [
    ("dense3x3", 16, 32, 3, 1, 1, 1, 1, 12, 2),
    ("stride2", 16, 32, 3, 2, 1, 1, 1, 13, 2),
    ("stem_k9", 1, 16, 3, 2, 1, 1, 1, 20, 2),  # K = 9: padded to 16
    ("pointwise_k20_n5", 20, 5, 1, 1, 0, 1, 1, 9, 2),  # K, N not multiples of 8
    ("depthwise", 24, 24, 3, 1, 1, 1, 24, 10, 2),  # the PSA pe conv
    ("dilated", 8, 16, 3, 1, 2, 2, 1, 11, 2),
    ("few_rows", 16, 8, 3, 1, 1, 1, 1, 3, 1),  # M = 9 rows: padded past 16
]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs six workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("case", CONV_CASES, ids=[c[0] for c in CONV_CASES])
def test_int8_conv2d_exact_against_xla_and_plain(case):
    _, c1, c2, k, s, p, d, g, H, B = case
    rng = np.random.RandomState(c1 + c2 + k)
    xq = rng.randint(-127, 128, (B, H, H, c1)).astype(np.int8)  # NHWC, as JAX takes it
    w = rng.randint(-127, 128, (k, k, c1 // g, c2)).astype(np.int8)  # HWIO
    ref = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(xq), jnp.asarray(w), (s, s), [(p, p), (p, p)], rhs_dilation=(d, d),
        feature_group_count=g, dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32))
    x_t = torch.from_numpy(xq).permute(0, 3, 1, 2)
    w_t = torch.from_numpy(w).permute(3, 2, 0, 1).contiguous()
    got = int8_conv2d(x_t, w_t, s, p, d, g)
    plain = int8_conv2d_plain(x_t, w_t, s, p, d, g)
    assert got.dtype == plain.dtype == torch.int32
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), ref)
    assert torch.equal(got, plain)


def test_int8_conv2d_rejects_float_and_grouped():
    x = torch.zeros((1, 4, 5, 5), dtype=torch.int8)
    with pytest.raises(TypeError):
        int8_conv2d(x.float(), torch.zeros((4, 4, 3, 3), dtype=torch.int8))
    with pytest.raises(ValueError, match="groups"):
        int8_conv2d(x, torch.zeros((4, 2, 3, 3), dtype=torch.int8), groups=2)


# ------------------------------------------------------------ one block

@pytest.fixture(scope="module")
def block():
    """(JAX block, its perturbed variables, the port block with them, x)."""
    jm = JaxConvBNAct(c2=8, k=3)
    x = np.random.RandomState(0).randn(2, 16, 16, 4).astype(np.float32)
    v = perturbed_variables(jax.device_get(jm.init(jax.random.PRNGKey(0), x)))
    tm = ConvBNAct(4, 8, 3)
    tm.load_state_dict(state_dict_from_jax(v))
    return jm, v, tm.eval(), x


def _nchw(x):
    """An NHWC batch as the NCHW tensor a block takes (a model takes NHWC)."""
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _copy(tm):
    m = ConvBNAct(4, 8, 3)
    m.load_state_dict(tm.state_dict())
    return m.eval()


def test_quant_block_matches_exact_int_math_and_jax(block):
    """The int8 branch IS symmetric int8: the port's calibration and quant
    buffers equal JAX's on the same block, and its output equals the int
    math done by hand (and JAX's block)."""
    jm, v, tm, x = block
    jcal = JQ.calibrate_absmax(jm, v, [x])
    q = JQ.build_quant_tree(v["params"], jcal)
    tm = _copy(tm)
    cal = TQ.calibrate_absmax(tm, [_nchw(x)])
    assert float(cal[""]) == float(jcal["absmax"])
    built = TQ.build_quant_tree(tm, cal)
    assert set(built) == {""} and tm.w_q.dtype == torch.int8
    np.testing.assert_array_equal(tm.w_q.permute(2, 3, 1, 0).numpy(), np.asarray(q["w_q"]))
    np.testing.assert_array_equal(tm.s_w.numpy(), np.asarray(q["s_w"]))
    assert tm.s_act.dtype == torch.float32 and float(tm.s_act) == float(q["s_act"])

    with torch.no_grad():
        got = tm(_nchw(x)).permute(0, 2, 3, 1).numpy()
    s_act = np.float32(q["s_act"])
    xq = np.clip(np.round(x / s_act), -127, 127).astype(np.int8)
    acc = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(xq), q["w_q"], (1, 1), [(1, 1), (1, 1)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32))
    deq = acc.astype(np.float32) * (s_act * np.asarray(q["s_w"]))
    pbn, sbn = v["params"]["bn"], v["batch_stats"]["bn"]
    g = np.asarray(pbn["scale"]) / np.sqrt(np.asarray(sbn["var"]) + 1e-3)
    bn = (deq - np.asarray(sbn["mean"])) * g + np.asarray(pbn["bias"])
    np.testing.assert_allclose(got, bn / (1 + np.exp(-bn)), atol=2e-5, rtol=1e-4)
    ref = np.asarray(jm.apply({**v, "quant": q}, x, train=False))
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-4)


def _quantized_copy(tm, x):
    m = _copy(tm)
    TQ.build_quant_tree(m, TQ.calibrate_absmax(m, [_nchw(x)]))
    return m


def test_quant_error_small_vs_float(block):
    _, _, tm, x = block
    m = _quantized_copy(tm, x)
    with torch.no_grad():
        y_f, y_q = tm(_nchw(x)), m(_nchw(x))
    assert (y_f - y_q).abs().max() < 0.05 * y_f.abs().max()
    assert not torch.equal(y_f, y_q)


def test_calib_hook_inert_outside_calibration(block):
    """No calibration: no record, no buffers, the same output; calibrating
    leaves the output alone and the block as it was."""
    _, _, tm, x = block
    keys = set(tm.state_dict())
    with torch.no_grad():
        y0 = tm(_nchw(x))
    assert tm.calib is None and tm.calib_out is None
    with TQ._calibrating(tm, "absmax"):
        y1 = tm(_nchw(x))
        assert float(tm.calib_out) == float(np.abs(x).max())
    assert torch.equal(y0, y1)
    assert tm.calib is None and tm.calib_out is None and tm.w_q is None
    assert set(tm.state_dict()) == keys and not tm.training


def test_quant_ignored_in_train_mode(block):
    """train() never takes the int8 path, with the buffers attached."""
    _, _, tm, x = block
    m = _quantized_copy(tm, x)
    ref = _copy(tm)
    m.train(), ref.train()
    with torch.no_grad():
        assert torch.equal(m(_nchw(x)), ref(_nchw(x)))
    assert torch.equal(m.bn.running_mean, ref.bn.running_mean)


def test_skip_predicate(block):
    _, _, tm, x = block
    m = _copy(tm)
    assert TQ.build_quant_tree(m, TQ.calibrate_absmax(m, [_nchw(x)]), skip=lambda p: True) == {}
    assert TQ.count_quantized(m) == 0 and m.w_q is None


def test_quantile_calibration_clips_outliers_and_matches_jax(block):
    """Percentile calibration ignores the outlier that absmax tracks, and
    its f32 interpolation equals ``jnp.quantile``'s bit for bit."""
    jm, v, tm, _ = block
    x = np.random.RandomState(0).randn(2, 16, 16, 4).astype(np.float32)
    x[0, 0, 0, 0] = 50.0  # a single hot pixel
    am = TQ.calibrate_absmax(tm, [_nchw(x)])
    qt = TQ.calibrate_quantile(tm, [_nchw(x), _nchw(x * 0.5)], q=0.999)
    jqt = JQ.calibrate_quantile(jm, v, [x, x * 0.5], q=0.999)
    assert float(am[""]) == 50.0
    assert float(qt[""]) == float(jqt["absmax"]) < 5.0
    m = _copy(tm)
    TQ.build_quant_tree(m, qt)
    with torch.no_grad():
        assert torch.isfinite(m(_nchw(x))).all()


@pytest.mark.parametrize("n", [2048, 18433])
def test_quantile_interpolation_matches_jnp(n):
    t = np.random.RandomState(n).randn(n).astype(np.float32)
    for q in (0.5, 0.9, 0.999, 1.0):
        assert float(TQ._quantile(torch.from_numpy(t), q)) == float(
            jnp.quantile(jnp.abs(jnp.asarray(t)), q))


# ------------------------------------------------------------ whole models

def _seeded_yolo11(seed=3):
    """The port's seeded YOLO11n with random BN statistics (so folding
    matters) and zeroed class priors (so detections pass the gate)."""
    model = build_yolo11(CONFIGS / "yolo11_crater.json", ch=1, nc=5, scale="n", seed=seed)
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.weight.copy_(torch.from_numpy(rng.uniform(0.3, 0.8, n).astype(np.float32)))
                m.bias.copy_(torch.from_numpy(rng.normal(0, 0.2, n).astype(np.float32)))
                m.running_mean.copy_(torch.from_numpy(rng.normal(0, 0.1, n).astype(np.float32)))
                m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32)))
        for cls in model.model[-1].cv3:
            cls[2].bias.zero_()
    return model.eval()


@pytest.fixture(scope="module")
def yolo11():
    """(JAX model, JAX f32 variables, JAX int8 variables, port f32 model,
    port model carrying JAX's int8 tree, calibration batch)."""
    tm = _seeded_yolo11()
    params, stats = convert_reference_state_dict(tm.state_dict())
    jm = jax_build(JAX_CFG, ch=1, nc=5, scale="n")
    v = {"params": params, "batch_stats": stats}
    x = np.random.RandomState(1).rand(2, IMG, IMG, 1).astype(np.float32)
    vq = JQ.quantize_for_deploy(jm, v, [x])
    tq = build_yolo11(CONFIGS / "yolo11_crater.json", ch=1, nc=5, scale="n")
    tq.load_state_dict(state_dict_from_jax(vq))
    return jm, v, vq, tm, tq.eval(), x


@pytest.fixture(scope="module")
def jax_apply(yolo11):
    jm = yolo11[0]
    return jax.jit(lambda vv, xx: jm.apply(vv, xx, train=False))


def _assert_maps(got, ref, rel):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        r = np.asarray(r, np.float32)
        g = g.detach().float().numpy()
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, rtol=0, atol=rel * np.abs(r).max())


def test_int8_forward_on_jax_quant_tree_matches_jax(yolo11, jax_apply):
    _, _, vq, _, tq, x = yolo11
    assert TQ.count_quantized(tq) == JQ.count_quantized(vq["quant"]) == 77
    x2 = np.random.RandomState(2).rand(2, IMG, IMG, 1).astype(np.float32)
    for xx in (x, x2):
        with torch.no_grad():
            got = tq(torch.from_numpy(xx))
        _assert_maps(got, jax_apply(vq, xx), 1e-5)


def test_build_quant_tree_exact_on_the_same_folded_kernel(yolo11):
    """JAX's folded weights and JAX's calibration into the port's builder:
    every w_q, s_w and s_act equals JAX's quant tree."""
    jm, v, vq, _, _, x = yolo11
    fused = jax_fuse(v)
    tf = build_yolo11(CONFIGS / "yolo11_crater.json", ch=1, nc=5, scale="n")
    tf.load_state_dict(state_dict_from_jax(fused))
    calib = {}

    def walk(tree, path=()):
        if "absmax" in tree:
            calib[".".join(_split_numeric(p) for p in path)] = torch.tensor(
                np.asarray(tree["absmax"]))
        for k, node in tree.items():
            if isinstance(node, dict):
                walk(node, path + (k,))

    walk(JQ.calibrate_absmax(jm, fused, [x]))
    built = TQ.build_quant_tree(tf, calib)
    assert len(built) == 77
    want = state_dict_from_jax(vq)
    got = tf.state_dict()
    keys = [k for k in want if k.endswith(("w_q", "s_w", "s_act"))]
    assert len(keys) == 3 * 77
    for k in keys:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def test_calibrate_absmax_matches_jax(yolo11):
    jm, v, _, tm, _, x = yolo11
    cal = TQ.calibrate_absmax(fuse_conv_bn(tm), [x, x[::-1] * 0.7])
    jcal = JQ.calibrate_absmax(jm, jax_fuse(v), [x, x[::-1] * 0.7])
    flat = {}

    def walk(tree, path=()):
        if "absmax" in tree:
            flat[".".join(_split_numeric(p) for p in path)] = float(tree["absmax"])
        for k, node in tree.items():
            if isinstance(node, dict):
                walk(node, path + (k,))

    walk(jcal)
    assert set(cal) == set(flat) and len(cal) == 77
    for k, ref in flat.items():
        assert abs(float(cal[k]) - ref) <= 1e-5 * ref, k


def test_full_model_quantization(yolo11, jax_apply):
    """The port's own pipeline (fold, calibrate, quantize) against JAX's
    int8 forward; and int8 close to float, as JAX's test holds it."""
    _, _, vq, tm, _, x = yolo11
    tq = TQ.quantize_for_deploy(tm, [x])
    assert TQ.count_quantized(tq) == 77 and TQ.count_quantized(tm) == 0
    with torch.no_grad():
        yq, yf = tq(torch.from_numpy(x)), tm(torch.from_numpy(x))
    _assert_maps(yq, jax_apply(vq, x), 0.05)
    _assert_maps(yq, [a.numpy() for a in yf], 0.05)


def test_quantize_for_deploy_quantile_mode(yolo11):
    _, _, _, tm, _, x = yolo11
    tq = TQ.quantize_for_deploy(tm, [x], quantile=0.999)
    assert TQ.count_quantized(tq) > 50
    with torch.no_grad():
        yq, yf = tq(torch.from_numpy(x)), tm(torch.from_numpy(x))
    _assert_maps(yq, [a.numpy() for a in yf], 0.08)


def test_weight_bridge_and_fuse_carry_quantized_blocks(yolo11):
    """A quantized model's state_dict loads into a fresh model (the int8
    buffers included, dtypes kept); folding a quantized unfolded model
    keeps every block quantized and its output."""
    _, _, vq, _, tq, x = yolo11
    fresh = build_yolo11(CONFIGS / "yolo11_crater.json", ch=1, nc=5, scale="n")
    fresh.load_state_dict(tq.state_dict())
    assert TQ.count_quantized(fresh) == 77
    assert fresh.model[0].w_q.dtype == torch.int8 and fresh.model[0].s_act.dtype == torch.float32
    folded = fuse_conv_bn(fresh.eval())
    assert TQ.count_quantized(folded) == 77
    with torch.no_grad():
        _assert_maps(folded(torch.from_numpy(x)), [a.numpy() for a in tq(torch.from_numpy(x))],
                     1e-6)


def test_predictor_serves_quantized_model(yolo11, tmp_path):
    """The deploy path: the bf16 cast keeps w_q int8 and the scales f32; the
    f32 int8 Predictor's detections agree with JAX's int8 Predictor at
    tests/test_torch_infer.py's tolerances; predict_paths runs on files."""
    import cv2

    from yolo_scratch_tpu.infer import Predictor as JaxPredictor
    from yolo_scratch_tpu.infer import PredictorConfig as JaxConfig

    jm, _, vq, _, tq, _ = yolo11
    bf16 = infer.Predictor(tq, infer.PredictorConfig(img_size=IMG, batch_size=2), device="cpu")
    blk = bf16.model.model[0]
    assert blk.w_q.dtype == torch.int8 and blk.conv.weight.dtype == torch.bfloat16
    assert blk.s_w.dtype == blk.s_act.dtype == torch.float32
    assert TQ.count_quantized(bf16.model) == 77

    kw = dict(img_size=IMG, batch_size=2, conf_threshold=0.25, bf16=False)
    tp = infer.Predictor(tq, infer.PredictorConfig(**kw), device="cpu")
    jp = JaxPredictor(jm, vq, JaxConfig(**kw, nms_impl="xla"))
    xb = np.random.RandomState(4).randint(0, 256, (2, IMG, IMG, 1)).astype(np.uint8)
    got = tp.predict_batch(xb).numpy()
    ref = np.asarray(jp._infer_packed(jp.variables, xb))
    assert got[..., 6].sum() >= 3
    np.testing.assert_array_equal(got[..., 5:], ref[..., 5:])  # labels, valid
    np.testing.assert_allclose(got[..., :5], ref[..., :5], rtol=0, atol=1e-5)

    paths = []
    for i in range(3):
        p = str(tmp_path / f"im{i}.png")
        cv2.imwrite(p, (np.random.RandomState(i).rand(80, 96) * 255).astype(np.uint8))
        paths.append(p)
    results = list(bf16.predict_paths(paths))
    assert [r["path"] for r in results] == paths
    for r in results:
        assert len(r["boxes"]) == len(r["scores"]) == len(r["labels"])


def test_int8_export_roundtrip(yolo11, tmp_path):
    """The int8 program exports with its buffers baked in; the artifact's
    output equals the live Predictor's exactly."""
    tq = yolo11[4]
    pred = infer.Predictor(tq, infer.PredictorConfig(img_size=IMG, batch_size=2,
                                                     conf_threshold=0.001, max_det=32,
                                                     pre_nms_topk=128), device="cpu")
    xb = np.random.default_rng(3).integers(0, 256, (2, IMG, IMG, 1), np.uint8)
    live = pred.predict_batch(xb)
    path = str(tmp_path / "int8.pt2")
    E.save_artifact(E.export_predictor(pred), path)
    art = E.load_artifact(path)
    targets = [str(n.target) for n in art.graph.nodes]
    assert targets.count("yst.int8_conv2d.default") == 77
    assert targets.count("yst.nms_sweep_batched.default") == 1
    assert torch.equal(E.ArtifactPredictor(art).predict_batch(xb), live)


def test_yolox_int8():
    """The quant tier covers YOLOX (the same ConvBNAct): on JAX's quant tree
    the port's int8 forward equals JAX's; the count matches."""
    jm = JaxYOLOX.from_scale("nano", nc=5)
    v = perturbed_variables(jax_variables(TX.build_yolox("nano", nc=5, ch=3).state_dict()))
    x = np.random.RandomState(2).rand(1, 64, 64, 3).astype(np.float32)
    vq = JQ.quantize_for_deploy(jm, v, [x])
    tq = TX.build_yolox("nano", nc=5, ch=3)
    tq.load_state_dict(state_dict_from_jax(vq))
    assert TQ.count_quantized(tq) == JQ.count_quantized(vq["quant"]) > 30
    ref = jax.jit(lambda vv, xx: jm.apply(vv, xx, train=False))(vq, x)
    with torch.no_grad():
        got = tq.eval()(torch.from_numpy(x))
    _assert_maps(got, ref, 1e-5)
    # the port's own pipeline on the seeded init (BN at identity), held to
    # int8-vs-float as JAX's test holds its init: 0.06 of max|ref| (the
    # perturbed weights above lie 0.08-0.10 off float in JAX itself)
    tm = TX.build_yolox("nano", nc=5, ch=3).eval()
    own = TQ.quantize_for_deploy(tm, [x])
    assert TQ.count_quantized(own) == TQ.count_quantized(tq)
    with torch.no_grad():
        yq, yf = own(torch.from_numpy(x)), tm(torch.from_numpy(x))
    _assert_maps(yq, [a.numpy() for a in yf], 0.06)


def test_serve_daemon_int8(yolo11):
    """HTTP serving over a quantized Predictor: the response equals
    predict_paths on the same file."""
    import threading
    import urllib.request

    import cv2

    from yolo_scratch_tpu_torch.serve import BatchingServer, make_http_server

    tq = yolo11[4]
    pred = infer.Predictor(tq, infer.PredictorConfig(img_size=IMG, batch_size=2,
                                                     conf_threshold=0.01), device="cpu")
    batching = BatchingServer(pred, max_wait_ms=50.0)
    httpd = make_http_server(batching, port=0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        ok, png = cv2.imencode(".png", (np.random.RandomState(0).rand(80, 96) * 255)
                               .astype(np.uint8))
        req = urllib.request.Request(f"http://127.0.0.1:{httpd.server_address[1]}/v1/detect",
                                     data=png.tobytes(), method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            out = json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        batching.close()
    t.join(timeout=10)
    assert not t.is_alive()
    assert set(out) == {"boxes", "scores", "labels"}


def test_export_and_infer_cli_int8(tmp_path, capsys):
    """The export CLI with --int8-calib-dir writes an int8 artifact that
    loads and runs (--check); the infer CLI serves int8 with --int8-calib."""
    import cv2

    calib_dir = tmp_path / "calib"
    calib_dir.mkdir()
    for i in range(3):
        cv2.imwrite(str(calib_dir / f"c{i}.png"),
                    (np.random.RandomState(i).rand(IMG, IMG) * 255).astype(np.uint8))
    out = str(tmp_path / "int8.pt2")
    E.main(["--imgsz", str(IMG), "--batch", "2", "--int8-calib-dir", str(calib_dir),
            "--out", out, "--check", "--device", "cpu"])
    log = capsys.readouterr().out
    assert "int8: quantized 77 conv blocks" in log and "check ok: packed (2, 300, 7)" in log
    results = infer.main(["--images", str(calib_dir), "--imgsz", str(IMG), "--batch", "2",
                          "--int8-calib", "1", "--conf", "0.0", "--device", "cpu"])
    assert len(results) == 3 and "int8: quantized 77" in capsys.readouterr().out
