"""Port model (builder, modules, BN fold, weight bridge) vs the JAX package.

Tolerances: raw Detect maps in f32 agree to ``atol = 1e-4 * max|ref|``. The
two frameworks sum the conv and matmul products in different orders, so
ulp-level differences accumulate through ~100 layers; 1e-4 of the map's
range is far above that and far below any real layout or weight-mapping
fault (those show up at O(1) of the range).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from yolo_scratch_tpu.models.builder import build_yolo11 as jax_build
from yolo_scratch_tpu.models.builder import dims_from_params as jax_dims
from yolo_scratch_tpu.models.builder import parse_model_config as jax_parse
from yolo_scratch_tpu.nn.fuse import fuse_conv_bn as jax_fuse
from yolo_scratch_tpu.utils.torch_import import convert_reference_state_dict
from yolo_scratch_tpu_torch.models import builder as tb
from yolo_scratch_tpu_torch.nn.fuse import fuse_conv_bn
from yolo_scratch_tpu_torch.utils.weights import state_dict_from_jax

REPO = Path(__file__).resolve().parent.parent
YAML = {n: REPO / f"yolo_scratch_tpu/configs/{n}.yaml" for n in ("yolo11_crater", "yolo11_coco")}
IMGSZ = 64


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs six workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def perturbed_variables(variables, seed=0):
    """JAX init leaves BN at identity; randomise every BN leaf (and jitter
    the rest) so a wrong BN or weight mapping cannot hide."""
    rng = np.random.RandomState(seed)

    def walk(tree, path=()):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, path + (k,))
                continue
            a = np.asarray(v, np.float32)
            if k in ("scale", "var"):
                a = rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
            elif k in ("mean",) or (k == "bias" and "bn" in path):
                a = rng.normal(0.0, 0.1, a.shape).astype(np.float32)
            else:
                a = a + rng.normal(0.0, 0.01, a.shape).astype(np.float32)
            out[k] = a
        return out

    return {k: walk(v) for k, v in variables.items()}


@pytest.fixture(scope="module")
def crater_pair():
    """(JAX model, perturbed variables, port model with those weights)."""
    jm = jax_build(str(YAML["yolo11_crater"]), ch=1, nc=5, scale="n")
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, IMGSZ, IMGSZ, 1), jnp.float32))
    v = perturbed_variables(jax.device_get(v))
    tm = tb.build_yolo11(tb.CONFIGS / "yolo11_crater.json", ch=1, nc=5, scale="n")
    tm.load_state_dict(state_dict_from_jax(v))
    return jm, v, tm.eval()


@pytest.fixture(scope="module")
def jax_apply(crater_pair):
    jm = crater_pair[0]
    return jax.jit(lambda v, x: jm.apply(v, x, train=False))


def _images(seed=0, B=2, ch=1):
    return np.random.RandomState(seed).rand(B, IMGSZ, IMGSZ, ch).astype(np.float32)


def _assert_maps_close(got, ref, rel=1e-4):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        r = np.asarray(r, np.float32)
        g = g.detach().float().numpy()
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, rtol=0, atol=rel * np.abs(r).max())


def test_weight_bridge_round_trip(crater_pair):
    _, v, tm = crater_pair
    params, stats = convert_reference_state_dict(tm.state_dict())
    for tree, ref in ((params, v["params"]), (stats, v["batch_stats"])):
        flat_ref = jax.tree_util.tree_leaves_with_path(ref)
        flat_got = dict(jax.tree_util.tree_leaves_with_path(tree))
        assert len(flat_ref) == len(flat_got)
        for path, leaf in flat_ref:
            np.testing.assert_array_equal(flat_got[path], leaf)


def test_raw_maps_match_flax_f32(crater_pair, jax_apply):
    _, v, tm = crater_pair
    x = _images(1)
    ref = jax_apply(v, x)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    _assert_maps_close(got, ref)


def test_fused_matches_flax_fused_and_unfused(crater_pair, jax_apply):
    _, v, tm = crater_pair
    x = _images(2)
    fused = fuse_conv_bn(tm)
    assert not any(isinstance(m, torch.nn.BatchNorm2d) for m in fused.modules())
    with torch.no_grad():
        got_fused = fused(torch.from_numpy(x))
        got_plain = tm(torch.from_numpy(x))
    _assert_maps_close(got_fused, jax_apply(jax_fuse(v), x))
    _assert_maps_close(got_fused, [g.numpy() for g in got_plain])


@pytest.mark.parametrize("name,ch,nc", [("yolo11_crater", 1, 5), ("yolo11_coco", 3, 80)])
def test_strides_and_plan_match(name, ch, nc):
    cfg = json.loads((tb.CONFIGS / f"{name}.json").read_text())
    ref = jax_parse(cfg, ch=ch, nc=nc, scale="n")
    got = tb.parse_model_config(cfg, ch=ch, nc=nc, scale="n")
    assert got == ref
    with torch.device("meta"):
        model = tb.YOLOModel.from_config(cfg, ch=ch, nc=nc, scale="n")
    assert model.strides == jax_build(str(YAML[name]), ch=ch, nc=nc, scale="n").strides


@pytest.mark.parametrize("scale", ["n", "s", "m", "l", "x"])
def test_param_counts_match_jax(scale):
    jm = jax_build(str(YAML["yolo11_coco"]), ch=3, nc=80, scale=scale)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, IMGSZ, IMGSZ, 3), jnp.float32))
    ref = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes["params"]))
    with torch.device("meta"):
        tm = tb.YOLOModel.from_config(tb.CONFIGS / "yolo11_coco.json", ch=3, nc=80, scale=scale)
    assert sum(p.numel() for p in tm.parameters()) == ref


@pytest.mark.parametrize("name", ["yolo11_crater", "yolo11_coco"])
def test_json_config_equals_yaml(name):
    assert json.loads((tb.CONFIGS / f"{name}.json").read_text()) == yaml.safe_load(
        YAML[name].read_text())


def test_dims_from_params_matches_jax(crater_pair):
    _, v, tm = crater_pair
    assert tb.dims_from_params(tm.state_dict()) == jax_dims(v["params"]) == (1, 5)


def test_seeded_init_is_deterministic_and_keeps_global_rng():
    state = torch.random.get_rng_state()
    a = tb.build_yolo11(ch=1, nc=5, scale="n", seed=3).state_dict()
    b = tb.build_yolo11(ch=1, nc=5, scale="n", seed=3).state_dict()
    c = tb.build_yolo11(ch=1, nc=5, scale="n", seed=4).state_dict()
    assert torch.equal(torch.random.get_rng_state(), state)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["model.0.conv.weight"], c["model.0.conv.weight"])
    # Detect bias priors as in the JAX package (_cls_bias_prior)
    assert torch.all(a["model.23.cv2.0.2.bias"] == 1.0)
    assert torch.allclose(a["model.23.cv3.2.2.bias"],
                          torch.tensor(np.log(5.0 / 5 / 20.0 ** 2), dtype=torch.float32))
