"""The port's legacy model (``models/legacy.py``) against the JAX
``YOLOScratchModel`` through the weight bridge
(``utils/weights.py::state_dict_from_jax``), eval mode, f32, at a small
``width_mult`` and 64 px.

Stated tolerances: every per-scale map within ``1e-5 * max|ref|``
(measured 2.4e-6: the conv sums run in other orders); shapes, key names and
the parameter count exact; ``decode_legacy_bbox`` within 1 ulp-scale
``1e-6``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from yolo_scratch_tpu.models.legacy import YOLOScratchModel as JaxLegacy
from yolo_scratch_tpu.models.legacy import decode_legacy_bbox as jax_decode
from yolo_scratch_tpu_torch.models.legacy import YOLOScratchModel, build_legacy, decode_legacy_bbox
from yolo_scratch_tpu_torch.utils.model_info import count_params
from yolo_scratch_tpu_torch.utils.weights import state_dict_from_jax


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs six workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_stats(variables, seed):
    """The init tree with random BN statistics (flax inits them to 0/1)."""
    rng = np.random.RandomState(seed)
    stats = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32), variables["batch_stats"])
    return {"params": variables["params"], "batch_stats": stats}


@pytest.mark.parametrize("width_mult,ch,nc", [(0.25, 1, 5), (0.5, 3, 3)])
def test_legacy_forward_matches_jax(width_mult, ch, nc):
    x = np.random.RandomState(0).rand(2, 64, 64, ch).astype(np.float32)
    jm = JaxLegacy(num_classes=nc, width_mult=width_mult)
    v = _random_stats(jax.jit(jm.init)(jax.random.PRNGKey(0), x), 1)
    ref = jax.jit(lambda vv, xx: jm.apply(vv, xx, train=False))(v, x)
    model = build_legacy(nc, width_mult, ch)
    sd = state_dict_from_jax(v)
    assert sorted(sd) == sorted(model.state_dict())
    model.load_state_dict(sd)
    assert count_params(model) == sum(np.asarray(a).size
                                      for a in jax.tree_util.tree_leaves(v["params"]))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    assert len(got) == len(ref) == 4
    for s, (g, r) in enumerate(zip(got, ref)):
        assert list(g) == ["bbox", "objectness", "classes"] and sorted(g) == sorted(r)
        for k in r:
            rr = np.asarray(r[k])
            assert g[k].shape == rr.shape == (2, 64 // 4 >> s, 64 // 4 >> s, rr.shape[-1])
            np.testing.assert_allclose(g[k].numpy(), rr, rtol=0, atol=1e-5 * np.abs(rr).max(),
                                       err_msg=f"scale {s} {k}")
        dec = decode_legacy_bbox(g["bbox"]).numpy()
        np.testing.assert_allclose(dec, np.asarray(jax_decode(jnp.asarray(g["bbox"].numpy()))),
                                   rtol=0, atol=1e-6)


def test_full_width_model_size():
    """``YOLOScratchModel()`` at width_mult 1.15: the FPN width int(160 x
    1.15) = 184, ~9.2 M parameters; seeded init is reproducible."""
    a, b = build_legacy(seed=4), build_legacy(seed=4)
    assert a.neck.smooth_p2.conv.out_channels == int(160 * 1.15) == 184
    assert count_params(a) == 9_228_675
    assert all(torch.equal(p, q) for p, q in zip(a.state_dict().values(),
                                                 b.state_dict().values()))
    assert isinstance(a, YOLOScratchModel) and a.head.bbox_0_0.bias is not None
