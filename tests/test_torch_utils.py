"""The port's ``utils/model_info.py``, ``utils/guards.py`` and
``utils/profiling.py`` against the JAX modules, on the CPU.

Stated tolerances: parameter counts exact; the FLOP count against JAX's
``cost_analysis`` at the port/JAX ratio ``utils/model_info.py`` states for
64 px (1.1762 for YOLO11n, 1.1685 for YOLOX-nano), within 0.5%: the port
counts the conv taps on the zero padding, XLA does not.
"""

import numpy as np
import pytest
import torch

import jax

from yolo_scratch_tpu.models.builder import build_yolo11 as jax_build
from yolo_scratch_tpu.models.yolox import YOLOXModel
from yolo_scratch_tpu.utils import guards as jguards
from yolo_scratch_tpu.utils.model_info import count_params as jax_count
from yolo_scratch_tpu.utils.model_info import model_info as jax_info
from yolo_scratch_tpu_torch.models.builder import CONFIGS, build_yolo11
from yolo_scratch_tpu_torch.models.yolox import build_yolox
from yolo_scratch_tpu_torch.utils.guards import checkify_fn, finite_or_raise, tree_all_finite
from yolo_scratch_tpu_torch.utils.model_info import count_params, model_info
from yolo_scratch_tpu_torch.utils.profiling import annotate, time_fn, trace

JAX_CFG = str(CONFIGS.parent.parent / "yolo_scratch_tpu/configs/yolo11_crater.yaml")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs six workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("family,ratio", [("yolo11n", 1.1762), ("yolox-nano", 1.1685)])
def test_model_info_matches_jax(family, ratio):
    if family == "yolo11n":
        jm, ch = jax_build(JAX_CFG, ch=1, nc=5, scale="n"), 1
        tm = build_yolo11(CONFIGS / "yolo11_crater.json", ch=1, nc=5, scale="n")
    else:
        jm, ch = YOLOXModel.from_scale("nano", nc=80), 3
        tm = build_yolox("nano", nc=80, ch=3)
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), np.zeros((1, 64, 64, ch), np.float32))
    ref = jax_info(jm, v, img_size=64, channels=ch)
    tm.train()
    got = model_info(tm, img_size=64, channels=ch)
    assert tm.training  # the mode is restored
    n_buffers = sum(b.numel() for b in tm.buffers())
    assert got["params"] == ref["params"] == count_params(tm)
    assert count_params(tm.state_dict()) == got["params"] + n_buffers
    assert got["params"] == {"yolo11n": 3_072_127, "yolox-nano": 2_257_055}[family]
    assert got["params_m"] == pytest.approx(ref["params_m"])
    assert got["gflops"] / ref["gflops"] == pytest.approx(ratio, rel=5e-3)
    assert jax_count(v["params"]) == got["params"]


def test_guards():
    ok = {"a": torch.ones(3), "b": [torch.zeros(2, dtype=torch.int64), (torch.tensor(1.0),)]}
    assert bool(tree_all_finite(ok)) and bool(tree_all_finite({}))
    bad = {**ok, "c": torch.tensor([1.0, float("nan")])}
    assert not bool(tree_all_finite(bad))
    model = build_yolo11(CONFIGS / "yolo11_crater.json", ch=1, nc=5, scale="n")
    assert bool(tree_all_finite(model)) and bool(tree_all_finite(model.state_dict()))
    with torch.no_grad():
        next(model.parameters())[0] = float("inf")
    assert not bool(tree_all_finite(model))
    assert bool(jguards.tree_all_finite({"a": np.ones(3)})) == bool(tree_all_finite(ok))
    finite_or_raise({"loss": 1.0, "lr": np.float32(0.1)})
    for fn in (finite_or_raise, jguards.finite_or_raise):  # the same message
        with pytest.raises(FloatingPointError,
                           match=r"non-finite metrics in eval: \{'loss': nan\}"):
            fn({"loss": float("nan"), "lr": 0.1}, context="eval")
    with pytest.raises(NotImplementedError, match="checkify_fn"):
        checkify_fn(lambda x: x)


def test_time_fn_and_trace_on_the_cpu(tmp_path):
    calls = []

    def fn(x):
        calls.append(1)
        return {"y": x * 2}

    x = torch.ones(4)
    sec, out = time_fn(fn, x, iters=3, warmup=2)
    assert sec >= 0 and len(calls) == 5 and torch.equal(out["y"], x * 2)
    with trace(str(tmp_path)):
        with annotate("double"):
            fn(x)
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1 and b"double" in files[0].read_bytes()
