"""``yolo_scratch_tpu_torch/profile_train.py`` against
``scripts/profile_train.py`` on the CPU, at 64 px, B=2.

The JAX script runs as it is (``--iters 1 --no-trace``) with ``jax.jit``
wrapped to record its first step's arguments and metrics. The port's
synthetic batch equals the batch the JAX step received, array for array
(keys, dtypes, shapes and values: the same ``RandomState(0)`` draws in the
same order, the overwritten box draw included).

The first loss, on the JAX script's initial weights bridged by
``utils/weights.py::state_dict_from_jax``: the port's f32 step is the
reference (``tests/test_torch_train_step.py`` holds it to the JAX f32 step
at ``rtol = 1e-4``; on this batch the two read 14.79747 and 14.79889).
The port's bf16 step (autocast) and the JAX script's bf16 step each lie
within ``rtol = 0.15`` of it, the bf16 tolerance of
``tests/test_torch_train_bf16.py``, where the reasons are given: measured
+7.7% and -10.8%. The two bf16 losses therefore lie 20.8% apart (15.94
against 13.20), past the 0.15 that test holds them to on its batch (3.0%
there): each framework rounds other tensors to bf16 on a random network
whose loss on these boxes moves by ~10% with where the rounding falls, so
they are held to each other within ``rtol = 0.25``.
"""

import copy
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from yolo_scratch_tpu_torch import profile_train
from yolo_scratch_tpu_torch.models.builder import CONFIGS, build_yolo11
from yolo_scratch_tpu_torch.train.steps import batch_to_device
from yolo_scratch_tpu_torch.utils.weights import state_dict_from_jax

ROOT = Path(__file__).resolve().parent.parent
B, IMG = 2, 64


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs six workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_first_step():
    """(state, batch, metrics) of the JAX script's first step."""
    spec = importlib.util.spec_from_file_location("jax_profile_train",
                                                  ROOT / "scripts" / "profile_train.py")
    mod = importlib.util.module_from_spec(spec)
    cache_dir = jax.config.jax_compilation_cache_dir
    spec.loader.exec_module(mod)
    jax.config.update("jax_compilation_cache_dir", cache_dir)  # the script sets its own
    seen, real_jit = {}, jax.jit

    class FirstStep(Exception):
        pass

    def spy_jit(fn, **kw):
        jitted = real_jit(fn, **kw)

        def call(*args):
            out = jitted(*args)
            if len(args) == 2 and isinstance(args[1], dict) and "img" in args[1]:
                seen.update(state=args[0], batch=args[1], metrics=out[1])
                raise FirstStep  # the script's timing loops are not needed
            return out
        return call

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "jit", spy_jit)
        mp.setattr(sys, "argv", ["profile_train.py", "--batch", str(B), "--imgsz", str(IMG),
                                 "--iters", "1", "--no-trace"])
        with pytest.raises(FirstStep):
            mod.main()
    return (jax.device_get(seen["state"]), seen["batch"],
            {k: float(v) for k, v in seen["metrics"].items()})


def test_batch_is_the_jax_scripts(jax_first_step):
    _, ref, _ = jax_first_step
    got = profile_train.synthetic_batch(B, IMG)
    assert list(got) == list(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_first_loss_tracks_the_jax_script(jax_first_step):
    state, _, ref = jax_first_step
    model = build_yolo11(CONFIGS / "yolo11_crater.json", ch=1, nc=5, scale="n")
    model.load_state_dict(state_dict_from_jax({"params": state.params,
                                               "batch_stats": state.batch_stats}))
    batch = batch_to_device(profile_train.synthetic_batch(B, IMG), torch.device("cpu"))
    losses = {}
    for bf16 in (False, True):
        tstate, step = profile_train.build(copy.deepcopy(model), bf16=bf16)
        _, metrics = step(tstate, batch)
        assert int(tstate.step) == 1 and tstate.ema is not None
        losses[bf16] = float(metrics["loss"])
    np.testing.assert_allclose(losses[True], losses[False], rtol=0.15)
    np.testing.assert_allclose(ref["loss"], losses[False], rtol=0.15)
    np.testing.assert_allclose(losses[True], ref["loss"], rtol=0.25)
