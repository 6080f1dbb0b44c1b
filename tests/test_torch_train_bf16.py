"""Port train step in bf16 mixed precision (``--bf16``) vs the JAX
package's, from the same state. Crater YOLO11n at 64 px, B=4, the JAX
initial weights carried across (``test_torch_train_step.py``'s helpers,
``test_torch_train_modes.py``'s setup).

The step computes in bf16: every convolution's output is bf16 and the
loss receives f32 maps (forward hooks, exact). Stated tolerances:

bf16 (``compute_dtype=torch.bfloat16``, autocast, against the JAX step
with ``compute_dtype=jnp.bfloat16``): the loss ``rtol = 0.15`` against
the JAX bf16 loss and against the f32 step's, the bound of the JAX
package's own bf16 test (``tests/test_mixed_precision.py``); BN running
variances ``rtol = 0.15``. The two frameworks round to bf16 in other
places (JAX casts every parameter and activation; autocast casts each
convolution's and matmul's operands), and on a randomly initialised
network the loss moves by several percent with where the rounding
falls: measured 3.0% between the two bf16 steps, 7.3% on a running
variance (JAX bf16 against JAX f32: 6.9%). The moments are not compared:
a bf16 gradient differs from another bf16 gradient by O(1) of max|g| in
some tensors, as it does from the f32 one. Master weights, both moments,
the EMA and the BN statistics stay f32 and finite.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_train_modes import _port_run, setup  # noqa: F401 (fixture)
from tests.test_torch_train_step import _port_state, _sd, one_torch_thread  # noqa: F401
from yolo_scratch_tpu.train.steps import build_train_step_custom as jax_step
from yolo_scratch_tpu_torch.losses.v8_loss import DetectionLossConfig
from yolo_scratch_tpu_torch.train.steps import build_train_step_custom, v8_loss_adapter


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs six workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bf16_step_dtypes(tm, ts, batch):
    """One ``compute_dtype=bf16`` step of ``tm``: (the dtypes of every
    convolution's output, the dtypes of the maps the loss receives, the
    metrics)."""
    conv_out, loss_in = set(), set()
    hooks = [m.register_forward_hook(lambda _m, _i, out: conv_out.add(out.dtype))
             for m in tm.modules() if isinstance(m, torch.nn.Conv2d)]
    adapter = v8_loss_adapter(DetectionLossConfig(nc=5, strides=tm.strides))

    def loss_fn(feats, b):
        loss_in.update(f.dtype for f in feats)
        return adapter(feats, b)

    step = build_train_step_custom(tm, loss_fn, compute_dtype=torch.bfloat16,
                                   matmul_precision="highest")
    try:
        _, metrics = step(ts, batch)
    finally:
        for h in hooks:
            h.remove()
    return conv_out, loss_in, metrics


def test_bf16_step_tracks_jax_bf16(setup):
    jm, state, batch, loss_fn = setup
    j_next, j_metrics = jax.jit(jax_step(jm, loss_fn, compute_dtype=jnp.bfloat16,
                                         matmul_precision="highest"))(state, batch)
    tm, ts = _port_state(state)
    conv_out, loss_in, metrics = bf16_step_dtypes(tm, ts, batch)
    # the step computes in bf16: every convolution, forward and recompute alike
    assert conv_out == {torch.bfloat16} and loss_in == {torch.float32}
    _, _, metrics32, _ = _port_run(state, batch)
    loss, ref = float(metrics["loss"]), float(j_metrics["loss"])
    np.testing.assert_allclose(loss, ref, rtol=0.15)
    np.testing.assert_allclose(loss, float(metrics32["loss"]), rtol=0.15)
    np.testing.assert_allclose(ref, float(metrics32["loss"]), rtol=0.15)
    tensors = [*tm.state_dict().values(), *ts.opt_state.mu, *ts.opt_state.nu, *ts.ema.values()]
    for t in tensors:
        if t.is_floating_point():
            assert t.dtype == torch.float32 and bool(torch.isfinite(t).all())
    ref_sd = _sd({"params": j_next.params, "batch_stats": j_next.batch_stats})
    sd = tm.state_dict()
    for k, r in ref_sd.items():
        if k.endswith("running_var"):
            np.testing.assert_allclose(sd[k].numpy(), r.numpy(), rtol=0.15, err_msg=k)
