"""The port's fused bottleneck (``yolo_scratch_tpu_torch/ops/conv_kernels.py``)
against the JAX package's (``yolo_scratch_tpu/ops/pallas_conv.py``), on the
CPU: ``bottleneck_plain``, and ``fused_bottleneck`` on a CPU tensor (which
runs the plain version), against ``bottleneck_xla`` and against the Pallas
kernel in interpret mode, as ``tests/test_pallas_conv.py`` runs it.

Tolerances are that file's:

* f32, rtol = atol = 1e-5: the same f32 sums, taken in other orders;
* bf16, rtol = atol = 0.05, and the first and last rows and columns on their
  own (conv2's zero pad of h is where a halo fault shows): h is rounded to
  bf16 once, and a sum in another order can round it to the neighbouring
  bf16 value;
* the folded module, rtol = atol = 2e-4: folding BN into the conv changes the
  rounding of every product.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from yolo_scratch_tpu.nn.modules import Bottleneck as FlaxBottleneck
from yolo_scratch_tpu.ops.pallas_conv import bottleneck_xla
from yolo_scratch_tpu.ops.pallas_conv import fused_bottleneck as jax_fused_bottleneck
from yolo_scratch_tpu_torch import probe_fused_bottleneck as probe
from yolo_scratch_tpu_torch.nn.fuse import bottleneck_weights, fuse_conv_bn
from yolo_scratch_tpu_torch.nn.modules import Bottleneck
from yolo_scratch_tpu_torch.ops.conv_kernels import (
    bottleneck_plain,
    fused_bottleneck,
    tf32_split,
    weights_core_matrices,
    weights_ohwi,
)
from yolo_scratch_tpu_torch.utils.weights import state_dict_from_jax


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs six workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(seed, B, H, W, C, Ch, dtype):
    """``test_pallas_conv._case``'s inputs as JAX arrays, and the same values
    as torch tensors (weights in x's type, biases f32)."""
    rng = np.random.RandomState(seed)
    x = jnp.asarray(rng.randn(B, H, W, C) * 0.5, dtype)
    w1 = jnp.asarray(rng.randn(3, 3, C, Ch) * (1.0 / np.sqrt(9 * C)), dtype)
    b1 = jnp.asarray(rng.randn(Ch) * 0.1, jnp.float32)
    w2 = jnp.asarray(rng.randn(3, 3, Ch, C) * (1.0 / np.sqrt(9 * Ch)), dtype)
    b2 = jnp.asarray(rng.randn(C) * 0.1, jnp.float32)
    jx = (x, w1, b1, w2, b2)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    tx = tuple(torch.from_numpy(np.asarray(a).astype(np.float32)).to(
        tdt if a.dtype == dtype else torch.float32) for a in jx)
    return jx, tx


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("shape", [(2, 16, 16, 128, 128), (1, 8, 24, 64, 64),
                                   (2, 12, 12, 128, 64),
                                   # widths off the multiples of 16, which the
                                   # Pallas kernel takes and the CUDA kernel's
                                   # wrapper pads with zero channels
                                   (2, 12, 12, 8, 24), (1, 9, 14, 24, 8)])
def test_bottleneck_matches_jax_f32(shape):
    jx, tx = _case(0, *shape, jnp.float32)
    ref = np.asarray(bottleneck_xla(*jx))
    pallas = np.asarray(jax_fused_bottleneck(*jx))
    for got in (bottleneck_plain(*tx), fused_bottleneck(*tx)):
        np.testing.assert_allclose(_np(got), ref, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(_np(got), pallas, rtol=1e-5, atol=1e-5)


def test_bottleneck_matches_jax_bf16():
    jx, tx = _case(1, 2, 16, 16, 128, 128, jnp.bfloat16)
    ref = np.asarray(bottleneck_xla(*jx)).astype(np.float32)
    pallas = np.asarray(jax_fused_bottleneck(*jx)).astype(np.float32)
    got = fused_bottleneck(*tx)
    assert got.dtype == torch.bfloat16
    got = _np(got)
    for want in (ref, pallas):
        np.testing.assert_allclose(got, want, rtol=0.05, atol=0.05)
        for ends in ((slice(None), [0, -1]), (slice(None), slice(None), [0, -1])):
            np.testing.assert_allclose(got[ends], want[ends], rtol=0.05, atol=0.05)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("C,Ch", [(8, 24), (24, 8), (40, 20)])
def test_zero_channel_padding_keeps_the_output(dtype, C, Ch):
    """The CUDA wrapper's padding (``_pad_channels``) to multiples of 16: the
    padded bottleneck's first C channels equal the unpadded one's, within
    the file's tolerance for the dtype (the padded convs may sum in another
    order), and its padded channels are zero."""
    from yolo_scratch_tpu_torch.ops.conv_kernels import _pad_channels

    _, tx = _case(2, 2, 10, 11, C, Ch, dtype)
    padded = _pad_channels(*tx)
    assert padded[0].shape[-1] % 16 == 0 and padded[1].shape[-1] % 16 == 0
    got, ref = bottleneck_plain(*padded), bottleneck_plain(*tx)
    tol = 1e-5 if dtype == jnp.float32 else 0.05
    np.testing.assert_allclose(_np(got[..., :C]), _np(ref), rtol=tol, atol=tol)
    assert not got[..., C:].any()


def _conv_taps(a, w_ohwi):
    """3x3 SAME conv of NHWC ``a`` as nine shifted matmuls over OHWI weights
    (N, 3, 3, K), the order the bf16 kernel reads them in."""
    H, W = a.shape[1:3]
    p = F.pad(a, (0, 0, 1, 1, 1, 1))
    return sum(p[:, dy:dy + H, dx:dx + W] @ w_ohwi[:, dy, dx].T
               for dy in range(3) for dx in range(3))


@pytest.mark.parametrize("C,Ch", [(32, 32), (16, 48)])
def test_weights_ohwi_taps_match_plain(C, Ch):
    """The bottleneck rebuilt from :func:`weights_ohwi`'s layout, tap by tap,
    equals ``bottleneck_plain`` in f32 (rtol = atol = 1e-5, sums in another
    order)."""
    _, (x, w1, b1, w2, b2) = _case(4, 2, 7, 9, C, Ch, jnp.float32)
    w1o, w2o = weights_ohwi(w1), weights_ohwi(w2)
    assert tuple(w1o.shape) == (Ch, 3, 3, C) and tuple(w2o.shape) == (C, 3, 3, Ch)
    assert w1o.is_contiguous() and torch.equal(w1o[5, 2, 1], w1[2, 1, :, 5])
    h = F.silu(_conv_taps(x, w1o) + b1)
    y = x + F.silu(_conv_taps(h, w2o) + b2)
    torch.testing.assert_close(y, bottleneck_plain(x, w1, b1, w2, b2), rtol=1e-5, atol=1e-5)


def _tf32_ref(w):
    """tf32(w) in float64, independent of the bit operations: |w| to the
    nearest multiple of tf32's spacing at w (2^(e - 11) for w = m 2^e, m in
    [0.5, 1); 2^-136 below f32's smallest normal), ties away from zero."""
    w = w.astype(np.float64)
    _, e = np.frexp(w)
    grid = np.exp2(np.maximum(e - 11, -136).astype(np.float64))
    return np.sign(w) * np.floor(np.abs(w) / grid + 0.5) * grid


def test_tf32_split_rounds_to_nearest_ties_away():
    """hi = tf32(w) and lo = tf32(w - hi) have their 13 low mantissa bits
    zero, round to nearest with ties away from zero (as ``cvt.rna``), and hi
    + lo is w within 2^-22 |w| (within half tf32's subnormal spacing, 2^-137,
    below f32's normals); zeros, negatives and subnormals included."""
    bits = np.array([0x3F801000, 0xBF801000, 0x3F800FFF, 0x3F803000,  # ties (+, -), below, odd tie
                     0x00001000, 0x80003000, 0x00000FFF, 0x00003456,  # subnormals
                     0x00000000, 0x80000000, 0x00800000, 0x7F7FEFFF],  # +-0, min normal, near max
                    np.uint32).view(np.float32)
    rng = np.random.RandomState(5)
    w = np.concatenate([bits, (rng.randn(4096) * np.exp2(rng.randint(-60, 60, 4096)))
                        .astype(np.float32)])
    hi, lo = tf32_split(torch.from_numpy(w))
    for part in (hi, lo):
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    np.testing.assert_array_equal(hi.numpy().astype(np.float64), _tf32_ref(w))
    np.testing.assert_array_equal(lo.numpy().astype(np.float64),
                                  _tf32_ref((w.astype(np.float64) - hi.numpy()).astype(np.float32)))
    assert hi[0] == np.float32(1 + 2.0 ** -10) and hi[1] == -hi[0]  # ties away from zero
    assert hi[2] == 1.0 and hi[4].view(torch.int32) == 0x2000 and hi[6] == 0
    assert torch.equal(hi[8:10].view(torch.int32), torch.tensor([0, -2 ** 31], dtype=torch.int32))
    err = np.abs(w.astype(np.float64) - hi.numpy() - lo.numpy())
    assert np.all(err <= np.maximum(2.0 ** -22 * np.abs(w.astype(np.float64)), 2.0 ** -137))
    with pytest.raises(TypeError):
        tf32_split(torch.from_numpy(w).double())


def _conv_tf32(a, w_ohwi, terms=("lo_hi", "hi_lo", "hi_hi")):
    """:func:`_conv_taps` with each product as the f32 kernel takes it: a and
    w split into tf32 hi + lo, and per tap the products ``terms`` of
    a_lo w_hi, a_hi w_lo, a_hi w_hi, summed in f32 (a product of two tf32
    values is exact in f32)."""
    (ah, al), (wh, wl) = tf32_split(a), tf32_split(w_ohwi)
    parts = {"lo_hi": (al, wh), "hi_lo": (ah, wl), "hi_hi": (ah, wh)}
    return sum(_conv_taps(*parts[k]) for k in terms)


def _bottleneck_tf32(x, w1, b1, w2, b2, terms=("lo_hi", "hi_lo", "hi_hi")):
    h = F.silu(_conv_tf32(x, weights_ohwi(w1), terms) + b1)
    return x + F.silu(_conv_tf32(h, weights_ohwi(w2), terms) + b2)


@pytest.mark.parametrize("shape", [(2, 16, 16, 128, 128), (1, 8, 24, 64, 64),
                                   (2, 12, 12, 128, 64), (1, 6, 7, 512, 512)])
def test_3xtf32_emulation_matches_plain_and_xla(shape):
    """The f32 kernel's arithmetic, emulated on the CPU (three tf32 products
    a tap, the correction terms first), within the f32 tolerance (rtol =
    atol = 1e-5) of ``bottleneck_plain`` and of JAX's ``bottleneck_xla``, at
    the JAX test's shapes and at C = 512: the error budget of 3xTF32 holds
    before any card runs it."""
    jx, tx = _case(0, *shape, jnp.float32)
    got = _np(_bottleneck_tf32(*tx))
    np.testing.assert_allclose(got, _np(bottleneck_plain(*tx)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(bottleneck_xla(*jx)), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("terms", [("hi_hi",), ("hi_lo", "hi_hi"), ("lo_hi", "hi_hi")],
                         ids=["one_pass", "no_a_lo", "no_w_lo"])
def test_tf32_without_both_corrections_misses_the_tolerance(terms):
    """One TF32 pass, or 3xTF32 with either correction term dropped, is
    off by ~1e-4 at C = 512: the f32 tolerance (1e-5) catches a kernel that
    skips part of the split."""
    _, tx = _case(0, 1, 6, 7, 512, 512, jnp.float32)
    err = (_bottleneck_tf32(*tx, terms=terms) - bottleneck_plain(*tx)).abs().max()
    assert float(err) > 5e-5


def test_weights_core_matrices_layout():
    """OHWI value (n, k') of column n's 9K run lands at [n // 8, k' // 4,
    n % 8, k' % 4]: wgmma's core matrices (8 columns x 4 values) in order,
    so 8 columns' run of K' is one contiguous block."""
    N, K = 24, 16
    wo = weights_ohwi(torch.randn(3, 3, K, N))
    cm = weights_core_matrices(wo)
    assert tuple(cm.shape) == (N // 8, 9 * K // 4, 8, 4) and cm.is_contiguous()
    flat = wo.reshape(N, 9 * K)
    assert torch.equal(cm.permute(0, 2, 1, 3).reshape(N, 9 * K), flat)
    assert cm[2, 35, 7, 3] == flat[23, 143] and cm[1, 4, 1, 2] == flat[9, 18]
    # columns 8-15, K' 16-31 (a 16 K' stage): 4 core matrices, one 512-byte run
    assert torch.equal(cm[1, 4:8].reshape(4, 8, 4), flat[8:16, 16:32].reshape(8, 4, 4).transpose(0, 1))


def _perturbed(variables, seed=0):
    """Non-trivial BN statistics, so that folding matters."""
    rng = np.random.RandomState(seed)

    def walk(tree, path=()):
        out = {}
        for k, v in tree.items():
            if hasattr(v, "items"):
                out[k] = walk(v, path + (k,))
                continue
            a = np.asarray(v, np.float32)
            if k in ("scale", "var"):
                a = rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
            elif k == "mean" or (k == "bias" and "bn" in path):
                a = rng.normal(0.0, 0.1, a.shape).astype(np.float32)
            out[k] = a
        return out

    return {k: walk(v) for k, v in variables.items()}


def test_fused_bottleneck_matches_folded_flax_module():
    """End to end: flax Bottleneck (shortcut, k=3, e=1) with BN statistics,
    carried to the port's module, folded, put through ``bottleneck_weights``
    and ``fused_bottleneck``, equals flax ``apply``."""
    B, H, W, C = 2, 16, 16, 64
    fm = FlaxBottleneck(c2=C, shortcut=True, k=(3, 3), e=1.0)
    x = np.random.RandomState(3).rand(B, H, W, C).astype(np.float32)
    v = _perturbed(jax.device_get(fm.init(jax.random.PRNGKey(0), jnp.asarray(x), False)))
    ref = np.asarray(fm.apply(v, jnp.asarray(x), False))

    m = Bottleneck(C, C, shortcut=True, k=(3, 3), e=1.0)
    m.load_state_dict(state_dict_from_jax(v))
    folded = fuse_conv_bn(m.eval())
    got = fused_bottleneck(torch.from_numpy(x), *bottleneck_weights(folded))
    np.testing.assert_allclose(_np(got), ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("make", [
    lambda: Bottleneck(16, 16, shortcut=True, e=1.0),  # BN not folded
    lambda: fuse_conv_bn(Bottleneck(16, 16, shortcut=False, e=1.0)),
    lambda: fuse_conv_bn(Bottleneck(16, 32, shortcut=True, e=1.0)),  # c1 != c2: no residual
    lambda: fuse_conv_bn(Bottleneck(16, 16, shortcut=True, k=(1, 3), e=1.0)),
], ids=["unfolded", "no_shortcut", "widening", "1x1"])
def test_bottleneck_weights_rejects(make):
    with pytest.raises(ValueError):
        bottleneck_weights(make())


def test_bottleneck_weights_layout():
    """HWIO weights and f32 biases of a folded block: fused_bottleneck on them
    equals the block's own forward (NCHW)."""
    torch.manual_seed(0)
    m = fuse_conv_bn(Bottleneck(32, 32, shortcut=True, k=(3, 3), e=0.5).eval())
    w1, b1, w2, b2 = bottleneck_weights(m)
    assert tuple(w1.shape) == (3, 3, 32, 16) and tuple(w2.shape) == (3, 3, 16, 32)
    assert b1.dtype == b2.dtype == torch.float32
    x = torch.rand(2, 32, 9, 11)
    with torch.no_grad():
        ref = m(x).permute(0, 2, 3, 1)
    got = fused_bottleneck(x.permute(0, 2, 3, 1).contiguous(), w1, b1, w2, b2)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


def test_fused_bottleneck_rejects_bad_shapes_and_devices():
    x = torch.zeros(1, 4, 4, 16)
    w1, w2 = torch.zeros(3, 3, 16, 32), torch.zeros(3, 3, 32, 16)
    b1, b2 = torch.zeros(32), torch.zeros(16)
    with pytest.raises(ValueError):
        fused_bottleneck(x, w2, b1, w2, b2)  # w1 has the wrong shape
    with pytest.raises(ValueError):
        fused_bottleneck(x[0], w1, b1, w2, b2)
    meta = [t.to("meta") for t in (x, w1, b1, w2, b2)]
    with pytest.raises(ValueError, match="no kernel"):
        fused_bottleneck(*meta)


def test_probe_yardstick_and_bound():
    """The probe's folded module computes the kernel's function, and its bound
    is the larger of operations and bytes."""
    (case,) = probe.run_cases(2, torch.float32, "cpu", shapes=[("t", 6, 32, 16)])
    assert case.err <= 1e-5 and case.border_err() <= 1e-5
    x, w1, b1, w2, b2 = case.inputs
    with torch.no_grad():
        yard = probe.folded_module(w1, b1, w2, b2)(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    torch.testing.assert_close(yard, case.ref, rtol=1e-5, atol=1e-5)

    ms, by = probe.bound_ms(32, 80, 80, 128, 128, torch.bfloat16)
    flops = 2 * 32 * 80 * 80 * 9 * 2 * 128 * 128
    assert by == "operations" and ms == pytest.approx(flops / 989e12 * 1e3)
    ms, by = probe.bound_ms(32, 160, 160, 16, 16, torch.bfloat16)
    assert by == "bytes"
    assert ms == pytest.approx((2 * 32 * 160 * 160 * 16 * 2 + 2 * 9 * 16 * 16 * 2 + 4 * 32)
                               / 3.35e12 * 1e3)


def test_probe_f32_bound_takes_the_3xtf32_route():
    """The f32 kernel's bound is its route's: three TF32 products an f32 one
    over 495 TFLOP/s, 0.732 ms at B=32 on both probe rows (80^2 x 128, 20^2 x
    512: the same operations); the CUDA cores' 1.803 ms is logged beside it."""
    flops = 2 * 32 * 80 * 80 * 9 * 2 * 128 * 128
    for H, C in ((80, 128), (20, 512)):
        ms, by = probe.bound_ms(32, H, H, C, C, torch.float32)
        assert by == "operations" and ms == pytest.approx(3 * flops / 495e12 * 1e3)
        assert ms == pytest.approx(0.7321, abs=1e-4)
        assert probe.cuda_core_bound_ms(32, H, H, C, C) == pytest.approx(1.8030, abs=1e-4)


def test_probe_check_holds_small_maps():
    """``Case.check`` scales its atol by max|plain| below 1: on a map of
    values near 1e-3, zeros and x itself (a skipped branch) fail it, and an
    output 1% off everywhere passes."""
    (case,) = probe.run_cases(2, torch.bfloat16, "cpu", shapes=[("t", 6, 32, 32)])
    x, w1, b1, w2, b2 = case.inputs
    inputs = (x * 1e-3, w1, b1 * 1e-3, w2, b2 * 1e-3)
    ref = bottleneck_plain(*inputs)
    assert float(ref.float().abs().max()) < 0.05  # a flat atol of 0.05 would hold nothing
    small = probe.Case("small", inputs, ref, ref)
    assert small.atol < 1e-3
    small.check()
    assert small.passes((ref.float() * 1.01).bfloat16())
    assert not small.passes(torch.zeros_like(ref)) and not small.passes(inputs[0])
    with pytest.raises(AssertionError, match="differs"):
        probe.Case("small", inputs, torch.zeros_like(ref), ref).check()
