"""``yolo_scratch_tpu_torch/entry.py`` against ``__graft_entry__.py``'s
``entry()`` on the CPU.

``fn(x) = model.decode(model(x))`` of the seeded YOLO11n, held to the JAX
package's ``model.decode(model.apply(...))`` on the same weights (carried
over by ``convert_reference_state_dict``) at 64 px, within the f32 raw-map
tolerance of ``tests/test_torch_model.py``, ``atol = 1e-4 * max|ref|``,
applied to the boxes and to the scores each on their own. The JAX module is
built here as ``__graft_entry__._build`` builds it: importing
``__graft_entry__`` would set a compile cache in the repository and rewrite
``XLA_FLAGS``.
"""

import numpy as np
import pytest
import torch

import jax

from yolo_scratch_tpu.models.builder import build_yolo11 as jax_build
from yolo_scratch_tpu.utils.torch_import import convert_reference_state_dict
from yolo_scratch_tpu_torch import entry
from yolo_scratch_tpu_torch.models.builder import CONFIGS
from yolo_scratch_tpu_torch.parallel import dryrun

JAX_CFG = str(CONFIGS.parent.parent / "yolo_scratch_tpu/configs/yolo11_crater.yaml")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs six workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_entry_fn_matches_jax_entry_at_64px():
    fn, (example,) = entry.entry(device="cpu")
    assert tuple(example.shape) == (1, 640, 640, 1) and example.dtype == torch.float32
    params, stats = convert_reference_state_dict(entry._build(device="cpu").state_dict())
    jm = jax_build(JAX_CFG, ch=1, nc=5, scale="n")
    x = np.random.RandomState(0).rand(2, 64, 64, 1).astype(np.float32)
    ref = np.asarray(jax.jit(lambda v, xx: jm.decode(jm.apply(v, xx, train=False)))(
        {"params": params, "batch_stats": stats}, x))
    got = fn(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, 84, 9)
    for part in (np.s_[..., :4], np.s_[..., 4:]):  # pixel boxes, sigmoid scores
        r = ref[part]
        np.testing.assert_allclose(got[part], r, rtol=0, atol=1e-4 * np.abs(r).max())


def test_entry_main_prints_the_jax_shape(capsys):
    assert tuple(entry.main(["--device", "cpu"])) == (1, 8400, 9)
    assert capsys.readouterr().out.strip() == "entry forward: (1, 8400, 9)"


def test_entry_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        entry.main([])


def test_dryrun_multichip_is_the_parallel_one():
    assert entry.dryrun_multichip is dryrun.dryrun_multichip
