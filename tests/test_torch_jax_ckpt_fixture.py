"""The committed fixture ``tests/fixtures/jax_ckpt/`` is what the JAX
package writes: :func:`tests.test_torch_jax_ckpt.generate_fixture` runs again
(in a subprocess, XLA on one thread) into a temporary directory. Every
leaf's path, dtype and shape (``digests.json``), the meta files and the
model config must come out the same, and every leaf's values must equal the
committed fixture's, both read by the port's reader, to a relative 1e-6 of
the leaf's largest magnitude: XLA's CPU code follows the host's CPU
features (FMA contraction, vector width), so the bits of two train steps
are the same only on a CPU of the same kind. The committed files' own
sha256 digests are checked exactly in ``tests/test_torch_jax_ckpt.py``.
orbax names its data files at random, so the files themselves are not
compared. ~70 s on one worker: two train steps of a crater YOLO11 compile
for each of the per-leaf and ``flat_opt`` states.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.test_torch_jax_ckpt import FIXTURE, FIXTURE_CFG, FORMS, REPO, leaf_items
from yolo_scratch_tpu_torch.train.jax_checkpoints import read_jax_npz, read_orbax


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs six workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_fixture_regenerates_to_the_same_digests(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    env.pop("XLA_FLAGS", None)  # the generator sets its own
    proc = subprocess.run([sys.executable, str(REPO / "tests" / "test_torch_jax_ckpt.py"),
                           str(tmp_path)], env=env, cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    def structure(d):
        return {form: {k: v if not isinstance(v, dict) or not v else
                       {"dtype": v["dtype"], "shape": v["shape"]} for k, v in leaves.items()}
                for form, leaves in d.items()}

    want = json.loads((FIXTURE / "digests.json").read_text())
    assert structure(json.loads((tmp_path / "digests.json").read_text())) == structure(want)
    assert (tmp_path / FIXTURE_CFG).read_text() == (FIXTURE / FIXTURE_CFG).read_text()
    for form in FORMS:
        assert (json.loads((tmp_path / form / "last.meta.json").read_text())
                == json.loads((FIXTURE / form / "last.meta.json").read_text()))
        read = read_jax_npz if form == "npz" else read_orbax
        name = "last.npz" if form == "npz" else "last"
        got = dict(leaf_items(read(tmp_path / form / name)))
        committed = dict(leaf_items(read(FIXTURE / form / name)))
        assert got.keys() == committed.keys(), form
        for path, w in committed.items():
            g = got[path]
            if not isinstance(w, np.ndarray):
                assert g == w, (form, path)
                continue
            assert (g.dtype, g.shape) == (w.dtype, w.shape), (form, path)
            if w.dtype.kind == "f":
                np.testing.assert_allclose(g, w, rtol=1e-6,
                                           atol=1e-6 * float(np.abs(w).max(initial=0.0)),
                                           err_msg=f"{form}: {path}")
            else:
                np.testing.assert_array_equal(g, w, err_msg=f"{form}: {path}")
