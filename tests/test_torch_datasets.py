"""Port crater and COCO readers (``yolo_scratch_tpu_torch/data/{crater,coco}.py``)
and ``train/cli.py::make_datasets`` against the JAX package's, on trees
written with cv2 (``tests/test_crater_dataset.py``'s and
``tests/test_coco_dataset.py``'s fixtures). Every sample is exactly equal:
images, boxes and labels, stretch and letterbox; so are the loader batches
built on them.
"""

from argparse import Namespace

import numpy as np
import pytest
import torch

from tests.test_coco_dataset import coco_root  # noqa: F401 (fixture)
from tests.test_crater_dataset import crater_root  # noqa: F401 (fixture)
from yolo_scratch_tpu.data.coco import CocoDataset as JCoco
from yolo_scratch_tpu.data.crater import CraterDataset as JCrater
from yolo_scratch_tpu.data.loader import Loader as JLoader
from yolo_scratch_tpu.train import cli as jcli
from yolo_scratch_tpu_torch.data import native
from yolo_scratch_tpu_torch.data.coco import CocoDataset
from yolo_scratch_tpu_torch.data.crater import CraterDataset
from yolo_scratch_tpu_torch.data.loader import Loader
from yolo_scratch_tpu_torch.train import cli as tcli


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs six workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_samples_equal(got_ds, ref_ds):
    assert len(got_ds) == len(ref_ds) > 0
    for i in range(len(ref_ds)):
        for g, r in zip(got_ds[i], ref_ds[i]):
            assert g.dtype == r.dtype and g.shape == r.shape
            np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("img_size", [64, 100])
def test_crater_samples_equal_jax(crater_root, img_size):  # noqa: F811
    got = CraterDataset(str(crater_root), img_size=img_size)
    ref = JCrater(str(crater_root), img_size=img_size)
    assert got.samples == ref.samples
    assert_samples_equal(got, ref)
    assert_samples_equal(got, ref)  # the second pass reads the LRU cache


def test_crater_cache_is_bounded(crater_root):  # noqa: F811
    ds = CraterDataset(str(crater_root), img_size=64, cache_size=2)
    for i in range(len(ds)):
        ds[i]
    assert len(ds._cache) == 2 and list(ds._cache) == [len(ds) - 2, len(ds) - 1]


def test_crater_reader_without_the_native_library(crater_root, monkeypatch):  # noqa: F811
    """Where the host library does not build (the card's machine has no
    libpng/libjpeg), the reader decodes through cv2, as the JAX one does."""
    monkeypatch.setattr(native, "available", lambda: False)
    ref = JCrater(str(crater_root), img_size=64)
    assert_samples_equal(CraterDataset(str(crater_root), img_size=64), ref)


@pytest.mark.parametrize("letterbox", [False, True])
def test_coco_samples_equal_jax(coco_root, letterbox):  # noqa: F811
    kw = dict(img_size=64, letterbox=letterbox)
    got = CocoDataset(str(coco_root / "instances.json"), str(coco_root / "images"), **kw)
    ref = JCoco(str(coco_root / "instances.json"), str(coco_root / "images"), **kw)
    assert (got.cat_to_contig, got.class_names) == (ref.cat_to_contig, ref.class_names)
    assert got.samples == ref.samples
    assert_samples_equal(got, ref)


@pytest.mark.parametrize("kind", ["crater", "coco"])
def test_make_datasets_and_batches_equal_jax(crater_root, coco_root, kind):  # noqa: F811
    root = crater_root if kind == "crater" else coco_root
    args = Namespace(data=str(root), dataset="auto", imgsz=64)
    got, ch, nc = tcli.make_datasets(args)
    ref, ch_r, nc_r = jcli.make_datasets(args)
    assert (type(got).__name__, ch, nc) == (type(ref).__name__, ch_r, nc_r)
    assert (ch, nc) == ((1, 5) if kind == "crater" else (3, 3))
    for g, r in zip(Loader(got, 4, max_gt=8, prefetch=0), JLoader(ref, 4, max_gt=8, prefetch=0)):
        assert sorted(g) == sorted(r)
        for k in r:
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)


def test_make_datasets_without_annotations_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="no COCO annotations"):
        tcli.make_datasets(Namespace(data=str(tmp_path), dataset="auto", imgsz=64))


@pytest.mark.parametrize("n,B,shuffle", [(6, 4, True), (10, 8, False), (6, 16, False),
                                         (3, 16, True)])
def test_loader_pads_a_short_split_by_cycling(n, B, shuffle):
    """The final short batch is wrap-padded with the epoch's first indices,
    flagged invalid. Where the padding is no longer than the split, the
    batches equal the JAX loader's; where it is (a 6-image val split at
    B=16, as 32 images and ``--val-split 0.2`` give), the port cycles
    through the split again and the JAX loader raises a ``ValueError``."""
    from yolo_scratch_tpu.data.synthetic import SyntheticDataset as JSynthetic
    from yolo_scratch_tpu_torch.data.synthetic import SyntheticDataset

    idx = np.arange(n)
    got = list(Loader(SyntheticDataset(n=n, img_size=32), B, shuffle=shuffle, indices=idx,
                      prefetch=0))
    order, _ = Loader(SyntheticDataset(n=n, img_size=32), B, shuffle=shuffle,
                      indices=idx)._epoch_indices()
    assert len(got) == -(-n // B)
    assert sum(int(b["sample_valid"].sum()) for b in got) == n
    np.testing.assert_array_equal(order[n:], np.resize(order[:n], len(order) - n))
    ref_loader = JLoader(JSynthetic(n=n, img_size=32), B, shuffle=shuffle, indices=idx,
                         prefetch=0)
    if (-n) % B > n:
        with pytest.raises(ValueError):
            list(ref_loader)
        return
    for g, r in zip(got, ref_loader, strict=True):
        for k in r:
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)
