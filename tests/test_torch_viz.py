"""The port's ``utils/viz.py`` and the infer CLI's ``--save-viz``/``--names``:
``tests/test_viz.py``'s cases on the port module, and every PNG it writes
byte-equal to the JAX ``save_annotated``'s on the same detections
(tolerance: exact bytes)."""

import json

import numpy as np
import pytest
import torch
from PIL import Image

from yolo_scratch_tpu.utils import viz as jviz
from yolo_scratch_tpu_torch import infer
from yolo_scratch_tpu_torch.models.builder import CONFIGS, build_yolo11
from yolo_scratch_tpu_torch.utils.viz import (
    class_color,
    draw_detections,
    load_class_names,
    save_annotated,
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs six workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_class_colors_distinct_and_deterministic():
    colors = [class_color(i) for i in range(80)]
    assert colors == [class_color(i) for i in range(80)] == [jviz.class_color(i)
                                                             for i in range(80)]
    assert len(set(colors)) == 80
    for c in colors:
        assert all(0 <= v <= 255 for v in c)


def test_draw_modifies_pixels_inside_box_only_roughly():
    img = Image.fromarray(np.full((120, 160, 3), 255, np.uint8))
    before = np.asarray(img).copy()
    arr = np.asarray(draw_detections(img, [[20, 30, 90, 100]], [0.87], [3]))
    assert (arr != before).any()
    assert (arr[110:, 140:] == 255).all()


def test_draw_from_path_grayscale_promoted(tmp_path):
    p = tmp_path / "g.png"
    Image.fromarray(np.zeros((64, 64), np.uint8)).save(p)
    assert draw_detections(str(p), [[5, 5, 40, 40]], [0.5], [1]).mode == "RGB"


def test_save_annotated_collision_and_min_score(tmp_path):
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    paths = [tmp_path / "a" / "x.png", tmp_path / "b" / "x.png"]
    for p in paths:
        Image.fromarray(np.zeros((32, 32, 3), np.uint8)).save(p)
    results = [{"path": str(p), "boxes": [[1, 1, 10, 10], [2, 2, 20, 20]],
                "scores": [0.9, 0.1], "labels": [0, 1]} for p in paths]
    written = save_annotated(results, str(tmp_path / "viz"), min_score=0.5)
    assert len(written) == len(set(written)) == 2
    for w in written:
        assert Image.open(w).size == (32, 32)


def test_load_class_names_formats(tmp_path):
    txt = tmp_path / "names.txt"
    txt.write_text("crater\nrock\n\nboulder\n")
    assert load_class_names(str(txt)) == ["crater", "rock", "boulder"]
    arr = tmp_path / "names.json"
    arr.write_text(json.dumps(["a", "b"]))
    assert load_class_names(str(arr)) == ["a", "b"]
    coco = tmp_path / "ann.json"
    coco.write_text(json.dumps({"categories": [{"id": 7, "name": "late"},
                                               {"id": 2, "name": "early"}]}))
    assert load_class_names(str(coco)) == ["early", "late"]
    assert load_class_names(None) is None
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"x": 1}))
    with pytest.raises(ValueError, match="unrecognized"):
        load_class_names(str(bad))


def _scene(tmp_path, seed=0):
    """Gray and RGB images of odd sizes, with seeded detections (some of
    them reaching past the borders and under ``min_score``)."""
    rng = np.random.RandomState(seed)
    results = []
    for i, (h, w, ch) in enumerate([(90, 130, 1), (120, 70, 3), (64, 64, 1)]):
        shape = (h, w) if ch == 1 else (h, w, 3)
        p = tmp_path / "in" / f"im{i}.png"
        p.parent.mkdir(exist_ok=True)
        Image.fromarray((rng.rand(*shape) * 255).astype(np.uint8)).save(p)
        n = 4 + i
        xy = rng.uniform(-10, max(h, w), (n, 2))
        wh = rng.uniform(5, 60, (n, 2))
        results.append({"path": str(p), "boxes": np.concatenate([xy, xy + wh], 1).tolist(),
                        "scores": rng.rand(n).tolist(),
                        "labels": rng.randint(0, 7, n).tolist()})
    return results


@pytest.mark.parametrize("names", [None, ["crater", "rock", "x"]], ids=["ids", "names"])
def test_pngs_byte_equal_to_jax(tmp_path, names):
    results = _scene(tmp_path)
    got = save_annotated(results, str(tmp_path / "port"), class_names=names, min_score=0.2)
    ref = jviz.save_annotated(results, str(tmp_path / "jax"), class_names=names,
                              min_score=0.2)
    assert [p.split("/")[-1] for p in got] == [p.split("/")[-1] for p in ref]
    for g, r in zip(got, ref):
        assert open(g, "rb").read() == open(r, "rb").read(), g


def test_infer_cli_save_viz_and_names(tmp_path, capsys):
    """``infer.main --save-viz DIR --names FILE`` writes one annotated PNG an
    image, byte-equal to the JAX ``save_annotated`` on the CLI's own
    results; ``--names`` alone warns, as the JAX CLI does."""
    rng = np.random.RandomState(1)
    imgs = tmp_path / "imgs"
    imgs.mkdir()
    for i, (h, w) in enumerate([(70, 90), (64, 64), (100, 60)]):
        Image.fromarray((rng.rand(h, w) * 255).astype(np.uint8)).save(imgs / f"i{i}.png")
    torch_weights = tmp_path / "w.pt"
    import torch

    torch.save(build_yolo11(CONFIGS / "yolo11_crater.json", ch=1, nc=5, scale="n",
                            seed=2).state_dict(), torch_weights)
    names = tmp_path / "names.txt"
    names.write_text("a\nb\nc\nd\ne\n")
    cli = ["--images", str(imgs), "--weights", str(torch_weights), "--imgsz", "64",
           "--batch", "2", "--conf", "0.0", "--device", "cpu", "--names", str(names)]
    results = infer.main(cli + ["--save-viz", str(tmp_path / "viz")])
    assert f"wrote 3 annotated images to {tmp_path / 'viz'}" in capsys.readouterr().out
    ref = jviz.save_annotated(results, str(tmp_path / "jax"),
                              class_names=jviz.load_class_names(str(names)))
    for r in ref:
        got = tmp_path / "viz" / r.split("/")[-1]
        assert got.read_bytes() == open(r, "rb").read()
    assert all(r["scores"] for r in results)
    infer.main(cli)
    assert "warning: --names only labels --save-viz renderings" in capsys.readouterr().out
