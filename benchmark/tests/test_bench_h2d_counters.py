"""The readers of the program's H2D counters (``h2d.staged``,
``h2d.slot_waits``): each gives its share of the window's batches, and
nothing where the program keeps no such counter (a program that copies
from pageable memory, as an older one)."""

import pytest

from benchmark.spec import Spec, reader

DEPLOY_CELLS = {"yolo11n-crater.deploy-b128", "yolox-s-coco.deploy-b32",
                "yolo11n-crater.exact-b128"}


@pytest.mark.parametrize("counts,staged_pct,wait_pct", [
    ({}, None, None),
    ({"nms.pairs_swept": 10}, None, None),
    ({"h2d.staged": 40}, 100.0, 0.0),
    ({"h2d.staged": 30, "h2d.slot_waits": 3}, 75.0, 10.0),
], ids=["none", "older_program", "every_batch", "some_waited"])
def test_h2d_counter_readers(monkeypatch, counts, staged_pct, wait_pct):
    from yolo_scratch_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "counters", lambda: counts)
    rec = {"batches": 40}
    for name, want in (("h2d_staged_pct.deploy", staged_pct),
                       ("h2d_slot_wait_pct.deploy", wait_pct)):
        got = reader(name).read(rec)
        assert got == (None if want is None else pytest.approx(want))


def test_h2d_counter_readers_are_listed_in_the_deploy_cells():
    by_name = {m["name"]: m for m in Spec().doc["per_layer"]}
    for name in ("h2d_staged_pct.deploy", "h2d_slot_wait_pct.deploy"):
        m = by_name[name]
        assert set(m["workloads"]) == DEPLOY_CELLS and m["moves"] == "img_per_s"
        assert m["source"] == "program_counter" and m["layer"] == "H2D + normalize"
