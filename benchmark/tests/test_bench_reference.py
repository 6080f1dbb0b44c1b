"""The plain reference against the port's plain path, at small sizes on the
CPU (this test may import the port; the reference may not)."""

import pytest
import torch

from benchmark import check
from benchmark.drivers.deploy import program_model
from benchmark.reference import nets, post
from benchmark.reference import train as ref_train
from benchmark.spec import Spec
from benchmark.traffic import scenes
from benchmark.weights import generator, make_weights

CELLS = {"yolo11n-crater": "deploy-b128", "yolox-s-coco": "deploy-b32"}


def setup(config, S=96, seed=2**31 + 9):
    spec = Spec()
    cfg = spec.config(config)
    traffic = dict(spec.traffic(CELLS[config]), img_size=S, pre_nms_topk=200, max_det=50)
    w = make_weights(cfg, traffic, seed, "cpu")
    ref = nets.build(cfg)
    ref.load_state_dict(w)
    prog = program_model(cfg, "cpu")
    prog.load_state_dict(w)
    x = scenes.draw(cfg, traffic, generator(seed, "cpu", "traffic"), 2, "cpu")[0]
    return cfg, traffic, ref, prog, x


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("config", sorted(CELLS))
def test_forward_matches_the_port(config):
    cfg, traffic, ref, prog, x = setup(config)
    ref.eval(), prog.eval()
    with torch.no_grad():
        r, p = ref(x), prog(x)
    assert float(check.feat_err(p, r).max()) < 1e-5


def _port_yolo11(cfg, prog, feats, common):
    from yolo_scratch_tpu_torch.ops.decode import postprocess_from_feats

    return postprocess_from_feats(feats, nc=cfg["nc"], strides=prog.strides, reg_max=16, **common)


def _port_yolox(cfg, prog, feats, common):
    from yolo_scratch_tpu_torch.models.yolox import yolox_eval_decode
    from yolo_scratch_tpu_torch.ops.decode import postprocess

    return postprocess(yolox_eval_decode([f.float() for f in feats], cfg["nc"], prog.strides),
                       **common)


#: the port's postprocess of each configuration's maps
PORT_POST = {"yolo11n-crater": _port_yolo11, "yolox-s-coco": _port_yolox}


@pytest.mark.parametrize("config", sorted(CELLS))
def test_postprocess_matches_the_port(config):
    from yolo_scratch_tpu_torch.host import pack_detections

    cfg, traffic, ref, prog, x = setup(config)
    prog.eval()
    with torch.no_grad():
        feats = [f.to(torch.bfloat16) for f in prog(x)]  # maps in the deploy dtype
    common = dict(img_size=traffic["img_size"], conf_threshold=traffic["conf"],
                  iou_threshold=traffic["iou"], max_det=traffic["max_det"],
                  pre_nms_topk=traffic["pre_nms_topk"], nms_impl="kernel")
    packed_p = pack_detections(*PORT_POST[config](cfg, prog, feats, common))
    packed_r, keep, valid = post.postprocess(cfg, [f.float() for f in feats], traffic)
    bad, rows = check.post_mismatch(packed_p, packed_r)
    assert rows > 20 and bad == 0
    assert int(keep.sum()) > 0 and bool(valid.all())
    # the control of this stage: the same plain postprocess in bf16 misses
    bf = post.postprocess(cfg, [f.float() for f in feats], traffic, torch.bfloat16)[0]
    cbad, crows = check.post_mismatch(bf, packed_r)
    assert cbad / crows > 0.5


def test_train_step_matches_the_port():
    from yolo_scratch_tpu_torch.losses.simota import YOLOXLossConfig, yolox_loss

    cfg, traffic, ref, prog, x = setup("yolox-s-coco", S=64)
    tr = dict(Spec().traffic("train-b16"), img_size=64, batch=2, pool=1)
    batch = {k: torch.as_tensor(v) for k, v in
             scenes.train_pool(cfg, tr, generator(3, "cpu", "traffic"), "cpu")[0].items()}
    ref.train(), prog.train()
    lr, _ = ref_train.yolox_loss(ref(batch["img"]), batch, cfg["nc"])
    lp, _ = yolox_loss(prog(batch["img"]), batch["gt_labels"], batch["gt_bboxes"],
                       batch["gt_mask"], YOLOXLossConfig(nc=cfg["nc"]))
    lr, lp = float(lr.detach()), float(lp.detach())
    assert abs(lr - lp) <= 1e-5 * abs(lr)
