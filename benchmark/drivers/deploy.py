"""The deploy driver: ``Predictor.predict_batch`` in a closed loop.

Set-up makes seeded weights on the card (``weights.py``), loads them into
the configuration's model,
draws a pool of distinct uint8 batches into pageable host memory, builds the
program's ``Predictor`` (BN folded, bf16) and runs every pool batch through
the loop once, which builds kernel #1 and warms every shape.

The window submits pool batches in turn, keeping ``inflight`` batches in
flight: a batch's packed (B, max_det, 7) output is fetched to the host when
the next submission would pass that depth. It stops submitting after
``--seconds``, once every pool batch that the check samples has been
submitted (a slow batch is late, not wrong; a 30 s window has long
submitted the whole pool), and ends when the last result is on the host.

* ``img_per_s``: images whose results reached the host over the window;
* ``batch_ms_p95``: the 95th percentile over every batch of the time from
  its submission to its results on the host.

A traced run calls the two halves of ``predict_batch``
(``forward_feats``, then ``postprocess_feats``: the same work) inside the
spans ``bench.forward`` and ``bench.postprocess``, for at most
``trace_seconds``.

The check (``check.py``) runs after the window, on ``check_batches`` pool
batches drawn from the seed: the program's maps, captured by a forward hook
on its model during the window, and its packed output.
"""

from __future__ import annotations

import collections
import time
from typing import Any, Dict, List

import numpy as np
import torch

from benchmark import check, roofline
from benchmark.reference import nets, post
from benchmark.traffic import scenes
from benchmark.weights import generator, make_weights


def program_model(cfg: Dict[str, Any], device):
    """The program's model of a configuration (``programs/<family>.py``),
    its leaves not yet set: ``make_weights``' ``state_dict`` fills them."""
    from benchmark import programs

    return programs.family(cfg).model(cfg, device)


def predictor_config(traffic: Dict[str, Any]):
    from yolo_scratch_tpu_torch.host import PredictorConfig

    return PredictorConfig(img_size=int(traffic["img_size"]), batch_size=int(traffic["batch"]),
                           conf_threshold=float(traffic["conf"]),
                           iou_threshold=float(traffic["iou"]), max_det=int(traffic["max_det"]),
                           pre_nms_topk=int(traffic["pre_nms_topk"]),
                           inflight=int(traffic["inflight"]))


class Deploy:
    """One run's state: the weights, the pool and the program."""

    def __init__(self, run):
        self.cfg, self.traffic = run.cfg, run.traffic
        dev = self.device = run.device
        self.weights = make_weights(self.cfg, self.traffic, run.seed, dev)
        if dev.type == "cuda":  # the reference's calibration pass is not the program's
            torch.cuda.reset_peak_memory_stats(dev)
        model = program_model(self.cfg, dev)
        model.load_state_dict(self.weights)
        self.pool = scenes.image_pool(self.cfg, self.traffic, generator(run.seed, dev, "traffic"),
                                      dev)
        g = torch.Generator().manual_seed(run.seed & ((1 << 63) - 1))
        n_check = min(int(self.traffic["check_batches"]), len(self.pool))
        self.check_ids = sorted(torch.randperm(len(self.pool), generator=g)[:n_check].tolist())
        self.pred = run.make_predictor(model, predictor_config(self.traffic), dev)
        del model
        self._feats: List[Any] = [None]
        self.pred.model.register_forward_hook(lambda m, i, o: self._feats.__setitem__(0, o))
        self.loop(len(self.pool) + int(self.traffic["inflight"]), traced=False)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def _call(self, x, traced: bool):
        if not traced:
            return self.pred.predict_batch(x)
        from torch.profiler import record_function

        with record_function("bench.forward"):
            feats = self.pred.forward_feats(x)
        with record_function("bench.postprocess"):
            return self.pred.postprocess_feats(feats)

    def loop(self, n_batches: int | None, traced: bool, seconds: float = 0.0) -> Dict[str, Any]:
        """``n_batches`` calls, or calls for ``seconds``; every result
        fetched. Returns the window's record."""
        B, depth = int(self.traffic["batch"]), max(1, int(self.traffic["inflight"]))
        pending: collections.deque = collections.deque()
        lat: List[float] = []
        call_s: List[float] = []
        captured: Dict[int, tuple] = {}
        done = submitted = 0
        t_start = time.perf_counter()
        t_stop = t_start + seconds

        def fetch():
            nonlocal done
            t_sub, out = pending.popleft()
            out.cpu().numpy()
            lat.append(time.perf_counter() - t_sub)
            done += B

        def open_():  # the window's seconds, and until each sampled batch was submitted once
            return time.perf_counter() < t_stop or len(captured) < len(self.check_ids)

        while (submitted < n_batches) if n_batches is not None else open_():
            j = submitted % len(self.pool)
            t_sub = time.perf_counter()
            out = self._call(self.pool[j], traced)
            call_s.append(time.perf_counter() - t_sub)
            if j in self.check_ids and j not in captured:
                captured[j] = (out, self._feats[0])
            pending.append((t_sub, out))
            submitted += 1
            if len(pending) >= depth:
                fetch()
        while pending:
            fetch()
        window = time.perf_counter() - t_start
        return {"window_s": window, "images": done, "batches": len(lat), "lat_s": lat,
                "call_s": call_s, "captured": captured, "attempted": submitted * B}

    def measure(self, seconds: float, traced: bool) -> Dict[str, Any]:
        if not traced:
            rec = self.loop(None, False, seconds)
        else:
            from torch.profiler import record_function

            from benchmark.trace import traced as tracing

            secs = min(seconds, float(self.traffic["trace_seconds"]))
            with tracing() as tr:
                with record_function("bench.window"):
                    rec = self.loop(None, True, secs)
            rec["trace"] = tr["trace"]
        if self.device.type == "cuda":
            rec["memory_peak_bytes"] = torch.cuda.max_memory_allocated(self.device)
        lat = np.asarray(rec["lat_s"]) * 1e3
        rec["e2e"] = {"img_per_s": rec["images"] / rec["window_s"],
                      "batch_ms_p95": float(np.percentile(lat, 95))}
        rec["notes"] = [f"batch_ms_p95 over {len(lat)} batches "
                        f"(median {float(np.median(lat))!r} ms)"]
        return rec

    def judge(self, rec: Dict[str, Any], control: bool = False) -> Dict[str, float]:
        """The check's numbers for the captured batches. ``control`` adds
        ``post_mismatch.bf16``: the plain postprocess computed in bf16, put
        in the program's place (the control of that stage)."""
        captured = rec.pop("captured")
        self.pred = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        ref = nets.build(self.cfg).to(self.device)
        ref.load_state_dict(self.weights)
        errs, bad, rows, cbad, crows, tests, imgs = [], 0, 0, 0, 0, 0, 0
        for j in self.check_ids:
            if j not in captured:
                return {"feat_err": float("inf"), "post_mismatch": float("inf")}
            out, feats = captured[j]
            x = torch.as_tensor(self.pool[j]).to(self.device)
            want = nets.feats_f32(ref, x)
            errs.append(check.feat_err(feats, want))
            if len(feats) != len(want) or feats[0].shape[0] != x.shape[0]:
                bad, rows = bad + 1, rows + 1
                continue
            with nets.full_f32():
                f32 = [f.float() for f in feats]
                packed, keep, valid = post.postprocess(self.cfg, f32, self.traffic)
                if control:
                    c = check.post_mismatch(
                        post.postprocess(self.cfg, f32, self.traffic, torch.bfloat16)[0], packed)
                    cbad, crows = cbad + c[0], crows + c[1]
            b, r = check.post_mismatch(out, packed)
            bad, rows = bad + b, rows + r
            tests += roofline.nms_tests(keep, valid)
            imgs += x.shape[0]
        rec["nms_tests_per_image"] = tests / max(imgs, 1)
        rec["nms_boxes_per_image"] = int(self.traffic["pre_nms_topk"])
        one = torch.zeros((1, int(self.traffic["img_size"]), int(self.traffic["img_size"]),
                           int(self.cfg["ch"])), device=self.device)
        with nets.full_f32():
            rec["flops_per_image"] = roofline.forward_flops(ref, one)
        out = {"feat_err": float(torch.cat(errs).max()), "post_mismatch": bad / max(rows, 1)}
        if control:
            out["post_mismatch.bf16"] = cbad / max(crows, 1)
        return out


def run(run) -> Dict[str, Any]:
    """Set-up, the window and the check of one run; ``run`` carries the
    configuration, the mix, the seed and the device (``benchmark/run.py``)."""
    d = Deploy(run)
    run.mark_setup()
    rec = d.measure(run.seconds, run.trace)
    rec["numbers"] = d.judge(rec)
    rec["failed"] = 0
    return rec
