"""The train driver: ``TrainStep.__call__`` at the trainer's defaults.

Set-up makes seeded weights (``weights.py``) and loads them into the
configuration's model, draws a pool of distinct batches of images and boxes
into host memory (numpy, as the port's loader gives them), builds the
program's train step (``programs/<family>.py``'s ``train_step``; for YOLOX
the YOLOX loss, f32 with TF32 off, clip + AdamW + EMA, per-leaf state, as
``train/trainer.py`` builds it; a constant learning rate) and drives it
through its first three steps on three different batches. Those steps are
the warm-up; the state after the first and the third is kept for the check.
The same step object then runs the window.

The window calls the step on the next pool batch until ``--seconds`` have
passed, then syncs. ``train_img_per_s``: images over the window's wall time.
A traced run records a CUDA event at each of ``TrainStep.on_phase``'s marks
and runs under the profiler for at most ``trace_seconds``.

The check, after the window and with the program's state freed: the plain
reference (the family's ``trainer``; ``reference/train.py`` for YOLOX)
takes the same weights and the same three batches through three steps.
Each number is the worst over leaves of
``| |P| - |R| | / max(|R|, median leaf |R|)``:

* ``loss1_gap``: the first step's loss, ``|P - R| / |R|``. The later
  steps' losses are printed, not compared: there SimOTA's discrete
  assignment of anchors to boxes flips on round-off now and then (the
  foreground count differs by an anchor or two), and a flip moves the loss
  by up to 0.6% in sound runs, as much as TF32 does;
* ``grad_gap``: the first step's clipped gradient, read off the program's
  first moment (m = (1 - b1) g after one update);
* ``update_gap``: each parameter's change over the three steps;
* ``ema_gap``: each EMA leaf's change over the three steps.

Leaves whose reference gradient norm is under a thousandth of the median
leaf's move under AdamW by round-off alone and are left out of the last two.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List

import torch

from benchmark import reference
from benchmark.drivers.deploy import program_model
from benchmark.reference import nets
from benchmark.traffic import scenes
from benchmark.weights import generator, make_weights

STEPS_CHECKED = 3
PHASES = ("h2d", "forward", "loss", "backward", "clip_adamw_ema")


def build_step(model, cfg: Dict[str, Any], precision: str | None = "highest"):
    """(step, state) as the trainer builds them: ``programs/<family>.py``'s
    ``train_step``."""
    from benchmark import programs

    return programs.family(cfg).train_step(model, cfg, precision)


def _leaf_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keep: List[str]) -> float:
    """Worst leaf of ``| |P| - |R| | / max(|R|, median leaf |R|)``."""
    rn = {k: float(ref[k].double().norm()) for k in keep}
    med = float(torch.tensor(list(rn.values())).median())
    return max(abs(float(prog[k].double().norm()) - rn[k]) / max(rn[k], med, 1e-30)
               for k in keep)


class Train:
    def __init__(self, run, precision: str | None = "highest"):
        self.cfg, self.traffic = run.cfg, run.traffic
        dev = self.device = run.device
        self.weights = make_weights(self.cfg, self.traffic, run.seed, dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        model = program_model(self.cfg, dev)
        model.load_state_dict(self.weights)
        if int(self.traffic["pool"]) <= STEPS_CHECKED:
            raise ValueError(f"a train mix needs a pool of more than {STEPS_CHECKED} batches")
        self.pool = scenes.train_pool(self.cfg, self.traffic, generator(run.seed, dev, "traffic"),
                                      dev)
        self.step, self.state = run.make_step(model, self.cfg, precision)
        names = [n for n, _ in model.named_parameters()]
        self.names = names
        theta0 = [p.detach().clone() for p in model.parameters()]
        self.losses: List[float] = []
        self.num_fg: List[float] = []
        b1 = self.cfg["train"]["betas"][0]
        for i in range(STEPS_CHECKED):
            _, m = self.step(self.state, self.pool[i])
            self.losses.append(float(m["loss"]))
            self.num_fg.append(float(m["num_fg"]))
            if i == 0:
                self.g1 = {n: (t / (1.0 - b1)).detach().clone()
                           for n, t in zip(names, self.state.per_param(self.state.opt_state.mu))}
        params = list(model.parameters())
        self.delta = {n: (p.detach() - p0) for n, p, p0 in zip(names, params, theta0)}
        ema = self.state.ema
        self.ema_delta = {n: (ema[n] - p0) for n, p0 in zip(names, theta0)}
        self.next = STEPS_CHECKED

    def window(self, seconds: float, traced: bool) -> Dict[str, Any]:
        B = int(self.traffic["batch"])
        events: List[List] = []
        if traced:
            self.step.on_phase = lambda name: events[-1].append((name, _event()))
        steps = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            if traced:
                events.append([("start", _event())])
            self.step(self.state, self.pool[self.next % len(self.pool)])
            self.next += 1
            steps += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        window = time.perf_counter() - t0
        self.step.on_phase = None
        rec = {"window_s": window, "steps": steps, "images": steps * B, "attempted": steps * B}
        if traced:
            rec["phase_ms"] = _phase_ms(events)
        return rec

    def measure(self, seconds: float, traced: bool) -> Dict[str, Any]:
        if not traced:
            rec = self.window(seconds, False)
        else:
            from torch.profiler import record_function

            from benchmark.trace import traced as tracing

            with tracing() as tr:
                with record_function("bench.window"):
                    rec = self.window(min(seconds, float(self.traffic["trace_seconds"])), True)
            rec["trace"] = tr["trace"]
        if self.device.type == "cuda":
            rec["memory_peak_bytes"] = torch.cuda.max_memory_allocated(self.device)
        rec["e2e"] = {"train_img_per_s": rec["images"] / rec["window_s"]}
        rec["notes"] = [f"{rec['steps']} steps of {self.traffic['batch']} images in "
                        f"{rec['window_s']!r} s"]
        return rec

    def judge(self, rec: Dict[str, Any]) -> Dict[str, float]:
        """The check's numbers, from the state kept after set-up's steps."""
        self.step = self.state = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        ref = nets.build(self.cfg).to(self.device)
        ref.load_state_dict(self.weights)
        theta0 = {k: v.detach().clone() for k, v in ref.named_parameters()}
        trainer = reference.family(self.cfg).trainer(ref, self.cfg)
        losses, fgs, g1 = [], [], None
        with nets.full_f32():
            for i in range(STEPS_CHECKED):
                b = {k: torch.as_tensor(v).to(self.device) for k, v in self.pool[i].items()}
                loss, g, n_fg = trainer.step(b)
                losses.append(loss)
                fgs.append(n_fg)
                if i == 0:
                    g1 = {k: v.detach().clone() for k, v in g.items()}
        delta = {k: p.detach() - theta0[k] for k, p in ref.named_parameters()}
        ema_delta = {k: trainer.ema[k] - theta0[k] for k in theta0}
        gn = {k: float(g1[k].double().norm()) for k in g1}
        med = float(torch.tensor(list(gn.values())).median())
        moving = [k for k in self.names if gn[k] >= 1e-3 * med]
        rec["excluded_leaves"] = [k for k in self.names if k not in moving]
        rec["steps"] = {"loss": self.losses, "loss_ref": losses, "num_fg": self.num_fg,
                        "num_fg_ref": fgs}
        rec.setdefault("notes", []).append(
            "steps 1-3: loss " + " ".join(f"{p!r}/{r!r}" for p, r in zip(self.losses, losses))
            + "; foreground anchors an image " + " ".join(
                f"{p!r}/{r!r}" for p, r in zip(self.num_fg, fgs)) + " (program/reference)")
        rec["flops_per_image"] = _flops(ref, self.cfg, self.traffic, self.device)
        return {
            "loss1_gap": abs(self.losses[0] - losses[0]) / abs(losses[0]),
            "grad_gap": _leaf_gap(self.g1, g1, self.names),
            "update_gap": _leaf_gap(self.delta, delta, moving),
            "ema_gap": _leaf_gap(self.ema_delta, ema_delta, moving),
        }


def _event():
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e


def _phase_ms(events: List[List]) -> Dict[str, float]:
    """Mean ms a step of each phase, between consecutive marks."""
    torch.cuda.synchronize()
    tot = dict.fromkeys(PHASES, 0.0)
    n = 0
    for marks in events:
        names = [m[0] for m in marks]
        if names[1:] != list(PHASES):
            continue
        for (_, a), (name, b) in zip(marks, marks[1:]):
            tot[name] += a.elapsed_time(b)
        n += 1
    return {k: v / n for k, v in tot.items()} if n else {}


def _flops(ref, cfg, traffic, device) -> int:
    from benchmark import roofline

    S = int(traffic["img_size"])
    with nets.full_f32():
        return roofline.forward_flops(ref, torch.zeros((1, S, S, int(cfg["ch"])), device=device))


def run(run) -> Dict[str, Any]:
    t = Train(run)
    run.mark_setup()
    rec = t.measure(run.seconds, run.trace)
    rec["numbers"] = t.judge(rec)
    rec["failed"] = 0
    return rec
