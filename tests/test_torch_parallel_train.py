"""The port's data-parallel Trainer and training CLI on the CPU over gloo
(the analogs of ``tests/test_multihost.py`` and
``test_remat_and_bn_mode.py::test_trainer_bn_mode_local``), the
``dryrun_multichip`` analog and ``process_slice``.

Ranks run in processes of their own (``spawn_ranks`` or, for
``--multihost``, one ``python`` a process), rendezvous through a
``file://`` under ``tmp_path`` and are joined within 90 s or killed.

Stated tolerances: what the ranks compute from all-reduced or gathered
values (losses, mAP) equal on every rank exactly. Validation through a
2-rank mesh against the one-process ``Trainer.validate`` on the same
weights and images: every metric within ``1e-5`` relative (the loss's
normalisers are summed in another order; the marks and detections, per
image, equal). ``--bn-mode local`` without a mesh trains exactly as sync
(it warns, as the JAX Trainer does).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tests import torch_parallel_ranks as R
from yolo_scratch_tpu_torch.parallel import distributed as D
from yolo_scratch_tpu_torch.parallel.dryrun import dryrun_multichip
from yolo_scratch_tpu_torch.parallel.mesh import Mesh
from yolo_scratch_tpu_torch.train import cli as tcli
from yolo_scratch_tpu_torch.train.checkpoints import CheckpointManager
from yolo_scratch_tpu_torch.train.trainer import Trainer

REPO = Path(__file__).resolve().parent.parent
CLI_FLAGS = ["--device", "cpu", "--data", "synthetic", "--scale", "n", "--imgsz", "64",
             "--batch", "4", "--workers", "0", "--val-conf", "0.01"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs six workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _metrics(history):
    """A fit's history without its timings."""
    return [{k: {m: v for m, v in h[k].items() if m not in ("imgs_per_sec", "epoch_time_s")}
             if isinstance(h[k], dict) else h[k] for k in h} for h in history]


@pytest.fixture(autouse=True)
def one_thread_per_rank(monkeypatch):
    """Spawned ranks inherit the environment: one intra-op thread each."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def test_process_slice_covers_dataset():
    a = D.process_slice(10, process_id=0, num_processes=2)
    b = D.process_slice(10, process_id=1, num_processes=2)
    assert sorted(np.concatenate([a, b]).tolist()) == list(range(10))
    assert abs(len(a) - len(b)) <= 1


def test_dryrun_multichip_replicas_agree():
    assert np.isfinite(dryrun_multichip(2, timeout=90))


@pytest.fixture(scope="module")
def val_items():
    return R.self_labelled_val(R.val_model())


@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory, val_items):
    d = tmp_path_factory.mktemp("parallel_trainer")
    return D.spawn_ranks(R.trainer_rank, 2, (2, f"file://{d}/rendezvous", val_items),
                         timeout=90)


@pytest.mark.parametrize("matching", [True, False])
def test_mesh_validation_gives_the_one_process_metrics(trainer_runs, val_items, matching):
    """Each rank evaluates its rows (kernel #1's plain sweep on the CPU);
    the gathered marks (or detections) give every rank the one-process
    metrics. The val GT holds some of the model's own detections, so that
    there are true positives at init."""
    train, val = R.trainer_loaders(val_items)
    ref = Trainer(R.val_model(), train, val,
                  R.trainer_config(device_matching=matching)).validate()
    got = [r[f"val_{matching}"] for r in trainer_runs]
    assert got[0] == got[1]
    assert sorted(got[0]) == sorted(ref) and ref["mAP50"] > 0
    for k, v in ref.items():
        np.testing.assert_allclose(got[0][k], v, rtol=1e-5, atol=1e-7, err_msg=k)


def test_trainer_bn_mode_local_on_a_mesh(trainer_runs):
    hist = [_metrics(r["fit_local"]) for r in trainer_runs]
    assert hist[0] == hist[1] and len(hist[0]) == 1
    assert np.isfinite(hist[0][0]["train"]["loss"]) and np.isfinite(hist[0][0]["val"]["mAP50"])


def test_multihost_feeding_augments_the_gathered_global_batch(trainer_runs):
    """Each process's own rows, gathered into the global batch before the
    augmentation, train exactly as every rank loading the global batch."""
    assert all(r["augmented"] for r in trainer_runs)


def test_bn_mode_local_without_a_mesh_warns_and_trains_as_sync(tmp_path):
    """The JAX Trainer's rule (``trainer.py:173-180``): the CLI trains; its
    run equals the sync run."""
    runs = {}
    for mode in ("sync", "local"):
        flags = CLI_FLAGS + ["--epochs", "1", "--bn-mode", mode, "--save-dir",
                             str(tmp_path / mode)]
        if mode == "local":
            with pytest.warns(UserWarning, match="no effect without a mesh"):
                runs[mode] = tcli.main(flags)
        else:
            runs[mode] = tcli.main(flags)
    assert _metrics(runs["local"]["history"]) == _metrics(runs["sync"]["history"])
    a = CheckpointManager(str(tmp_path / "sync")).load_raw("last")["model"]
    b = CheckpointManager(str(tmp_path / "local")).load_raw("last")["model"]
    assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("mode", ["sync", "local"])
def test_cli_mesh_trains_on_two_ranks(tmp_path, mode, capsys):
    """``--mesh 2 --device cpu``: two spawned ranks over gloo; rank 0
    alone prints and writes; every rank's history is the same."""
    out = tcli.main(CLI_FLAGS + ["--mesh", "2", "--epochs", "1", "--bn-mode", mode,
                                 "--save-dir", str(tmp_path)])
    first = capsys.readouterr().out.splitlines()[0]
    assert first == "mesh: 2 ranks over gloo, devices cpu cpu"
    ranks = out["ranks"]
    assert [r["rank"] for r in ranks] == [0, 1]
    hist = [_metrics(r["fit"]["history"]) for r in ranks]
    assert hist[0] == hist[1] == _metrics(out["history"])
    assert np.isfinite(out["history"][0]["train"]["loss"])
    assert len((tmp_path / "metrics.jsonl").read_text().splitlines()) == 1
    assert CheckpointManager(str(tmp_path)).load_raw("last")["step"] == 13  # 51 images / 4


def test_trainer_multihost_requires_device_matching():
    cpu = torch.device("cpu")
    mesh = Mesh((cpu, cpu), group=object(), process_local=True)
    train, val = R.trainer_loaders()
    with pytest.raises(ValueError, match="device_matching"):
        Trainer(R.build("yolo11")[0], train, val, R.trainer_config(device_matching=False),
                mesh=mesh)


_MULTIHOST = ("import json, sys; from yolo_scratch_tpu_torch.train import cli; "
              "r = cli.main(sys.argv[1:]); h = r['history']; "
              "print('RESULT ' + json.dumps({'loss': h[-1]['train']['loss'], "
              "'map': h[-1]['val']['mAP50'], 'start': h[0]['epoch'], 'ran': len(h)}))")


def _multihost(tmp_path, phase: int, epochs: int) -> list:
    """Two ``--multihost`` processes to the end; each one's RESULT."""
    rdv = tmp_path / f"rendezvous{phase}"
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, "-c", _MULTIHOST, *CLI_FLAGS, "--multihost", "--coordinator",
         f"file://{rdv}", "--nproc", "2", "--pid", str(pid), "--epochs", str(epochs),
         "--save-dir", str(tmp_path / "ckpt")],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=90)[0])
    finally:
        for p in procs:
            p.kill()
            p.wait()
    rows = []
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"process failed:\n{out[-3000:]}"
        rows.append(json.loads(out.split("RESULT ")[1]))
    return rows


def test_multihost_checkpoint_resume(tmp_path):
    """Kill and relaunch: two processes train epoch 0 on their slices with
    identical loss and all-gathered mAP, rank 0 alone writing; relaunched,
    both resume at epoch 1, run one epoch, and the loss goes down."""
    first = _multihost(tmp_path, 1, 1)
    assert first[0] == first[1], first
    assert first[0]["start"] == 0 and first[0]["ran"] == 1
    assert np.isfinite(first[0]["loss"]) and np.isfinite(first[0]["map"])
    assert len((tmp_path / "ckpt" / "metrics.jsonl").read_text().splitlines()) == 1
    second = _multihost(tmp_path, 2, 2)
    assert second[0] == second[1], second
    assert second[0]["start"] == 1 and second[0]["ran"] == 1
    assert np.isfinite(second[0]["loss"]) and second[0]["loss"] < first[0]["loss"]
    assert len((tmp_path / "ckpt" / "metrics.jsonl").read_text().splitlines()) == 2
