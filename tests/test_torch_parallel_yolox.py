"""YOLOX-nano through the port's data-parallel train step on 2 gloo ranks
on the CPU, against the JAX package's mesh steps on a 2-device virtual
mesh: the sync step against ``make_sharded_train_step`` (the shuffled batch
of 4 of ``test_torch_yolox_train.py``), the local step against
``make_ddp_train_step(sync_bn_stats=True)`` and ``(False)`` (a batch of 8),
from the seed-3 init, through ``yolox_loss_adapter``. Setup and the
stated tolerances: ``test_torch_parallel.py``.

Why the shuffled batch: on the unshuffled one the JAX package's own f32
sharded step puts ``cls_loss`` 1.9e-4 from the port's float64 step (its
one-device step 8e-5), over the ``rtol 1e-4`` stated for the loss terms;
the port's f32 lies 1e-5 from it.
"""

import pytest
import torch

from tests import torch_parallel_ranks as R
from tests.test_torch_parallel import (
    _batch,
    check_local_step,
    check_sync_step,
    local_scenarios,
    spawn_runs,
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs six workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    sd = R.build("yolox", seed=3)[0].state_dict()
    return spawn_runs(tmp_path_factory, {
        "yolox_sync": dict(family="yolox", state=sd, batch=_batch("yolox", 4, shuffle=True)),
        **local_scenarios("yolox", sd)})


def test_sync_step_matches_jax_sharded_step_yolox(runs):
    check_sync_step(runs, "yolox")


@pytest.mark.parametrize("sync_bn_stats", [True, False])
def test_local_step_matches_jax_ddp_step_yolox(runs, sync_bn_stats):
    check_local_step(runs, "yolox", sync_bn_stats)
