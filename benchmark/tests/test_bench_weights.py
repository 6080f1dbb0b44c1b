"""Seeded weights: the two benchmarked configurations' weights are those the
harness drew before every leaf kind had a rule, bit for bit; every float
leaf of a new kind is drawn; a leaf no rule draws makes ``make_weights``
raise and name it."""

import hashlib
import types

import pytest
import torch
from torch import nn

from benchmark import reference
from benchmark.reference import nets
from benchmark.spec import Spec
from benchmark.weights import make_weights, seeded_

CELLS = {"yolo11n-crater": "deploy-b128", "yolox-s-coco": "deploy-b32"}

#: sha256 of the ``state_dict`` (keys sorted; each key, dtype and bytes) as
#: ``seeded_`` leaves it and as ``make_weights`` returns it at the cell's own
#: traffic, taken with one CPU thread on x86-64 before the leaves of other
#: kinds had rules. The calibrated statistics are CPU sums: another thread
#: count, or a CPU with other vector units, may round them otherwise.
DIGESTS = {
    ("yolo11n-crater", 2**31 + 9): (
        "38a83a69d5826d04ef737b03902f83aaa054efb1c320c71eb4755cf5b39894f8",
        "d2b410a663131fea4c228c3dcf954277d19280afee064da367241510dd99f4d2"),
    ("yolo11n-crater", 3_000_000_019): (
        "fa5c05e0da4601465790598109197bcbda123b6771e27e090e62fd9127df14b2",
        "cc38388c7f61af013b4bd10d57f8cde96f30ad9c0992d3257359ebc91ba15c28"),
    ("yolox-s-coco", 2**31 + 9): (
        "eab53d8cb92bf819725afadf485f97b0f6376e01bdd32438d10e50da229b95be",
        "20f47a7610c25591ad1b507a088cc655d77711f66bcfc9a2ac63707ccffa90f7"),
    ("yolox-s-coco", 3_000_000_019): (
        "dc35dd86e252ee7cdea314a080baf10972846cf017dd24ccdb0a21670a6604e0",
        "48b71ecd720b3f84c82464661afee32f70bcd3919678b84f930545e07d9d3ce2"),
}


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def digest(sd):
    h = hashlib.sha256()
    for k in sorted(sd):
        t = sd[k].detach().cpu().contiguous()
        h.update(k.encode())
        h.update(str(t.dtype).encode())
        h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("config,seed", sorted(DIGESTS))
def test_weights_are_the_earlier_draws(config, seed, one_thread):
    spec = Spec()
    cfg = spec.config(config)
    seeded, weights = DIGESTS[config, seed]
    model = nets.build(cfg)
    for v in model.state_dict().values():  # as make_weights starts
        if v.is_floating_point():
            v.fill_(float("nan"))
    assert digest(seeded_(model, seed).state_dict()) == seeded
    assert digest(make_weights(cfg, spec.traffic(CELLS[config]), seed, "cpu")) == weights


class Leaves(nn.Module):
    """One of each kind of leaf a new family may bring, and a persistent
    float buffer, which no default rule draws."""

    def __init__(self):
        super().__init__()
        self.conv = nets.Conv(1, 8, 3, 2)
        self.norm = nn.LayerNorm(8)
        self.lin = nn.Linear(8, 8)
        self.mha = nn.MultiheadAttention(8, 2)
        self.gamma = nn.Parameter(torch.empty(8))
        self.scale = nn.Parameter(torch.empty(()))
        self.register_buffer("table", torch.empty(4))

    def forward(self, x):
        t = self.norm(self.conv(x.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2))
        t = t.transpose(0, 1)
        return [self.lin(t + self.gamma * self.mha(t, t, t)[0]) * self.scale + self.table.sum()]


def _small(monkeypatch, seed_leaves=None):
    fam = types.SimpleNamespace(build=lambda cfg: Leaves())
    if seed_leaves is not None:
        fam.seed_leaves_ = seed_leaves
    monkeypatch.setattr(reference, "family", lambda cfg: fam)
    cfg = Spec().config("yolo11n-crater")
    traffic = dict(Spec().traffic("deploy-b128"), img_size=32)
    return cfg, traffic


def test_a_leaf_no_rule_draws_is_named(monkeypatch):
    cfg, traffic = _small(monkeypatch)
    with pytest.raises(ValueError, match=r"\['table'\]"):
        make_weights(cfg, traffic, 5, "cpu")


def test_every_leaf_kind_is_drawn(monkeypatch):
    def seed_leaves_(model, gen):
        model.table.uniform_(generator=gen)

    cfg, traffic = _small(monkeypatch, seed_leaves_)
    w = make_weights(cfg, traffic, 5, "cpu")
    assert all(not torch.isnan(v).any() for v in w.values() if v.is_floating_point())
    assert torch.equal(w["table"], make_weights(cfg, traffic, 5, "cpu")["table"])
    assert not torch.equal(w["lin.weight"], make_weights(cfg, traffic, 6, "cpu")["lin.weight"])
    # the rules: norm scales near 1, shifts and 1-D leaves near 0, a 2-D
    # weight at std 1 / sqrt(fan_in)
    assert (w["norm.weight"] - 1).abs().max() < 0.5 and w["norm.bias"].abs().max() < 0.25
    assert w["gamma"].abs().max() < 0.5 and w["mha.in_proj_bias"].abs().max() < 0.5
    assert 0.5 < float(w["mha.in_proj_weight"].std() * 8 ** 0.5) < 1.5
