"""The port's reader of the JAX package's checkpoints, from the bytes up:
the Zstandard decoder (``csrc/zstd_decode.cpp``, ``utils/zstd.py``), the
OCDBT store (``utils/ocdbt.py``), the zarr v2 arrays (``utils/zarr2.py``)
and the committed fixture ``tests/fixtures/jax_ckpt/``, on the CPU.

Everything here is exact: decoded bytes, keys, values, and each leaf's
dtype, shape and sha256.

* The decoder against ``zstandard`` (libzstd) on frames it writes:
  hypothesis over random and low-entropy payloads of 0 B to 1 MiB, levels
  1-19, with and without a checksum and a content size, back-to-back frames
  and a skippable frame; corrupt and truncated frames raise (that the
  built library needs no libzstd is ``tests/test_torch_imports.py``'s).
* The OCDBT store against tensorstore's own reader, on a database written
  with small nodes (interior B-tree nodes), small inline values (values in
  data files) and forty commits (versions past the manifest's inline ones).
* ``read_array`` against tensorstore's own zarr reader: edge chunks, a chunk
  that was never written (the fill value), a scalar, other dtypes.
* The fixture: the JAX package's ``CheckpointManager.save_epoch`` after two
  real train steps (EMA on, moments non-zero) of a narrow crater YOLO11,
  per-leaf orbax, ``flat_opt`` orbax and the npz fallback, with
  ``digests.json`` (each leaf's path, dtype, shape and sha256 as orbax
  restores it). The port reads every form to those digests
  (``tests/test_torch_jax_ckpt_fixture.py`` has :func:`generate_fixture`
  write them again from scratch).

Regenerate the fixture with ``python tests/test_torch_jax_ckpt.py
tests/fixtures/jax_ckpt`` (JAX, orbax and tensorstore needed; XLA on one
thread, so the train steps round the same way on any host of this kind).
"""

import hashlib
import json
import os
import shutil
import struct
import sys
from functools import partial
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import zstandard
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from yolo_scratch_tpu_torch.models.builder import CONFIGS
from yolo_scratch_tpu_torch.train.jax_checkpoints import (
    find_jax_checkpoint,
    read_jax_npz,
    read_orbax,
)
from yolo_scratch_tpu_torch.utils import zstd
from yolo_scratch_tpu_torch.utils.ocdbt import OcdbtError, OcdbtStore
from yolo_scratch_tpu_torch.utils.zarr2 import ZarrError, read_array

REPO = Path(__file__).resolve().parent.parent
FIXTURE = REPO / "tests" / "fixtures" / "jax_ckpt"
FIXTURE_CFG = "yolo11_crater_tiny.yaml"  # JSON text, which YAML reads as well
FIXTURE_SCALE = {"t": [0.33, 0.0078125, 1024]}  # every width at make_divisible's floor of 8
FIXTURE_EPOCH = 4
FORMS = ("leaf", "flat", "npz")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs six workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- trees

def normalise(tree):
    """orbax's restore (lists, namedtuples) as the port's nested dicts."""
    if isinstance(tree, dict):
        return {k: normalise(v) for k, v in tree.items()}
    if hasattr(tree, "_asdict"):
        d = tree._asdict()
        return {k: normalise(v) for k, v in d.items()} if d else None
    if isinstance(tree, (list, tuple)):
        return {i: normalise(v) for i, v in enumerate(tree)}
    return tree


def leaf_items(tree, path=()):
    """(path, leaf) pairs of a nested dict; ``None`` and ``{}`` are leaves."""
    if isinstance(tree, dict) and tree:
        for k, v in tree.items():
            yield from leaf_items(v, path + (k,))
    else:
        yield path, tree


def digests(tree):
    """{"a/b/c": {"dtype", "shape", "sha256"} | None | {}} of a tree."""
    out = {}
    for path, leaf in leaf_items(normalise(tree)):
        key = "/".join(map(str, path))
        if leaf is None or isinstance(leaf, dict):
            out[key] = leaf
        else:
            a = np.ascontiguousarray(np.asarray(leaf))
            out[key] = {"dtype": a.dtype.str, "shape": list(a.shape),
                        "sha256": hashlib.sha256(a.tobytes()).hexdigest()}
    return out


# ------------------------------------------------------------- zstd

def _payload(draw_bytes, kind, n, seed):
    r = np.random.RandomState(seed)
    if kind == "random":
        return r.bytes(n)
    if kind == "two_bits":
        return r.randint(0, 4, n).astype(np.uint8).tobytes()
    if kind == "floats":
        return r.randn(n // 4).astype(np.float32).tobytes()
    if kind == "words":
        words = [b"alpha", b"beta", b"gamma", b"\x00\x00\x00", b"zz", draw_bytes]
        return b"".join(words[i] for i in r.randint(0, len(words), n // 3 + 1))[:n]
    return r.zipf(1.3, n).clip(0, 255).astype(np.uint8).tobytes()  # skewed


@settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(kind=st.sampled_from(["random", "two_bits", "floats", "words", "zipf"]),
       n=st.one_of(st.integers(0, 300), st.integers(300, 140_000),
                   st.sampled_from([131_072, 1 << 20])),
       level=st.integers(1, 19), checksum=st.booleans(), content_size=st.booleans(),
       seed=st.integers(0, 2**31 - 1), extra=st.binary(max_size=12))
def test_zstd_matches_zstandard(kind, n, level, checksum, content_size, seed, extra):
    data = _payload(extra, kind, n, seed)
    c = zstandard.ZstdCompressor(level=level, write_checksum=checksum,
                                 write_content_size=content_size)
    assert zstd.decompress(c.compress(data)) == data
    # streamed: no content size in the header, the window descriptor instead
    cobj = c.compressobj()
    assert zstd.decompress(cobj.compress(data) + cobj.flush()) == data


def test_zstd_back_to_back_and_skippable_frames():
    r = np.random.RandomState(0)
    parts = [r.bytes(5000), b"", (b"abc" * 70_000), r.randn(30_000).astype(np.float32).tobytes()]
    frames = [zstandard.ZstdCompressor(level=i * 5 + 1, write_checksum=bool(i % 2)).compress(p)
              for i, p in enumerate(parts)]
    skippable = struct.pack("<II", 0x184D2A5B, 7) + b"skipped"
    got = zstd.decompress(frames[0] + skippable + frames[1] + frames[2] + skippable + frames[3])
    assert got == b"".join(parts)


def _corrupt(kind, frame):
    f = bytearray(frame)
    if kind == "magic":
        f[0] ^= 0xFF
    elif kind == "truncated":
        f = f[:len(f) * 2 // 3]
    elif kind == "checksum":
        f[-1] ^= 0x01
    elif kind == "reserved_block":
        f[6 + 8] |= 0x06  # header: magic, descriptor, window, 8-byte size; block type 3
    elif kind == "trailing":
        f += b"\x01\x02"
    elif kind == "dictionary":
        f[4] |= 0x01  # a one-byte dictionary id follows the descriptor
        f.insert(6, 7)
    return bytes(f)


@pytest.mark.parametrize("kind", ["magic", "truncated", "checksum", "reserved_block",
                                  "trailing", "dictionary", "empty"])
def test_zstd_corrupt_or_truncated_raises(kind):
    data = np.random.RandomState(1).randn(50_000).astype(np.float32).tobytes()
    frame = zstandard.ZstdCompressor(level=3, write_checksum=True,
                                     write_content_size=True).compress(data)
    bad = b"" if kind == "empty" else _corrupt(kind, frame)
    with pytest.raises(zstd.ZstdError):
        zstd.decompress(bad)


def test_zstd_flipped_bits_never_pass_unnoticed():
    """Every flip of one bit of a checksummed frame raises, whatever part of
    the frame it lands in, or leaves the output unchanged (padding bits)."""
    r = np.random.RandomState(2)
    data = r.randint(0, 16, 20_000).astype(np.uint8).tobytes()
    frame = zstandard.ZstdCompressor(level=9, write_checksum=True).compress(data)
    for i in r.choice(len(frame) * 8, 400, replace=False):
        f = bytearray(frame)
        f[i // 8] ^= 1 << (i % 8)
        try:
            assert zstd.decompress(bytes(f)) == data, i
        except zstd.ZstdError:
            pass


# ------------------------------------------------------------- OCDBT

@pytest.fixture(scope="module")
def small_node_db(tmp_path_factory):
    import tensorstore as ts

    root = tmp_path_factory.mktemp("ocdbt")
    spec = {"driver": "ocdbt", "base": f"file://{root}",
            "config": {"max_decoded_node_bytes": 600, "max_inline_value_bytes": 32}}
    kv = ts.KvStore.open(spec).result()
    r = np.random.RandomState(0)
    for g in range(40):
        with ts.Transaction() as txn:
            for i in range(30):
                kv.with_transaction(txn).write(f"prefix/common/g{g:03d}/key{i:04d}",
                                               r.bytes(r.randint(0, 100))).result()
    kv.delete_range(ts.KvStore.KeyRange("prefix/common/g005/", "prefix/common/g006/")).result()
    kv.write("prefix/common/g001/key0001", b"overwritten").result()
    return root, kv


def test_ocdbt_matches_tensorstore(small_node_db):
    root, kv = small_node_db
    want = {k.decode(): kv.read(k).result().value for k in kv.list().result()}
    with OcdbtStore(root) as store:
        assert store.list() == sorted(want)
        assert {k: store.get(k) for k in store.list()} == want
        assert store.list("prefix/common/g03") == sorted(k for k in want
                                                          if k.startswith("prefix/common/g03"))
        assert "prefix/common/g005/key0000" not in store
    # the database's nodes are small: a root of height > 0, values in data files
    manifest = (root / "manifest.ocdbt").read_bytes()
    assert len(list((root / "d").iterdir())) > 10 and len(manifest) < 1000


def test_ocdbt_corrupt_node_names_the_file(small_node_db, tmp_path):
    root, _ = small_node_db
    bad = tmp_path / "db"
    shutil.copytree(root, bad)
    m = bytearray((bad / "manifest.ocdbt").read_bytes())
    m[20] ^= 1
    (bad / "manifest.ocdbt").write_bytes(bytes(m))
    with pytest.raises(OcdbtError, match="manifest.ocdbt: CRC-32C mismatch"):
        OcdbtStore(bad)
    shutil.rmtree(bad)
    shutil.copytree(root, bad)
    for f in (bad / "d").iterdir():  # the root node's file among them
        f.write_bytes(b"")
    with pytest.raises(OcdbtError, match=r"d/[0-9a-f]+: \d+ bytes at \d+ wanted, 0 read"):
        OcdbtStore(bad)


def test_zarr_arrays_match_tensorstore(tmp_path):
    import tensorstore as ts

    kv = {"driver": "ocdbt", "base": f"file://{tmp_path}"}
    r = np.random.RandomState(3)
    cases = {
        "edge": (r.randn(7, 5, 3).astype("<f4"), [3, 2, 3], None),
        "holes": (np.arange(40, dtype="<i4").reshape(8, 5), [4, 5], 7),
        "scalar": (np.array(12345, dtype="<i8"), [], None),
        "big_endian": (r.randn(6).astype(">f8"), [4], None),
        "bools": (r.rand(9) > 0.5, [4], None),
        "raw": (r.randint(0, 255, (5, 4)).astype("|u1"), [2, 4], None),
    }
    for name, (arr, chunks, fill) in cases.items():
        meta = {"shape": list(arr.shape), "chunks": chunks, "dtype": arr.dtype.str,
                "fill_value": fill,
                "compressor": None if name == "raw" else {"id": "zstd", "level": 3}}
        t = ts.open({"driver": "zarr", "kvstore": {**kv, "path": name + "/"},
                     "metadata": meta}, create=True).result()
        if name == "holes":
            t[4:8, :].write(arr[4:8]).result()  # chunk (0, 0) never written
            arr = arr.copy()
            arr[:4] = fill
        else:
            t.write(arr).result()
    with OcdbtStore(tmp_path) as store:
        for name, (arr, _, _) in cases.items():
            got = read_array(store, name)
            want = ts.open({"driver": "zarr", "kvstore": {**kv, "path": name + "/"}}
                           ).result().read().result()
            assert got.shape == want.shape and got.dtype == want.dtype.newbyteorder("="), name
            assert got.tobytes() == np.asarray(want, got.dtype).tobytes(), name
            assert got.flags.writeable
        with pytest.raises(ZarrError, match="'absent': no .zarray"):
            read_array(store, "absent")


# ------------------------------------------------------------- the fixture

def generate_fixture(out) -> None:
    """Write the fixture under ``out`` with the JAX package: a crater YOLO11
    of the narrowest width (``FIXTURE_SCALE``), two train steps at 64 px
    (B=4, synthetic batches), EMA on, per-leaf (saved as orbax ``leaf/``
    and as the npz fallback ``npz/``) and ``flat_opt`` (orbax ``flat/``):
    ``last`` only, at epoch ``FIXTURE_EPOCH``, with ``digests.json``."""
    import jax
    import orbax.checkpoint as ocp

    from yolo_scratch_tpu.losses.v8_loss import DetectionLossConfig
    from yolo_scratch_tpu.models.builder import build_yolo11
    from yolo_scratch_tpu.train.checkpoints import CheckpointManager
    from yolo_scratch_tpu.train.optim import cosine_epoch_schedule, make_optimizer
    from yolo_scratch_tpu.train.state import create_train_state
    from yolo_scratch_tpu.train.steps import build_train_step_custom, v8_loss_adapter
    from yolo_scratch_tpu_torch.data.loader import Loader
    from yolo_scratch_tpu_torch.data.synthetic import SyntheticDataset

    out = Path(out).resolve()
    out.mkdir(parents=True, exist_ok=True)
    cfg = json.loads((CONFIGS / "yolo11_crater.json").read_text())
    cfg["scales"] = FIXTURE_SCALE
    (out / FIXTURE_CFG).write_text(json.dumps(cfg, indent=1) + "\n")
    model = build_yolo11(str(out / FIXTURE_CFG), ch=1, nc=5, scale="t")
    batches = list(Loader(SyntheticDataset(n=8, img_size=64), 4, max_gt=8, prefetch=0))
    step = jax.jit(build_train_step_custom(
        model, v8_loss_adapter(DetectionLossConfig(nc=5, strides=model.strides))))
    # one jitted init for both states (an eager flax init takes ~30 s here)
    variables = jax.jit(partial(model.init, train=False))(
        jax.random.PRNGKey(0), np.zeros((1, 64, 64, 1), np.float32))
    initialised = SimpleNamespace(init=lambda *args, **kw: variables)
    found = {}
    for flat in (False, True):
        tx = make_optimizer(cosine_epoch_schedule(1e-3, epochs=10, steps_per_epoch=2))
        state = create_train_state(initialised, None, None, tx, use_ema=True, flat_opt=flat)
        for batch in batches:
            state, _ = step(state, batch)
        for form in ("flat",) if flat else ("leaf", "npz"):
            mgr = CheckpointManager(str(out / form), use_orbax=form != "npz", async_save=False)
            mgr.save_epoch(state, FIXTURE_EPOCH, {"loss": 3.5}, {"loss": 3.25, "mAP50": 0.125},
                           float("inf"), 0.25,
                           extra_meta={"patience": {"since_improve": 1, "best": 0.25}})
            mgr.wait()
            if form == "npz":
                tree = {"params": state.params, "batch_stats": state.batch_stats,
                        "opt_state": state.opt_state, "ema_params": state.ema_params,
                        "step": state.step}
                found[form] = digests(jax.device_get(tree))
            else:
                found[form] = digests(ocp.StandardCheckpointer().restore(out / form / "last"))
    (out / "digests.json").write_text(json.dumps(found, indent=0, sort_keys=True) + "\n")


def test_fixture_stays_small():
    """Three trees of ~150K parameters, four copies each (weights, EMA and
    two moments): the Detect head's box branch is 64 channels wide
    (4 x reg_max) at every width, so no narrower YOLO11 exists."""
    total = sum(f.stat().st_size for f in FIXTURE.rglob("*") if f.is_file())
    assert total < 9 << 20, total


@pytest.mark.parametrize("form", FORMS)
def test_fixture_forms_read_to_their_digests(form):
    want = json.loads((FIXTURE / "digests.json").read_text())[form]
    kind = find_jax_checkpoint(FIXTURE / form, "last")
    assert kind == ("npz" if form == "npz" else "orbax")
    tree = (read_jax_npz(FIXTURE / form / "last.npz") if kind == "npz"
            else read_orbax(FIXTURE / form / "last"))
    assert digests(tree) == want
    assert find_jax_checkpoint(FIXTURE / form, "best") is None


def test_npz_and_orbax_fixtures_hold_one_tree():
    d = json.loads((FIXTURE / "digests.json").read_text())
    assert d["leaf"] == d["npz"]
    assert d["flat"]["ema_params"]["shape"] == d["flat"]["opt_state/1/0/mu"]["shape"]


if __name__ == "__main__":
    # before JAX starts: the CPU, and XLA's kernels on one thread
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_cpu_multi_thread_eigen=false"
    generate_fixture(sys.argv[1])
