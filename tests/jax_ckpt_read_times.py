"""Seconds to read one full-width JAX checkpoint on this host: the port's
reader (``train/jax_checkpoints.py``) beside orbax's own restore, and the
port's zstd decoder's MB/s beside libzstd's (``zstandard``) on the same
frames. Host code only; a CPU script (it needs JAX, orbax and zstandard to
write and to compare).

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/jax_ckpt_read_times.py [--reps 5]

The checkpoint is what the JAX package's ``CheckpointManager.save_epoch``
writes for the crater YOLO11n (2.6M parameters) with EMA, per-leaf and
``flat_opt``, after one update of seeded gradients (the moments non-zero).
Each time is the best of ``--reps``. Prints one JSON line.
"""

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np


def best_s(fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return min(times)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=5)
    args = p.parse_args(argv)

    import jax
    import orbax.checkpoint as ocp
    import zstandard

    from yolo_scratch_tpu.train.checkpoints import CheckpointManager as JaxManager
    from yolo_scratch_tpu.train.optim import make_optimizer
    from yolo_scratch_tpu.train.state import create_train_state
    from yolo_scratch_tpu.utils.torch_import import convert_reference_state_dict
    from yolo_scratch_tpu_torch.models.builder import CONFIGS, build_yolo11
    from yolo_scratch_tpu_torch.train.checkpoints import CheckpointManager
    from yolo_scratch_tpu_torch.train.jax_checkpoints import read_orbax
    from yolo_scratch_tpu_torch.utils import zstd
    from yolo_scratch_tpu_torch.utils.ocdbt import OcdbtStore

    model = build_yolo11(CONFIGS / "yolo11_crater.json", ch=1, nc=5, scale="n")
    params, stats = convert_reference_state_dict(model.state_dict())
    variables = {"params": params, "batch_stats": stats}
    rng = np.random.RandomState(0)
    grads = jax.tree_util.tree_map(lambda a: (rng.randn(*a.shape) * 1e-2).astype(np.float32),
                                   params)
    zstd.load()
    out = {"host": "cpu", "parameters": sum(p.numel() for p in model.parameters()),
           "reps": args.reps}
    with tempfile.TemporaryDirectory() as tmp:
        for flat in (False, True):
            form = "flat" if flat else "leaf"
            state = create_train_state(SimpleNamespace(init=lambda *a, **k: variables), None,
                                       None, make_optimizer(1e-3), use_ema=True, flat_opt=flat)
            state = jax.jit(type(state).apply_gradients)(state, grads)
            d = Path(tmp) / form
            mgr = JaxManager(str(d), async_save=False)
            mgr.save_epoch(state, 0, {}, {"loss": 1.0}, float("inf"), 0.0)
            mgr.wait()
            last = d / "last"
            ckpt = ocp.StandardCheckpointer()
            row = {
                "bytes_on_disk": sum(f.stat().st_size for f in last.rglob("*") if f.is_file()),
                "orbax_restore_s": best_s(lambda: ckpt.restore(last), args.reps),
                "read_orbax_s": best_s(lambda: read_orbax(last), args.reps),
                "load_raw_s": best_s(lambda: CheckpointManager(str(d)).load_raw("last"),
                                     args.reps),
            }
            row["read_over_restore"] = row["read_orbax_s"] / row["orbax_restore_s"]
            with OcdbtStore(last) as store:
                frames = [v for v in map(store.get, store.list()) if v[:4] == b"\x28\xb5\x2f\xfd"]
            n_out = sum(len(zstd.decompress(f)) for f in frames)
            dec = zstandard.ZstdDecompressor()
            row["frames"], row["frame_bytes_out"] = len(frames), n_out
            row["decoder_mb_s"] = n_out / best_s(
                lambda: [zstd.decompress(f) for f in frames], args.reps) / 1e6
            row["libzstd_mb_s"] = n_out / best_s(
                lambda: [dec.decompress(f, max_output_size=1 << 30) for f in frames],
                args.reps) / 1e6
            out[form] = row
    payload = rng.randn(4 << 20).astype(np.float32).tobytes()
    frame = zstandard.ZstdCompressor(level=1).compress(payload)
    out["decoder_mb_s_16mib_f32_level1"] = len(payload) / best_s(
        lambda: zstd.decompress(frame), args.reps) / 1e6
    out["libzstd_mb_s_16mib_f32_level1"] = len(payload) / best_s(
        lambda: zstandard.ZstdDecompressor().decompress(frame), args.reps) / 1e6
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
