"""The port's measurement entry points (port of the JAX repo's ``bench.py``
and ``scripts/bench_*.py``). Each module prints one JSON line with its JAX
script's keys, plus every window, the best, the median and the device it
ran on, and runs on ``cuda`` unless ``--device cpu`` (a CPU line is not a
device number). ``python -m yolo_scratch_tpu_torch.`` then:

* ``bench`` (:mod:`.headline`): ``bench.py``;
* ``bench.latency``, ``bench.scale``, ``bench.breakdown``, ``bench.export``,
  ``bench.int8_scales``, ``bench.e2e``, ``bench.serving``, ``bench.eval``,
  ``bench.ingest``: ``scripts/bench_<name>.py``.

The shared pieces (deploy model, seeded uint8 batches, timed windows, the
device block, kernel #1's counter) are in :mod:`.common`.
"""
