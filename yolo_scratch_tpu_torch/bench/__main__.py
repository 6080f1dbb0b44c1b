"""``python -m yolo_scratch_tpu_torch.bench``: the headline bench."""

from yolo_scratch_tpu_torch.bench.headline import main

if __name__ == "__main__":
    main()
