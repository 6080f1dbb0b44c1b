from yolo_scratch_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    make_ddp_train_step,
    make_mesh,
    make_sharded_train_step,
    replicate,
    shard_batch,
)
