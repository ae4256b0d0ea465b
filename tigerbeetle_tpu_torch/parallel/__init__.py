"""Row sharding over a mesh of shards (counterpart of
``tigerbeetle_tpu/parallel``)."""

from tigerbeetle_tpu_torch.parallel.sharded import (  # noqa: F401
    build_apply_step,
    make_mesh,
)
