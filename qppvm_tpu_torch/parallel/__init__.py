"""Process groups, meshes, sharding and the horizon-parallel ring over
torch.distributed (port of qppvm_tpu/parallel/)."""
from qppvm_tpu_torch.parallel.mesh import (  # noqa: F401
    batch_spec,
    initialize_distributed,
    make_2d_mesh,
    make_mesh,
    replicate,
    run_ranks,
    shard_batch,
)
from qppvm_tpu_torch.parallel.ring_horizon import (  # noqa: F401
    RingRolloutInfo,
    ring_rollout,
)
