"""Scale-out over torch.distributed (counterpart of
`neuronika_tpu/parallel/`): device meshes with named axes and stated
shardings (`mesh.py`), the differentiable collectives the sharded GPT step
is written with (`collectives.py`) and ring attention for a `cp` axis
(`ring.py`). The sharded train step itself is
`models.transformer.make_sharded_train_step`. The pipeline schedules
(JAX's `pipeline_forward`) are not ported yet (ROADMAP.md queue 1 item 5).
"""
from .ring import ring_flash_attention  # noqa: F401
from .mesh import (  # noqa: F401
    DataParallel,
    data_parallel_sharding,
    distributed_init,
    make_global_batch,
    make_hybrid_mesh,
    make_mesh,
    replicated,
    shard_batch,
)

__all__ = [
    "DataParallel", "data_parallel_sharding", "distributed_init",
    "make_global_batch", "make_hybrid_mesh", "make_mesh",
    "replicated", "shard_batch", "ring_flash_attention",
]
