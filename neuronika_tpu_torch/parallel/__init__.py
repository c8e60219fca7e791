"""Scale-out over torch.distributed (counterpart of
`neuronika_tpu/parallel/`): device meshes with named axes and stated
shardings (`mesh.py`), the differentiable collectives the sharded GPT step
is written with (`collectives.py`), ring attention for a `cp` axis
(`ring.py`) and the GPipe and 1F1B schedules for a `pp` axis
(`pipeline.py`). The train steps themselves are
`models.transformer.make_sharded_train_step` (dp, tp, cp, ep) and
`make_pipelined_train_step` / `make_pipelined_train_step_1f1b` (pp);
tensor-parallel serving is `make_generate(mesh=)` and the batchers'
`mesh=` (`serving.py`).
"""
from .pipeline import pipeline_forward, pipeline_train_1f1b  # noqa: F401
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
    "pipeline_forward", "pipeline_train_1f1b",
]
