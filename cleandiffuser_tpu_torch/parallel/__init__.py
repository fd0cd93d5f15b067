from .dp import DataParallelEngine, fsdp_shard_params
from .integrate import device_of, place_pipeline, place_state, setup_mesh
from .mesh import batch_sharded, make_mesh, replicated, shard_batch
from .sample import shard_sample_fn
