from multimodal_rare_disease.parallel.mesh import (  # noqa: F401
    create_mesh,
    batch_sharding,
    replicated_sharding,
    shard_batch,
    describe_devices,
)
from multimodal_rare_disease.parallel.tp import (  # noqa: F401
    describe_tp,
    shard_train_state,
    tp_spec,
)
