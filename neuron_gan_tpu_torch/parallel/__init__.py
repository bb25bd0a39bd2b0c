from neuron_gan_tpu_torch.parallel.data import spawn, take_rows  # noqa: F401
from neuron_gan_tpu_torch.parallel.mesh import (  # noqa: F401
    Grid, NetShards, ShardedState, gather_state, is_sharded, mesh_ranks,
    shard_state)
