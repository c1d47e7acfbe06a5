"""Walker parallelism on ``torch.distributed``: the port of
waveflow_tpu/parallel/ (one process per device, a process group per mesh
axis, explicit collectives on detached tensors)."""

from waveflow_tpu_torch.parallel.mesh import (
    HOST_CHIP_AXES, WALKER_AXIS, WalkerMesh, all_gather, axis_index,
    axis_size, destroy_walker_mesh, distributed_init, local_device,
    make_host_chip_mesh, make_walker_mesh, pmean, psum,
)
from waveflow_tpu_torch.parallel.sharding import (
    local_batch_size, make_sharded_mala_window, make_sharded_mcmc_window,
    make_sharded_sampler, make_sharded_spring_window, make_sharded_sr_window,
    make_sharded_train_step, make_sharded_train_window, psum_mean, rank_seed,
    shard_batch, walker_generator,
)
from waveflow_tpu_torch.parallel.resample import (
    resample_walkers_sharded, systematic_indices,
)
from waveflow_tpu_torch.parallel.probprog import (
    make_sharded_chain_sampler, make_sharded_smc,
)
