"""Distributed training over ``torch.distributed`` process groups: BSP,
BMUF, SOD and the three parameter-server strategies (port of
kaldi_aslp_tpu/parallel/; reference: src/aslp-parallel/).  One process
a worker, as the reference's MPI ranks; see mesh.py for the groups and
the backend rule, launch.py for starting ranks on one host."""

from kaldi_aslp_tpu_torch.parallel.mesh import (
    Mesh,
    axis_group,
    initialize_distributed,
    is_main_host,
    make_mesh,
    shard_batch,
)
from kaldi_aslp_tpu_torch.parallel.bsp import (
    average_gradients,
    make_bsp_train_step,
)
from kaldi_aslp_tpu_torch.parallel.bmuf import (
    BmufOptions,
    BmufState,
    bmuf_sync,
    make_bmuf_block_step,
    stack_block_states,
)
from kaldi_aslp_tpu_torch.parallel.optimizers import (
    OptimizerOptions,
    apply_updates,
    make_optimizer,
)
from kaldi_aslp_tpu_torch.parallel.sod import (
    SodState,
    model_average_sync,
    sod_sync,
)
from kaldi_aslp_tpu_torch.parallel.ps import (
    PsOptions,
    PsState,
    asgd_pair_sync,
    easgd_pair_sync,
    make_ps_round_step,
    masgd_pair_sync,
    ps_round_sync,
    ps_sync_round,
    stack_worker_states,
)
