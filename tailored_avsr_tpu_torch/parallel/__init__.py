"""Data and tensor parallelism over ``torch.distributed`` (counterpart of
``tailored_avsr_tpu/parallel/``): the rank grid and the tensor-parallel rule
(``mesh.py``), each rank's rows of the global batch (``host_data.py``),
the tensor-parallel layers (``tensor_parallel.py``) and the multi-rank
dry run (``dryrun.py``)."""

from tailored_avsr_tpu_torch.parallel.host_data import (
    DataShard,
    data_shard,
    local_rows,
    process_batch_slice,
)
from tailored_avsr_tpu_torch.parallel.mesh import (
    Grid,
    init_from_env,
    make_grid,
    replicate,
    tp_param_spec,
)
