from ia_spgemm_tpu_torch.parallel.distributed import (  # noqa: F401
    ShardedCSR,
    partition_rows,
    dist_spgemm,
    gather_result,
)
from ia_spgemm_tpu_torch.parallel.mesh import Mesh, make_mesh  # noqa: F401
from ia_spgemm_tpu_torch.parallel import multihost  # noqa: F401
