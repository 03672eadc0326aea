"""Parallelism of the port (`gea/parallel/` is the reference): the
process group of a run (`mesh`), the averaging inside the train steps
(`dp`) and tensor parallelism's sharded state (`tp`)."""

from gea_torch.parallel.dp import DataParallel  # noqa: F401
from gea_torch.parallel.mesh import (  # noqa: F401
    join,
    launcher_env,
    resolve_num_devices,
    spawn,
)
