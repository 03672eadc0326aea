"""Data parallelism of the port (`gea/parallel/` is the reference): the
process group of a run (`mesh`) and the averaging inside the train steps
(`dp`)."""

from gea_torch.parallel.dp import DataParallel  # noqa: F401
from gea_torch.parallel.mesh import (  # noqa: F401
    join,
    launcher_env,
    resolve_num_devices,
    spawn,
)
