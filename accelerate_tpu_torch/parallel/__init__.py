"""Several processes: the mesh (:mod:`.mesh`), data-axis placement
(:mod:`.sharding`), the ZeRO sharded update (:mod:`.zero`), host offload of
the optimizer state (:mod:`.host_offload`) and the collectives the port
issues (:mod:`.collectives`)."""

from .mesh import build_mesh, data_axes, local_mesh_shape, mesh_axis_names, model_axes
from .zero import ZeROConfig, zero_axes, zero_degree
