"""Launch layer of the port: the serve and train CLIs, mesh descriptions,
sharding rules, the multi-process bootstrap, input specs on the meta
device, the dry run and its roofline (H100 constants)."""
from repro_torch.launch.mesh import (Mesh, data_axes, make_host_mesh,
                                     make_production_mesh, model_axis_size)

__all__ = ["Mesh", "data_axes", "make_host_mesh", "make_production_mesh",
           "model_axis_size"]
