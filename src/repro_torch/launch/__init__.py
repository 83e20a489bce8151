"""Launchers of the port: mesh construction (`repro_torch.launch.mesh`),
the training driver (`repro_torch.launch.train`, one card or a
``torchrun`` mesh), the serving driver (`repro_torch.launch.serve`), the
multi-pod dry run (`repro_torch.launch.dryrun`) and the analytic
step-cost model it is held against (`repro_torch.launch.roofline`)."""
from repro_torch.launch.mesh import (
    data_axes, elastic_mesh_shape, make_mesh, make_production_mesh,
)

__all__ = ["make_production_mesh", "make_mesh", "elastic_mesh_shape", "data_axes"]
