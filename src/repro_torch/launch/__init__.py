"""Launchers of the port: mesh construction (`repro_torch.launch.mesh`),
the training driver (`repro_torch.launch.train`, one card or a
``torchrun`` mesh) and the serving driver (`repro_torch.launch.serve`).
The reference's multi-pod dry-run is not ported yet."""
from repro_torch.launch.mesh import (
    data_axes, elastic_mesh_shape, make_mesh, make_production_mesh,
)

__all__ = ["make_production_mesh", "make_mesh", "elastic_mesh_shape", "data_axes"]
