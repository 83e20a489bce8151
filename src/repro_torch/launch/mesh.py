"""Mesh construction (twin of ``repro.launch.mesh``).

A mesh is a `torch.distributed.device_mesh.DeviceMesh` with the
reference's axis names (``data``, ``model``, ``pod``, ``pipe``): one
process per rank, the default process group already initialised
(``torchrun`` or `torch.distributed.init_process_group`).  Functions, not
module constants, so importing this module touches no device or group.

`use_mesh` is the port's ``jax.set_mesh``: it sets the ambient mesh that
`repro_torch.distributed.activations` and `repro_torch.distributed.fsdp`
read.  Nothing is ambient by default, so a run on one device without a
mesh is untouched.

`flush_mesh` differs in kind: the reference shards a giant prediction
flush over a one-axis ``("rows",)`` mesh of local devices inside one
process; here it is the list of local cards that one process launches
the tree kernel on, shard by shard (`repro_torch.kernels.tree_gather`).
"""
from __future__ import annotations

import contextlib
from typing import Any, Iterator, List, Optional, Tuple

import numpy as np
import torch

# The ambient mesh is process-wide, not per thread: autograd runs a CUDA
# graph's backward (and with it every remat recompute) on its own thread,
# which must see the mesh the forward saw.
_AMBIENT = {"mesh": None}


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              device_type: str = "cuda"):
    """A `DeviceMesh` of ``shape`` named ``axes`` over the default process
    group's ranks, in row-major order (the reference's ``jax.make_mesh``)."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.utils.device import resolve_device

    resolve_device(device_type)       # the card, or an error: never the host unasked
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    return init_device_mesh(device_type, tuple(int(s) for s in shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """(16,16) data×model single-pod or (2,16,16) pod×data×model multi-pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def flush_mesh(max_devices: Optional[int] = None) -> Optional[List[torch.device]]:
    """The local cards a giant prediction flush is sharded over by rows
    (whole NAS generations / RPC micro-batches), or None on a host with
    one card or none, so callers keep the unsharded path.

    The bank is copied once to each card and flush rows are split in row
    order; reassembly is deterministic because rows are padded to a
    device multiple and concatenated back in row order (see
    `repro_torch.kernels.tree_gather.CudaBank`).
    """
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if max_devices is not None:
        n = min(n, max_devices)
    if n <= 1:
        return None
    return [torch.device("cuda", i) for i in range(n)]


def elastic_mesh_shape(n_devices: int, *, model_parallel: int = 16,
                       pods: int = 1) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """Choose a mesh for whatever device count survived (elastic restart).

    Keeps the model axis fixed (sharding of weights must still fit) and
    gives the remainder to data; drops to a 1-axis mesh for tiny counts.
    """
    model_parallel = min(model_parallel, n_devices)
    while n_devices % model_parallel != 0:
        model_parallel //= 2
    data = n_devices // model_parallel // pods
    if pods > 1 and data >= 1:
        return (pods, data, model_parallel), ("pod", "data", "model")
    data = n_devices // model_parallel
    return (data, model_parallel), ("data", "model")


def data_axes(mesh) -> Tuple[str, ...]:
    """Axes that shard the batch (pod+data when present)."""
    names = tuple(mesh.mesh_dim_names)
    return tuple(a for a in ("pod", "data") if a in names)


def axis_sizes(mesh) -> dict:
    """{axis name: size} of ``mesh`` (the reference's
    ``dict(zip(mesh.axis_names, mesh.devices.shape))``)."""
    # `DeviceMesh.shape` reads no device tensor (``mesh.mesh`` may build
    # one, which a fake-tensor trace refuses); a bare layout gives ``mesh``.
    shape = mesh.shape if hasattr(mesh, "shape") else np.shape(mesh.mesh)
    return dict(zip(mesh.mesh_dim_names, (int(s) for s in shape)))


def axis_info(mesh, name: str) -> Tuple[Any, int, int]:
    """(process group, size, this rank's index) of ``mesh``'s axis
    ``name``, asked of the mesh once (the layers ask per leaf and call)
    and kept on the mesh, so it lives no longer than the mesh does."""
    cache = mesh.__dict__.setdefault("_axis_info", {})
    if name not in cache:
        cache[name] = (mesh.get_group(name), mesh.size(mesh.mesh_dim_names.index(name)),
                       mesh.get_local_rank(name))
    return cache[name]


def mesh_shape(mesh) -> List[int]:
    """The mesh's shape as a list (a checkpoint's ``mesh_shape``)."""
    return [int(s) for s in np.shape(mesh.mesh)]


@contextlib.contextmanager
def use_mesh(mesh) -> Iterator[None]:
    """Make ``mesh`` the ambient mesh inside the block (``jax.set_mesh``)."""
    prev = _AMBIENT["mesh"]
    _AMBIENT["mesh"] = mesh
    try:
        yield
    finally:
        _AMBIENT["mesh"] = prev


def ambient_mesh():
    """The mesh set by the innermost `use_mesh`, or None."""
    return _AMBIENT["mesh"]
