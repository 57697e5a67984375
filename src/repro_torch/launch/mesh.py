"""Device meshes over `torch.distributed` (counterpart of
`repro/launch/mesh.py`).

The reference's mesh axes keep their names: `pod` (data parallel across
pods), `data` (data parallel and parameter sharding), `model` (tensor and
expert parallel).  A mesh is a `DeviceMesh` over the process group that
exists; nothing here creates one at import time.  The group's backend
follows the device: NCCL for `cuda`, gloo for `cpu`, and a mesh refuses a
group whose backend does not match (the `fake` backend of the dry-run
stands in for either).  One process with no launcher gets its world of
one from `init_world_of_one`, which needs no TCP port.
"""
from __future__ import annotations

import os
import tempfile

import torch  # repro: noqa RPR001 -- launch-time mesh module; train-arch entry points only
import torch.distributed as dist  # repro: noqa RPR001 -- launch-time mesh module
from torch.distributed.device_mesh import DeviceMesh  # repro: noqa RPR001 -- mesh module

_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


def _device_type(device: str | torch.device) -> str:
    kind = torch.device(device).type
    if kind not in _BACKEND:
        raise ValueError(f"a mesh runs on 'cpu' or 'cuda', got {str(device)!r}")
    return kind


def init_world_of_one(device: str | torch.device = "cuda") -> str:
    """Initialise a process group of size 1 for this process, on NCCL for
    `cuda` and gloo for `cpu`, from a `FileStore` in a fresh temporary
    directory.  Returns the store's path; `dist.destroy_process_group()`
    ends the group.  Raises if a group already exists."""
    kind = _device_type(device)
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but torch sees no CUDA device")
        torch.cuda.set_device(torch.device(device).index or 0)
    path = os.path.join(tempfile.mkdtemp(prefix="repro_torch_pg_"), "store")
    dist.init_process_group(_BACKEND[kind], store=dist.FileStore(path, 1), rank=0,
                            world_size=1)
    return path


def _check_group(kind: str) -> None:
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_world_of_one() or "
                           "torch.distributed.init_process_group first")
    backend = str(dist.get_backend())
    if backend != "fake" and backend != _BACKEND[kind]:
        raise RuntimeError(f"a {kind} mesh needs a {_BACKEND[kind]} group, "
                           f"the process group is {backend}")


def _mesh(kind: str, shape: tuple, axes: tuple) -> DeviceMesh:
    n = 1
    for s in shape:
        n *= s
    return DeviceMesh(kind, torch.arange(n).reshape(shape), mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device: str | torch.device = "cuda") -> DeviceMesh:
    """16x16 = 256 devices a pod; `multi_pod` adds the 2-pod axis (512).
    Raises ValueError unless the world has exactly that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    kind = _device_type(device)
    need = 512 if multi_pod else 256
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have != need:
        raise ValueError(f"the production mesh {shape} needs {need} devices, "
                         f"the world has {have}")
    _check_group(kind)
    return _mesh(kind, shape, axes)


def make_host_mesh(data: int = 1, model: int = 1,
                   device: str | torch.device = "cuda") -> DeviceMesh:
    """A (data, model) mesh over the ranks that exist, clamped to the
    world's size as the reference clamps to its devices; the mesh takes the
    first data x model ranks."""
    kind = _device_type(device)
    _check_group(kind)
    n = dist.get_world_size()
    data = min(data, n)
    model = min(model, max(n // data, 1))
    return _mesh(kind, (data, model), ("data", "model"))


def dp_size(mesh: DeviceMesh) -> int:
    s = 1
    for name in ("pod", "data"):
        if name in mesh.mesh_dim_names:
            s *= mesh.size(mesh.mesh_dim_names.index(name))
    return s


def axis_size(mesh: DeviceMesh, name: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(name))
