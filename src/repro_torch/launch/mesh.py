"""Mesh construction — the port of the JAX package's
``repro/launch/mesh.py``, over ``torch.distributed``'s ``DeviceMesh``.

A mesh spans the ranks of the default process group, which the caller
starts (``torch.distributed.init_process_group``: gloo on the CPU, nccl
on the card); the mesh's device type follows the group's backend. These
are functions, so importing the module touches no process group.
"""
from __future__ import annotations

import math
from typing import Tuple

__all__ = ["make_mesh", "make_production_mesh"]


def _device_type() -> str:
    import torch.distributed as dist
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]):
    """A ``DeviceMesh`` of ``shape`` with axis names ``axes`` over the
    first ``prod(shape)`` ranks of the default group (e.g. (2, 2) on four
    gloo processes)."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(_device_type(), tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    """The production mesh: (16, 16) over ``("data", "model")``, or
    (2, 16, 16) over ``("pod", "data", "model")``; ``RuntimeError`` when
    the world is smaller."""
    import torch.distributed as dist
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    world = dist.get_world_size()
    if world < n:
        raise RuntimeError(f"mesh {shape} needs {n} ranks, have {world}")
    return make_mesh(shape, axes)
