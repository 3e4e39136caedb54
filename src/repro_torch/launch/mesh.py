"""Hardware constants of the port's target card (NVIDIA H100 SXM), the
host mesh and the production meshes (port of ``repro/launch/mesh.py``).

The reference's module holds TPU v5e constants and builds jax meshes.  The
planners need the card's memory, which is read from the device itself
(``torch.cuda.get_device_properties(dev).total_memory``) and threaded
through ``launch.plan`` as ``hbm_bytes``; :data:`H100_HBM_BYTES` is that
number on the H100 80GB HBM3 (``chip_smoke.py`` checks it against the
card), the budget of the dry run, which runs where there is no card.
``REFERENCE_HBM_BYTES`` is the reference's 16 GiB v5e figure, kept so
tests can pin the reference's budget.

The host mesh is a ``torch.distributed`` ``DeviceMesh`` over the process
group's world: :func:`init_distributed` starts the group from
``torchrun``'s environment (NCCL on CUDA with a card per rank, gloo on the
CPU or for ranks sharing a node's cards; :func:`pick_backend`), and
:func:`make_host_mesh` lays its ranks out as ``("data", "model")``.

The production meshes (:func:`make_production_mesh`: ``{data: 16, model:
16}`` and ``{pod: 2, data: 16, model: 16}``) are ``DeviceMesh``es over
torch's *fake* process group in this one process (:func:`fake_group`,
backend ``"fake"``): this process is rank 0 of 256 or 512, a collective
returns at once and sends nothing, and the tensors a step runs on are fake
(no storage).  The reference builds them over 512 placeholder CPU devices
for the same purpose, its dry run.
"""

from __future__ import annotations

import contextlib
import math
import os
from typing import Iterator, Optional, Sequence, Tuple, Union

import torch

# H100 SXM data-sheet peaks (dense, at the 700 W power limit)
PEAK_FLOPS_BF16 = 989e12  # per card, tensor cores
PEAK_FLOPS_F32 = 67e12  # per card, CUDA cores (no TF32)
HBM_BW = 3.35e12  # bytes/s per card
#: the reference's per-chip HBM (TPU v5e, ``repro/launch/mesh.py:20``)
REFERENCE_HBM_BYTES = 16 * 1024**3
#: ``total_memory`` of one NVIDIA H100 80GB HBM3 (the card the port targets)
H100_HBM_BYTES = 85_017_493_504

#: The reference's production meshes: one pod of 16 × 16, two pods
SINGLE_POD: Tuple[Tuple[int, ...], Tuple[str, ...]] = ((16, 16), ("data", "model"))
MULTI_POD: Tuple[Tuple[int, ...], Tuple[str, ...]] = ((2, 16, 16), ("pod", "data", "model"))


def device_hbm_bytes(device: Optional[Union[str, torch.device]] = None) -> int:
    """Total memory of one CUDA card; raises when there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        raise ValueError(f"device memory is read from a CUDA card, got {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass hbm_bytes explicitly on the CPU")
    return int(torch.cuda.get_device_properties(dev).total_memory)


def planning_hbm_bytes(device: torch.device) -> float:
    """The memory a launcher plans against on ``device``: the card's on
    CUDA, the reference's per-device figure on the CPU (so CPU plans equal
    the reference's)."""
    return device_hbm_bytes(device) if device.type == "cuda" else REFERENCE_HBM_BYTES


def pick_backend(device_type: str, world: int, local_world: Optional[int], cards: int) -> str:
    """The process group's backend: gloo on the CPU; on CUDA, NCCL when
    this node's ranks (``local_world``, torchrun's ``LOCAL_WORLD_SIZE``)
    have a card each, gloo when they share this node's cards in a
    single-node group (gloo carries CUDA tensors through host memory).  Any
    other layout raises rather than reduce every gradient on the host: ranks
    sharing cards in a multi-node group, or more ranks than cards with no
    ``LOCAL_WORLD_SIZE`` to tell a node's ranks from the world."""
    if device_type != "cuda":
        return "gloo"
    if local_world is None:
        if world <= cards:
            return "nccl"
        raise ValueError(f"{world} ranks and {cards} cards here, and no LOCAL_WORLD_SIZE "
                         "to say how many ranks share this node (torchrun sets it)")
    if local_world <= cards:
        return "nccl"
    if world == local_world:
        return "gloo"
    raise ValueError(f"{local_world} ranks share this node's {cards} cards in a group of "
                     f"{world} ranks across nodes: run one rank per card (NCCL)")


def init_distributed(device: torch.device) -> int:
    """Join the process group ``torchrun`` describes (``WORLD_SIZE``,
    ``RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT`` in the
    environment), on :func:`pick_backend`'s backend, which rank 0 prints.
    On CUDA this process takes the card ``LOCAL_RANK`` modulo the cards
    there are.  Returns the rank; a group already started is kept."""
    import torch.distributed as dist

    world = int(os.environ.get("WORLD_SIZE", 1))
    local = os.environ.get("LOCAL_WORLD_SIZE")
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    backend = pick_backend(device.type, world, None if local is None else int(local), cards)
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)) % cards)
    if not dist.is_initialized():
        dist.init_process_group(backend)
        if dist.get_rank() == 0:
            print(f"process group: {backend}, {world} ranks, {local or world} on this node"
                  + (f" sharing {cards} cards" if backend == "gloo" and cards else ""),
                  flush=True)
    return dist.get_rank()


def make_host_mesh(device: torch.device, model: int = 1):
    """The process group's world as a ``(world/model, model)`` mesh with
    axes ``("data", "model")`` (the reference's host mesh)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    if n % model:
        raise ValueError(f"world size {n} is not divisible by model={model}")
    return init_device_mesh(device.type, (n // model, model), mesh_dim_names=("data", "model"))


@contextlib.contextmanager
def fake_group(world: int) -> Iterator[None]:
    """This process as rank 0 of a fake process group of ``world`` ranks
    (``torch.testing._internal.distributed.fake_pg``), destroyed on exit.
    Raises when a process group is already started here."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already started in this process")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_fake_mesh(shape: Sequence[int], names: Sequence[str], device_type: str = "cpu"):
    """A ``DeviceMesh`` of ``shape`` over the started fake group (its world
    is the mesh's size)."""
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(device_type, torch.arange(math.prod(shape)).reshape(tuple(shape)),
                      mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cpu"):
    """The reference's production mesh over the started fake group of 256
    (one pod: ``(data 16, model 16)``) or 512 ranks (``multi_pod``: ``(pod 2,
    data 16, model 16)``)."""
    return make_fake_mesh(*(MULTI_POD if multi_pod else SINGLE_POD), device_type=device_type)


def mesh_num_devices(mesh) -> int:
    """Devices of a ``DeviceMesh`` (or of an ``{axis: size}`` dict)."""
    from repro_torch.parallel.sharding import axis_sizes_of

    n = 1
    for size in axis_sizes_of(mesh).values():
        n *= size
    return n
