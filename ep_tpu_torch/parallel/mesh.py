"""Process group, mesh of ranks and the current-mesh registry.

Counterpart of ``ep_tpu/parallel/mesh.py``. The JAX package builds a
``jax.sharding.Mesh`` over its devices and lets GSPMD insert the
collectives; the port runs one process per card (PyTorch's idiom for JAX's
devices) on ``torch.distributed``, so a mesh here is a (data, model) grid of
ranks, row-major as the JAX package reshapes its devices:
``rank = data_index * model + model_index``.

Axes:
  * ``data``  — each data index loads its own rows (the reference's DDP,
    main_linprobe.py:618-620); gradients, BatchNorm moments and metrics are
    reduced over the ranks of this axis (``parallel/metrics.py``);
  * ``model`` — ranks that share a data index read the same rows. Where
    ``partition.py::shard_state`` cuts the frozen backbone over this axis,
    each rank computes its pieces and the blocks sum them over the axis'
    group; otherwise every rank computes the same thing. Attention's
    ``"auto"`` takes the plain route on such a mesh, as it takes XLA there.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

# (rank, world size) variables of the launchers whose ranks the port reads:
# torchrun, SLURM, Open MPI. jax.distributed.initialize reads SLURM and OMPI
# by itself; torch.distributed needs them spelled out.
_RANK_VARS = (("RANK", "WORLD_SIZE"), ("SLURM_PROCID", "SLURM_NTASKS"),
              ("OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_SIZE"))
_LOCAL_RANK_VARS = ("LOCAL_RANK", "SLURM_LOCALID", "OMPI_COMM_WORLD_LOCAL_RANK")


def _launcher_rank_world(forced: bool) -> tuple[int, int]:
    """This process's (rank, world size) from the launcher's variables. Only
    ``EP_TPU_MULTIHOST=1`` without them and without a world above 1 means a
    group of one; anything else that names no rank raises."""
    for rank_var, world_var in _RANK_VARS:
        if rank_var in os.environ:
            return int(os.environ[rank_var]), int(os.environ.get(world_var) or 1)
    if forced and int(os.environ.get("WORLD_SIZE") or 1) <= 1:
        return 0, 1
    raise RuntimeError(
        "distributed init: no variable names this process's rank; set RANK "
        "and WORLD_SIZE (torchrun does), or run under SLURM (SLURM_PROCID, "
        "SLURM_NTASKS) or Open MPI (OMPI_COMM_WORLD_RANK, _SIZE)")


def _init_method(cfg) -> str:
    """``--dist_url`` (default ``env://``: MASTER_ADDR and MASTER_PORT); with
    ``env://`` and no MASTER_ADDR, the JAX launcher's COORDINATOR_ADDRESS
    (host:port) as a TCP rendezvous."""
    url = getattr(cfg, "dist_url", None) or "env://"
    if url == "env://" and "MASTER_ADDR" not in os.environ and \
            "COORDINATOR_ADDRESS" in os.environ:
        url = f"tcp://{os.environ['COORDINATOR_ADDRESS']}"
    return url


def init_distributed(cfg=None) -> None:
    """Join the process group when a launcher says there are several
    processes. A no-op for a single process.

    The trigger table is the JAX package's (``ep_tpu/parallel/mesh.py:27``),
    plus torchrun's ``RANK``: a launcher variable (COORDINATOR_ADDRESS,
    SLURM_PROCID, OMPI_COMM_WORLD_RANK, JOBSET_NAME, RANK) triggers unless
    the world size it states (SLURM_NTASKS, OMPI_COMM_WORLD_SIZE,
    WORLD_SIZE) is 1; rank-0 values ("0") trigger too. ``EP_TPU_MULTIHOST``
    forces it: "0" or "" off, anything else on. A WORLD_SIZE above 1 that no
    launcher variable triggers raises: the rank is unknown.

    The backend is NCCL on a CUDA device and gloo on the CPU (``--device
    cpu`` or no card). Each process takes the card ``LOCAL_RANK`` (or
    SLURM_LOCALID, OMPI_COMM_WORLD_LOCAL_RANK) modulo the device count, so
    several ranks may share one card. A group that is already initialised
    (``torch.distributed.is_initialized()``) is kept; an init that fails
    raises."""
    force = os.environ.get("EP_TPU_MULTIHOST")
    if force is not None and force in ("0", ""):
        return
    if force is None:
        launcher_envs = ("COORDINATOR_ADDRESS", "SLURM_PROCID",
                         "OMPI_COMM_WORLD_RANK", "JOBSET_NAME", "RANK")
        trigger = next((v for v in launcher_envs if v in os.environ), None)
        if trigger is None:
            if int(os.environ.get("WORLD_SIZE") or 1) > 1:
                raise RuntimeError(
                    f"WORLD_SIZE={os.environ['WORLD_SIZE']} but no launcher "
                    "variable names this process's rank (RANK, SLURM_PROCID, "
                    "OMPI_COMM_WORLD_RANK); set EP_TPU_MULTIHOST=0 to run "
                    "one process")
            return
        # A launcher var alone isn't enough: single-task SLURM allocations
        # also export SLURM_PROCID. Require world size > 1 when it's known.
        world_envs = ("SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE", "WORLD_SIZE")
        world = next((os.environ[v] for v in world_envs if os.environ.get(v)),
                     None)
        if world is not None:
            try:
                if int(world) <= 1:
                    return
            except ValueError:
                pass
    else:
        trigger = "EP_TPU_MULTIHOST"
    print(f"| distributed init (trigger {trigger})")
    use_cuda = torch.cuda.is_available() and \
        getattr(cfg, "device", None) != "cpu"
    if use_cuda:
        local = next((int(os.environ[v]) for v in _LOCAL_RANK_VARS
                      if v in os.environ), 0)
        torch.cuda.set_device(local % torch.cuda.device_count())
    if dist.is_initialized():
        print("| distributed init skipped: the process group is already "
              "initialised")
    else:
        rank, world = _launcher_rank_world(trigger == "EP_TPU_MULTIHOST")
        dist.init_process_group("nccl" if use_cuda else "gloo",
                                init_method=_init_method(cfg), rank=rank,
                                world_size=world)
    print(f"| distributed ready: process {process_index()} / "
          f"{process_count()}")


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A (data, model) grid of ranks and this rank's place in it. ``groups``
    holds, per axis, the process group of the ranks that share this rank's
    other coordinate; an axis of size 1 needs none, and one that spans the
    world uses the default group (None)."""

    data: int
    model: int
    rank: int = 0
    groups: dict = dataclasses.field(default_factory=dict)

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    def group(self, axis: str):
        return self.groups.get(axis)


def make_mesh(data: int = -1, model: int = 1) -> Mesh:
    """Build a (data, model) mesh over the world's ranks.

    Pure constructor: it does NOT touch the current-mesh registry that gates
    kernel dispatch and the reductions; a driver registers its mesh with
    ``set_current_mesh`` (or ``use_mesh``). With more than one process every
    rank must call it with the same arguments: each axis group is created
    on every rank, in the same order."""
    n = process_count()
    if data == -1:
        if n % model:
            raise ValueError(f"{n} processes not divisible by model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} processes")
    rank = process_index()
    groups = {}
    if n > 1:
        rows = {DATA_AXIS: [[d * model + m for d in range(data)]
                            for m in range(model)],
                MODEL_AXIS: [[d * model + m for m in range(model)]
                             for d in range(data)]}
        for axis, members in rows.items():
            if len(members[0]) in (1, n):
                continue
            for ranks in members:
                group = dist.new_group(ranks)
                if rank in ranks:
                    groups[axis] = group
    return Mesh(data, model, rank, groups)


# --- current-mesh registry ---------------------------------------------------
#
# The registered mesh gates attention's kernel route ("auto" keeps the kernels
# on a data-only mesh) and tells the reductions (BatchNorm's moments, the
# gradients, the metrics) which ranks hold other rows of the global batch.

_CURRENT_MESH: Optional[Mesh] = None


def set_current_mesh(mesh: Optional[Mesh]) -> None:
    global _CURRENT_MESH
    _CURRENT_MESH = mesh


def current_mesh() -> Optional[Mesh]:
    return _CURRENT_MESH


class use_mesh:
    """Context manager pinning the current mesh."""

    def __init__(self, mesh: Optional[Mesh]):
        self.mesh = mesh

    def __enter__(self):
        self.prev = current_mesh()
        set_current_mesh(self.mesh)
        return self.mesh

    def __exit__(self, *exc):
        set_current_mesh(self.prev)


def shard_batch(batch, device=None):
    """Place this rank's batch (an array or tensor, or a tuple or list of
    them) on ``device`` (default: this process's card). Each rank's loader
    already yields only its own rows of the global batch, so nothing is
    split here."""
    device = torch.device(device) if device is not None else \
        torch.device("cuda", torch.cuda.current_device())

    def put(x):
        return torch.as_tensor(x).to(device)
    if isinstance(batch, (tuple, list)):
        return type(batch)(put(x) for x in batch)
    return put(batch)


def process_count() -> int:
    return dist.get_world_size() if dist.is_available() and \
        dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and \
        dist.is_initialized() else 0


def is_main_process() -> bool:
    return process_index() == 0


def local_device_count() -> int:
    """Cards this process drives: one (a process per card)."""
    return 1


def barrier() -> None:
    """Wait for every rank (nothing to wait for in one process)."""
    if process_count() > 1:
        dist.barrier()
