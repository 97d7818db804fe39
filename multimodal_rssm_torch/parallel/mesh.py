"""The training mesh over a ``torch.distributed`` world, and a data-parallel
step's collectives.

Port of the JAX package's ``parallel/mesh.py``.  The JAX package runs one
controller over a ``jax.sharding.Mesh`` and lets XLA insert the gradient
psum; the port runs one process per GPU (a "rank": NCCL on the card, gloo
on the CPU) and makes each collective itself.  The axis names carry over:

- ``slice`` x ``data`` shard the batch dimension (axis 1 of the time-major
  [L, B, ...] batch); every rank keeps the whole replay;
- ``model`` column-shards the wide weights and their Adam moments
  (``parallel/tensor.py``); the ranks of one model group hold the same
  rows of the batch.

The ranks are laid out as the JAX package's ``create_mesh`` /
``create_hybrid_mesh`` reshape their devices: rank = (s * D + d) * M + m,
``model`` innermost, so a model group is neighbouring ranks (on a host of
several GPUs, neighbouring cards).  Two kinds of process group cut the
world (``dist.new_group`` over rank lists read from the ``DeviceMesh``'s
``mesh`` tensor, no private ``DeviceMesh`` API; every rank creates every
group, in one order): ``data_axes`` -- the ranks sharing a model coordinate
(slice x data flattened), over which the batch is sharded and the
gradients, metrics and BatchNorm statistics reduce; ``model_group`` -- the
ranks sharing a (slice, data) coordinate, over which a sharded layer's
outputs are gathered.  With ``model`` 1 the data group is the whole world
and there is no model group.

``train.mesh`` has the JAX package's keys and meanings: ``data`` 0 with
``model`` 1 and ``slice`` 1 is no mesh; ``-1`` (or 0 beside a larger
``model`` / ``slice``) takes every rank left after ``slice`` x ``model``;
``data=1`` is a one-rank mesh, not "no mesh".  The mesh must cover the
world exactly.

A data-parallel step needs only ``all_reduce`` and ``broadcast`` (all that
gloo offers on CUDA tensors): the BatchNorm statistics and their gradients
(``all_reduce_sum``, differentiable), the averaged gradients and metrics
(``all_reduce_mean_``, ``mean_metrics``, one buffer per dtype), the
weights after init or load (``broadcast_``) and small host values
(``broadcast_object``).  The step's all-reduces run inside a
``torch.profiler`` span named ``SPAN``, so a trace attributes their device
work (the flat copies, the reduction, the division) to them.

``BatchShard`` says which rows of the global batch a rank holds, by its
rank in the data group (its coordinate on slice x data).  Under
``train.grad_accum`` the JAX package cuts the GLOBAL batch into micro-batches
and shards each over the data axes, so rank r's rows of micro-batch k are
``[k m + r m / n, k m + (r + 1) m / n)`` (m = B / grad_accum, n ranks); the
rank's local block lists them micro-batch by micro-batch, so that its
micro-batch k is again the k-th contiguous cut of the block.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, Iterable, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

from multimodal_rssm_torch.ops.cuda_kernels import RowMap

DATA_AXIS = "data"
MODEL_AXIS = "model"
SLICE_AXIS = "slice"

# torch's default: a collective that waits longer than this fails the run
DEFAULT_TIMEOUT_S = 1800.0
SPAN = "data_parallel"   # the profiler span around the step's all-reduces


# -- the world ------------------------------------------------------------------


def in_launched_world() -> bool:
    """Whether this process is a rank that ``torchrun`` (or another launcher
    setting ``RANK`` and ``WORLD_SIZE``) started."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def default_backend(device: torch.device) -> str:
    """The backend a rank on ``device`` joins over when none is given:
    gloo on the CPU, and for ranks that share a card (more ranks on this
    host, ``LOCAL_WORLD_SIZE``, than visible GPUs: NCCL refuses two ranks
    on one card, gloo runs them, through host memory); NCCL otherwise."""
    if device.type != "cuda":
        return "gloo"
    local = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    return "gloo" if local > torch.cuda.device_count() else "nccl"


def init_distributed(device: str = "cuda", backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join a world of ranks; returns this rank's device (made current).

    Without ``rank`` / ``world_size`` / ``init_method`` it joins a
    ``torchrun`` world from ``RANK`` / ``WORLD_SIZE`` (and ``MASTER_ADDR`` /
    ``MASTER_PORT``).  ``device``: "cuda" gives ``cuda:LOCAL_RANK`` (raises
    where that GPU is missing), "cuda:k" that card, "cpu" the CPU.
    ``backend``: ``default_backend``'s unless given.  A collective waiting
    longer than ``timeout_s`` fails."""
    from multimodal_rssm_torch.core.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if backend is None:
        backend = default_backend(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method or "env://",
        rank=int(os.environ["RANK"]) if rank is None else int(rank),
        world_size=(int(os.environ["WORLD_SIZE"]) if world_size is None
                    else int(world_size)),
        timeout=datetime.timedelta(seconds=float(timeout_s)))
    return dev


def is_main() -> bool:
    """Rank 0 of the world, or a process outside any world."""
    return not dist.is_initialized() or dist.get_rank() == 0


# -- the mesh -------------------------------------------------------------------


def mesh_sizes(cfg, world_size: Optional[int] = None
               ) -> Optional[Tuple[int, int, int]]:
    """(slice, data, model) of ``cfg.train.mesh``, or None for no mesh.
    ``data`` 0 / -1 beside a larger ``slice`` or ``model`` (or -1 alone)
    takes ``world_size // (slice * model)`` and needs ``world_size``."""
    spec = cfg.train.get("mesh") if hasattr(cfg, "train") else None
    if not spec:
        return None
    n_data = int(spec.get("data", 0) or 0)
    n_model = int(spec.get("model", 1) or 1)
    n_slice = int(spec.get("slice", 1) or 1)
    if n_data == 0 and n_model <= 1 and n_slice <= 1:
        return None
    if n_data in (0, -1):
        if world_size is None:
            raise ValueError(
                f"train.mesh.data={n_data} takes every rank left after slice "
                "x model: run under torchrun, or on GPUs to count, or give "
                "train.mesh.data")
        n_data = world_size // (n_slice * n_model)
        if n_data < 1:
            raise ValueError(f"a world of {world_size} ranks has no data "
                             f"axis left after slice {n_slice} x model "
                             f"{n_model}")
    return n_slice, n_data, n_model


def _init_mesh(device_type: str, shape: Tuple[int, ...],
               names: Tuple[str, ...]):
    from torch.distributed.device_mesh import init_device_mesh

    want = int(np.prod(shape))
    world = dist.get_world_size()
    if want != world:
        raise ValueError(f"mesh {dict(zip(names, shape))} needs {want} "
                         f"ranks, the world has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def create_mesh(n_data: Optional[int] = None, n_model: int = 1,
                device_type: str = "cuda"):
    """A ``DeviceMesh`` with (data, model) axes over the whole world
    (``n_data`` None: every rank left after ``n_model``)."""
    if n_data is None:
        n_data = dist.get_world_size() // n_model
    return _init_mesh(device_type, (n_data, n_model), (DATA_AXIS, MODEL_AXIS))


def create_hybrid_mesh(n_slices: int, n_data: Optional[int] = None,
                       n_model: int = 1, device_type: str = "cuda"):
    """A ``DeviceMesh`` with (slice, data, model) axes over the whole world:
    the JAX package's multi-slice mesh, ``slice`` outermost (on GPUs: the
    hosts, whose link is slower than NVLink inside one).  The batch shards
    over slice x data."""
    if n_data is None:
        n_data = dist.get_world_size() // (n_slices * n_model)
    return _init_mesh(device_type, (n_slices, n_data, n_model),
                      (SLICE_AXIS, DATA_AXIS, MODEL_AXIS))


def mesh_from_config(cfg, device_type: str = "cuda"):
    """The training mesh of ``cfg.train.mesh`` over the joined world, or
    None (no mesh, one process).  Raises ``RuntimeError`` for a mesh
    without a world, ``ValueError`` for a world without a mesh (of more
    than one rank) or one the mesh does not cover."""
    world = dist.get_world_size() if dist.is_initialized() else None
    sizes = mesh_sizes(cfg, world)
    if sizes is None:
        if world is not None and world > 1:
            raise ValueError(f"a world of {world} ranks needs train.mesh."
                             "data (or slice) to shard the batch over them")
        return None
    if world is None:
        raise RuntimeError(
            f"train.mesh={dict(zip((SLICE_AXIS, DATA_AXIS, MODEL_AXIS), sizes))}"
            " needs a torch.distributed world: start the run with the train "
            "CLI (it starts the ranks) or under torchrun")
    n_slice, n_data, n_model = sizes
    if n_slice > 1:
        return create_hybrid_mesh(n_slice, n_data, n_model, device_type)
    return create_mesh(n_data, n_model, device_type)


def _model_size(mesh) -> int:
    names = tuple(mesh.mesh_dim_names)
    return mesh.size(names.index(MODEL_AXIS)) if MODEL_AXIS in names else 1


def _own_group(rank_lists):
    """``dist.new_group`` over every list (every rank creates every group,
    in the same order); the one holding this rank."""
    me = dist.get_rank()
    mine = None
    for ranks in rank_lists:
        group = dist.new_group(ranks)
        if me in ranks:
            mine = group
    return mine


def data_axes(mesh):
    """The process group the batch, the gradients, the metrics and the
    BatchNorm statistics reduce over: the ranks of slice x data that share
    this rank's model coordinate.  With ``model`` 1 that is the whole world
    (the mesh covers it)."""
    n_model = _model_size(mesh)
    if n_model == 1:
        return dist.group.WORLD
    grid = mesh.mesh.reshape(-1, n_model)
    return _own_group([grid[:, m].tolist() for m in range(n_model)])


def model_group(mesh):
    """The process group of the ranks that share this rank's (slice, data)
    coordinate (its model group: the same rows, each with its own columns
    of the sharded weights), or None for ``model`` 1."""
    n_model = _model_size(mesh)
    if n_model == 1:
        return None
    grid = mesh.mesh.reshape(-1, n_model)
    return _own_group([row.tolist() for row in grid])


# -- a rank's rows ------------------------------------------------------------------


def local_rows(batch_size: int, rank: int, size: int, accum: int = 1
               ) -> np.ndarray:
    """The rows of a global batch of ``batch_size`` that rank ``rank`` of
    ``size`` holds, micro-batch by micro-batch (module docstring).  Raises
    ``ValueError`` unless slice x data x ``grad_accum`` divides the batch."""
    B, n, accum = int(batch_size), int(size), int(accum)
    if accum < 1 or B % (n * accum):
        raise ValueError(
            f"train.batch_size={B} is not divisible by slice x data = {n} "
            f"ranks times train.grad_accum={accum}")
    m = B // accum
    ml = m // n
    return (np.arange(accum)[:, None] * m + rank * ml
            + np.arange(ml)[None, :]).reshape(-1)


class BatchShard(NamedTuple):
    """Rank ``rank`` of ``size``'s part of a global batch of ``batch_size``
    rows cut into ``accum`` micro-batches."""

    batch_size: int
    rank: int
    size: int
    accum: int = 1

    @property
    def rows(self) -> np.ndarray:
        return local_rows(self.batch_size, self.rank, self.size, self.accum)

    @property
    def local_batch(self) -> int:
        return self.batch_size // self.size

    def noise_rows(self, device: torch.device, micro: bool = True
                   ) -> Tuple[torch.Tensor, int]:
        """(index, rows) for ``WorldModel.sharded_noise``: this rank's rows
        inside each global micro-batch of ``batch_size / accum`` rows
        (``micro``), or inside the whole global batch."""
        if not micro:
            return (torch.as_tensor(self.rows, device=device),
                    self.batch_size)
        m = self.batch_size // self.accum
        ml = m // self.size
        return (torch.arange(self.rank * ml, (self.rank + 1) * ml,
                             device=device), m)

    @property
    def row_map(self) -> RowMap:
        """The kernel's view of ``rows``: local row j is global row offset +
        (j // block) * stride + j % block."""
        m = self.batch_size // self.accum
        ml = m // self.size
        return RowMap(offset=self.rank * ml, rows_global=self.batch_size,
                      block_rows=ml, block_stride=m)


class ModelGroup(NamedTuple):
    """A model group (``model_group``) and this rank's place in it: a
    sharded weight's block ``rank`` of ``size`` along its output
    features."""

    group: object
    rank: int
    size: int


class DataParallel(NamedTuple):
    """A data-parallel step's group, and this rank's rows of a train batch
    (cut into ``grad_accum`` micro-batches) and of a validation batch
    (one); ``model``: this rank's model group, or None (``model`` 1)."""

    group: object
    train: BatchShard
    eval: BatchShard
    model: Optional[ModelGroup] = None


def data_parallel(mesh, batch_size: int, accum: int = 1) -> DataParallel:
    """This rank's ``DataParallel`` over ``data_axes(mesh)`` (its rows by
    its rank there) and ``model_group(mesh)``; raises ``ValueError`` unless
    slice x data x ``accum`` divides ``batch_size``."""
    group = data_axes(mesh)
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    local_rows(batch_size, rank, size, accum)
    mgroup = model_group(mesh)
    model = (None if mgroup is None else
             ModelGroup(mgroup, dist.get_rank(mgroup),
                        dist.get_world_size(mgroup)))
    return DataParallel(group, BatchShard(batch_size, rank, size, accum),
                        BatchShard(batch_size, rank, size, 1), model)


def shard_batch(batch, shard: BatchShard):
    """This rank's rows (axis 1) of a global [L, B, ...] batch
    (observations dict, actions, rewards, nonterminals; tensors or NumPy
    arrays)."""
    rows = shard.rows

    def take(x):
        if isinstance(x, torch.Tensor):
            return x.index_select(1, torch.from_numpy(rows).to(x.device))
        return np.ascontiguousarray(np.asarray(x)[:, rows])

    observations, *rest = batch
    return ({k: take(v) for k, v in observations.items()},
            *(take(x) for x in rest))


# -- collectives --------------------------------------------------------------------


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group forward; the gradient summed over the group
    backward (each rank's loss reaches every rank's input through the
    sum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        with record_function(SPAN):
            out = x.clone(memory_format=torch.contiguous_format)
            dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        with record_function(SPAN):
            grad = grad.clone(memory_format=torch.contiguous_format)
            dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum of ``x`` over ``group``."""
    return _AllReduceSum.apply(x, group)


def _by_dtype(tensors: Iterable[torch.Tensor]) -> Dict:
    groups: Dict = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    return groups


@torch.no_grad()
def all_reduce_mean_(tensors: Iterable[torch.Tensor], group) -> None:
    """Replace each tensor by its mean over ``group``, in place: one
    all-reduce per dtype over a flat copy."""
    size = dist.get_world_size(group)
    with record_function(SPAN):
        for ts in _by_dtype(tensors).values():
            flat = torch.cat([t.reshape(-1) for t in ts])
            dist.all_reduce(flat, group=group)
            flat.div_(size)
            offset = 0
            for t in ts:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()


@torch.no_grad()
def mean_metrics(metrics: Dict[str, torch.Tensor], group
                 ) -> Dict[str, torch.Tensor]:
    """0-d metrics averaged over ``group`` (one all-reduce, no host
    sync)."""
    if not metrics:
        return {}
    names = list(metrics)
    with record_function(SPAN):
        flat = torch.stack([metrics[k].float() for k in names])
        dist.all_reduce(flat, group=group)
        flat.div_(dist.get_world_size(group))
    return dict(zip(names, flat.unbind()))


@torch.no_grad()
def broadcast_(tensors: Iterable[torch.Tensor], group=None, src: int = 0
               ) -> None:
    """Overwrite each tensor with rank ``src``'s, in place: one broadcast
    per dtype over a flat copy."""
    for ts in _by_dtype(tensors).values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.broadcast(flat, src=src, group=group)
        offset = 0
        for t in ts:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def broadcast_module_(module: torch.nn.Module, group=None, src: int = 0
                      ) -> None:
    """Every parameter and buffer of ``module`` from rank ``src``."""
    broadcast_([*module.parameters(), *module.buffers()], group, src)


def broadcast_object(obj, src: int = 0):
    """A picklable host value from rank ``src`` (identity outside a
    world)."""
    if not dist.is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def barrier(device: torch.device, group=None) -> None:
    """Wait until every rank of ``group`` has queued its work to here and
    this rank's device has run it (an all-reduce read back)."""
    flag = torch.zeros(1, device=device)
    dist.all_reduce(flag, group=group)
    flag.item()
