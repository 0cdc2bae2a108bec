"""The ("data", "model") mesh, batch slices and the tensor-parallel FC head.

Port of yolo_tpu/parallel/mesh.py. JAX places global arrays on a
``jax.sharding.Mesh`` and XLA inserts the collectives; here each process is
one device of a ``torch.distributed.device_mesh.DeviceMesh`` of the same
shape and axis names, and the collectives are explicit:

- ``"data"``: every rank takes its rows of a global batch
  (:func:`batch_slice`, the counterpart of ``batch_sharding`` /
  ``put_sharded``); the Trainer averages gradients over the data group with
  ``DistributedDataParallel``, and the train-mode BN all-reduces its
  statistics over it (:func:`sync_batch_norm`).
- ``"model"``: the detection head's FC stack is Megatron-style
  (:func:`shard_head`, JAX ``_param_spec``, mesh.py:61-80): fc1 is
  column-parallel (its weight rows and bias cut by the model coordinate),
  fc2 row-parallel (its weight columns cut, its bias whole). One
  all-reduce over the model group follows fc2's partial product, and fc2's
  bias is added once after it; in the backward pass fc1's input gradient
  is all-reduced over the model group. Everything else stays replicated.

Ranks are laid out as JAX's devices are (``reshape(n_data, n_model)``):
rank ``d * n_model + m`` has data coordinate ``d`` and model coordinate
``m``. State dicts stay in the unsharded layout that ``convert.py``,
``.pth`` checkpoints and JAX ``.ckpt`` imports use: :func:`full_state_dict`
gathers the fc1/fc2 shards, :func:`load_full_state_dict` cuts them.
"""

from __future__ import annotations

import weakref
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from yolo_tpu_torch.models.layers import Dropout
from yolo_tpu_torch.parallel.distributed import backend_for


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              device_type: str = "cuda") -> DeviceMesh:
    """A ("data", "model") mesh over the world's ranks.

    Defaults to pure data parallelism over every rank; ``n_model`` > 1
    carves the tensor-parallel axis for the FC head. ``n_data * n_model``
    must equal the world size. Without a process group the world is this
    process alone (a group of 1 is started). Two more groups come with the
    mesh: :func:`bn_group`, this rank's data ranks again, so that the
    synchronized BN's all-reduces never interleave with the gradient
    all-reduces on the data group; and :func:`snapshot_group`, every rank
    over gloo, for the background thread of an async DCP snapshot. (They are
    kept beside the mesh, not on it: a DTensor's mesh must stay copyable.)
    """
    if not dist.is_initialized():
        dist.init_process_group(backend_for(device_type, 1), store=dist.HashStore(),
                                world_size=1, rank=0)
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"mesh {n_data}x{n_model} != {world} devices")
    mesh = init_device_mesh(device_type, (n_data, n_model), mesh_dim_names=("data", "model"))
    bn, _ = dist.new_subgroups_by_enumeration(
        [[d * n_model + m for d in range(n_data)] for m in range(n_model)])
    _GROUPS[mesh] = (bn, dist.new_group(backend="gloo"))
    return mesh


#: The extra groups of each live mesh: (BN group, snapshot group).
_GROUPS: "weakref.WeakKeyDictionary[DeviceMesh, tuple]" = weakref.WeakKeyDictionary()


def bn_group(mesh: DeviceMesh):
    """The synchronized BN's group: this rank's data ranks (see :func:`make_mesh`)."""
    return _GROUPS[mesh][0]


def snapshot_group(mesh: DeviceMesh):
    """Every rank over gloo, for async DCP snapshots (see :func:`make_mesh`)."""
    return _GROUPS[mesh][1]


def coordinates(mesh: DeviceMesh) -> Tuple[int, int, int, int]:
    """(data coordinate, n_data, model coordinate, n_model) of this rank."""
    return (mesh.get_local_rank("data"), mesh["data"].size(),
            mesh.get_local_rank("model"), mesh["model"].size())


def batch_slice(mesh: DeviceMesh, array):
    """This rank's rows of a global batch (numpy array or tensor).

    Data coordinate ``d`` takes rows ``[d*b, (d+1)*b)``, ``b = N / n_data``:
    JAX's ``batch_sharding`` shards. The leading dim must divide by n_data;
    pad ragged batches first (``data.pad_batch``).
    """
    d, n_data, _, _ = coordinates(mesh)
    n = array.shape[0]
    if n % n_data:
        raise ValueError(f"batch of {n} rows must be divisible by the data-parallel mesh "
                         f"axis ({n_data} devices); pad ragged batches first "
                         f"(yolo_tpu_torch.data.pad_batch)")
    b = n // n_data
    return array[d * b:(d + 1) * b]


def gather(tensor: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The tensors of every rank of ``group``, concatenated along ``dim`` in
    group-rank order, on the CPU (gloo gathers CPU tensors only)."""
    local = tensor.detach().cpu().contiguous()
    n = dist.get_world_size(group)
    if n == 1:
        return local
    parts = [torch.empty_like(local) for _ in range(n)]
    dist.all_gather(parts, local, group=group)
    return torch.cat(parts, dim=dim)


def all_reduce_(tensor: torch.Tensor, group) -> torch.Tensor:
    """Sum ``tensor`` in place over ``group`` (nothing for a group of 1)."""
    if group is not None and dist.get_world_size(group) > 1:
        dist.all_reduce(tensor, group=group)
    return tensor


# --------------------------------------------------- the tensor-parallel head
class _CopyToModel(torch.autograd.Function):
    """Identity forward; the backward all-reduces the gradient over the model group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous(), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """All-reduce over the model group forward; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class ColumnParallelLinear(nn.Module):
    """fc1 cut by output rows: ``x -> x @ W[rows].T + b[rows]``.

    Holds the unsharded layer's own Parameter objects, cut in place, so an
    optimizer built over the whole model keeps stepping them, and the state
    dict keeps its names.
    """

    shard_dims = {"weight": 0, "bias": 0}

    def __init__(self, linear: nn.Linear, group, m: int, n_model: int):
        super().__init__()
        self.weight, self.bias, self.group = linear.weight, linear.bias, group
        for p in (self.weight, self.bias):
            p.data = p.data.chunk(n_model, 0)[m].clone()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(_CopyToModel.apply(x, self.group), self.weight, self.bias)


class RowParallelLinear(nn.Module):
    """fc2 cut by input columns: partial ``x @ W[:, cols].T``, all-reduced, ``+ b``."""

    shard_dims = {"weight": 1}

    def __init__(self, linear: nn.Linear, group, m: int, n_model: int):
        super().__init__()
        self.weight, self.bias, self.group = linear.weight, linear.bias, group
        self.weight.data = self.weight.data.chunk(n_model, 1)[m].clone()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _ReduceFromModel.apply(F.linear(x, self.weight), self.group) + self.bias


def _fc_stack(model: nn.Module) -> nn.Sequential:
    """The head's Flatten -> fc1 -> LeakyReLU -> Dropout -> fc2 Sequential."""
    head = model.head
    return head.fc_layers if hasattr(head, "fc_layers") else head


def shard_head(model: nn.Module, mesh: DeviceMesh) -> nn.Module:
    """Apply JAX's ``_param_spec`` to ``model``'s head in place, and give its
    Dropout this rank's block of the global mask. Returns ``model``.

    Call it before the optimizer has state and before wrapping the model in
    ``DistributedDataParallel``. ``DetectionHead`` and ``SimpleHead`` alike.
    """
    d, n_data, m, n_model = coordinates(mesh)
    fc = _fc_stack(model)
    if n_model > 1:
        if fc[1].out_features % n_model:
            raise ValueError(f"fc1's {fc[1].out_features} outputs do not divide by "
                             f"--mesh-model {n_model}")
        group = mesh.get_group("model")
        fc[1] = ColumnParallelLinear(fc[1], group, m, n_model)
        fc[4] = RowParallelLinear(fc[4], group, m, n_model)
    for module in model.modules():
        if isinstance(module, Dropout):
            module.shard = (d, n_data, m, n_model)
    return model


def sync_batch_norm(model: nn.Module, mesh: DeviceMesh) -> nn.Module:
    """Make every train-mode BN of ``model`` use the global batch's statistics
    when the data axis has more than one rank (``layers.FusedBatchNormAct``
    and ``layers.BatchNorm2d``; see their docstrings). Returns ``model``."""
    if mesh["data"].size() > 1:
        for module in model.modules():
            if isinstance(module, nn.BatchNorm2d):
                module.sync_group = bn_group(mesh)
    return model


def sharded_parameters(model: nn.Module) -> Dict[str, int]:
    """{state-dict name: the dim it is cut along} of the head's shards."""
    out = {}
    for name, module in model.named_modules():
        if isinstance(module, (ColumnParallelLinear, RowParallelLinear)):
            out.update({f"{name}.{p}": dim for p, dim in module.shard_dims.items()})
    return out


def local_shard(model: nn.Module, mesh: Optional[DeviceMesh], name: str,
                full: torch.Tensor) -> torch.Tensor:
    """This rank's block of the unsharded tensor ``full`` of parameter ``name``
    (or of its Adam moments); ``full`` itself for a replicated one."""
    dim = sharded_parameters(model).get(name)
    if mesh is None or dim is None:
        return full
    _, _, m, n_model = coordinates(mesh)
    return full.chunk(n_model, dim)[m]


def full_state_dict(model: nn.Module, mesh: Optional[DeviceMesh]) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` with the fc1/fc2 shards gathered (on the CPU)."""
    state = model.state_dict()
    if mesh is None:
        return state
    group = mesh.get_group("model")
    for name, dim in sharded_parameters(model).items():
        state[name] = gather(state[name], group, dim)
    return state


def load_full_state_dict(model: nn.Module, state: Dict[str, torch.Tensor],
                         mesh: Optional[DeviceMesh]) -> None:
    """Load an unsharded state dict, each rank taking its fc1/fc2 blocks."""
    model.load_state_dict({k: local_shard(model, mesh, k, v) for k, v in state.items()})


def _parameter_names(model: nn.Module) -> Dict[int, str]:
    return {id(p): name for name, p in model.named_parameters()}


def full_optimizer_state_dict(optimizer, model: nn.Module,
                              mesh: Optional[DeviceMesh]) -> Dict:
    """``optimizer.state_dict()`` with the shards' Adam moments gathered."""
    state = optimizer.state_dict()
    dims = sharded_parameters(model) if mesh is not None else {}
    if not dims:
        return state
    names = _parameter_names(model)
    params = [p for g in optimizer.param_groups for p in g["params"]]
    group = mesh.get_group("model")
    for index, entry in state["state"].items():
        dim = dims.get(names[id(params[index])])
        if dim is not None:  # a new dict: state_dict() shares the optimizer's own
            state["state"][index] = {k: gather(v, group, dim) if k.startswith("exp_avg")
                                     else v for k, v in entry.items()}
    return state


def shard_optimizer_state_(optimizer, model: nn.Module, mesh: Optional[DeviceMesh]) -> None:
    """Cut the unsharded Adam moments of the shards that a loaded optimizer
    state holds down to this rank's blocks."""
    if mesh is None:
        return
    names = _parameter_names(model)
    for p, entry in optimizer.state.items():
        for key in ("exp_avg", "exp_avg_sq"):
            if key in entry and entry[key].shape != p.shape:
                entry[key] = local_shard(model, mesh, names[id(p)], entry[key]).clone()

