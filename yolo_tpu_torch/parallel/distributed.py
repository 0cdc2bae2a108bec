"""Process-group start-up for one process per device (JAX ``distributed.py:17-37``).

JAX starts one process per host with ``jax.distributed.initialize()`` and
sees every chip of its host; torch starts one process per device (``torchrun
--nproc-per-node N``), and each joins a ``torch.distributed`` process group.
Without a world (``WORLD_SIZE`` unset or 1, no arguments) this is a no-op, as
JAX's is on a single host.

Backend: on CUDA, NCCL for CUDA tensors and gloo for CPU tensors
(``"cpu:gloo,cuda:nccl"``: the gathers of metrics, detections and
checkpoint shards go through CPU tensors); on the CPU, gloo. NCCL refuses
two ranks on one device, so where more ranks than cards share a host
(``LOCAL_WORLD_SIZE > torch.cuda.device_count()``) the group is gloo for
every tensor, and this is printed: that is how two ranks share one card.
A rank on CUDA uses ``cuda:LOCAL_RANK % device_count``; it never falls
back to the CPU.

:func:`run_on_mesh` is the CLIs' start-up: join the group, make the mesh,
check the batch against the data axis, run, leave the group.
"""

from __future__ import annotations

import contextlib
import os
from typing import Callable, Optional

import torch
import torch.distributed as dist


def backend_for(device_type: str, local_world: int) -> str:
    """The process-group backend for ``local_world`` ranks of this host."""
    if device_type == "cpu":
        return "gloo"
    if local_world > torch.cuda.device_count():
        print(f"initialize_distributed: {local_world} ranks share "
              f"{torch.cuda.device_count()} CUDA device(s) on this host; NCCL needs one "
              f"device a rank, so the backend is gloo", flush=True)
        return "gloo"
    return "cpu:gloo,cuda:nccl"


def rank_device(device: torch.device | str) -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK % device_count`` for CUDA, else ``device``."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("initialize_distributed: CUDA is not available (pass --device cpu)")
    local_rank = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized()
                                    else 0))
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def initialize_distributed(
    device: torch.device | str = "cuda",
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
) -> torch.device:
    """Join the process group when running more than one rank; returns this rank's device.

    Honors torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``) when the arguments
    are omitted; ``init_method`` (``tcp://host:port`` or ``file://path``),
    ``world_size`` and ``rank`` set the group up explicitly. Safe to call
    unconditionally from the CLIs: with no world it returns ``device`` as
    it is.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("initialize_distributed: CUDA is not available (pass --device cpu)")
    if not dist.is_initialized():
        world = world_size if world_size is not None else int(os.environ.get("WORLD_SIZE", 1))
        if world > 1 or init_method is not None:
            rank = rank if rank is not None else int(os.environ.get("RANK", 0))
            local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
            if device.type == "cuda":
                os.environ.setdefault("LOCAL_RANK", str(rank % local_world))
            dist.init_process_group(backend_for(device.type, local_world),
                                    init_method=init_method or "env://",
                                    world_size=world, rank=rank)
    if not dist.is_initialized():
        return device
    device = rank_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return device


def check_batch(batch_size: int, n_data: int) -> None:
    """JAX train.py's check: the global batch divides by the data axis."""
    if batch_size % n_data != 0:
        raise SystemExit(
            f"--batch-size {batch_size} must be divisible by the data-parallel mesh axis "
            f"({n_data} devices); pass e.g. --batch-size {(batch_size // n_data + 1) * n_data}"
            f" or --mesh-data <divisor of {batch_size}>")


def setup_mesh(device: torch.device | str, n_data: Optional[int], n_model: int,
               batch_size: int):
    """(mesh or None, this rank's device): the process group joined when
    torchrun started several ranks, the mesh made when there is more than
    one rank or a mesh axis above 1 (``n_data=None``: the world over
    ``n_model``). A mesh that does not fill the world, or a batch that does
    not divide by the data axis, exits with JAX's message."""
    from yolo_tpu_torch.parallel.mesh import make_mesh

    if n_data:
        check_batch(batch_size, n_data)
    device = initialize_distributed(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world == 1 and (n_data or 1) * n_model == 1:
        return None, device
    try:
        mesh = make_mesh(n_data, n_model, device.type)
    except ValueError as exc:
        raise SystemExit(f"--mesh-data {n_data} x --mesh-model {n_model}: {exc} "
                         f"(torchrun --nproc-per-node sets the world)")
    check_batch(batch_size, mesh["data"].size())
    return mesh, device


def run_on_mesh(body: Callable, device: torch.device | str, n_data: Optional[int],
                n_model: int, batch_size: int):
    """``body(mesh, device, first_rank)`` on this rank (:func:`setup_mesh`),
    with the standard output of every rank but the first discarded, and the
    process group left again if this call joined it."""
    joined = dist.is_initialized()
    try:
        mesh, device = setup_mesh(device, n_data, n_model, batch_size)
        first = not dist.is_initialized() or dist.get_rank() == 0
        with contextlib.ExitStack() as stack:
            if not first:
                stack.enter_context(contextlib.redirect_stdout(
                    stack.enter_context(open(os.devnull, "w"))))
            return body(mesh, device, first)
    finally:
        if dist.is_initialized() and not joined:
            dist.destroy_process_group()
