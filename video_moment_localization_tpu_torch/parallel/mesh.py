"""Data parallelism over ``torch.distributed``: one process per device.

Counterpart of ``video_moment_localization_tpu/parallel/mesh.py``, whose 1-D
``data`` mesh shards every batch along its first axis and replicates the
parameters. Here each rank is a process with one explicit device: it loads
its contiguous shard of every global batch (``BatchLoader(shard_id=rank(),
num_shards=world_size())``), holds a replica of the model, and the train
step sums the gradients across ranks (`all_reduce_gradients`). The backend
is NCCL for a CUDA device and gloo for the CPU, unless the caller names one:
a NCCL init that fails raises, it is never retried on gloo. Gloo also
reduces CUDA tensors, through the host: that is how two ranks share one card,
which NCCL refuses.

A launcher (``torchrun``) sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT``; `initialize_distributed` reads them when
its arguments are None. `spawn` starts N ranks itself, with a ``file://``
rendezvous in a fresh temporary directory (no port is taken).

Outside a process group every function here acts as the one rank of a
group of one: `rank` is 0, `world_size` 1, and the collectives return their
input.

The 2-D (data x seq) grid of sequence parallelism (`make_grid_2d`, the JAX
package's ``arrange_2d``): ``world = nd * seq`` ranks, data-major, so that a
seq group is ``seq`` contiguous ranks, kept on one node.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
import time
from typing import Any, Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

Device = Union[str, torch.device]
LAUNCHER_VARIABLES = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def default_backend(device: Device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def spawn_backend(devices: Sequence[Device]) -> str:
    """The backend of ranks on ``devices``: NCCL when each rank has a card of
    its own, gloo on the CPU or when ranks share a card (NCCL refuses two
    ranks on one card; gloo moves CUDA tensors through the host)."""
    devices = [torch.device(d) for d in devices]
    own_cards = all(d.type == "cuda" for d in devices) and len(set(devices)) == len(devices)
    return "nccl" if own_cards else "gloo"


def initialize_distributed(backend: Optional[str] = None, rank: Optional[int] = None,
                           world_size: Optional[int] = None,
                           init_method: Optional[str] = None, device: Device = "cuda") -> bool:
    """Join the default process group; returns whether the run is
    multi-process. A second call does nothing but return that.

    ``rank`` / ``world_size`` default to the launcher's ``RANK`` /
    ``WORLD_SIZE``, ``init_method`` to ``env://`` (``MASTER_ADDR``,
    ``MASTER_PORT``); a missing variable raises ValueError. ``backend``
    defaults to `default_backend` of ``device``, the device of this rank
    (`device_for_rank`), which becomes the current CUDA device. Right after
    the init one small all-reduce runs on every rank, while the ranks are
    still together from the init's rendezvous: the first collective must not
    wait behind the first step's work (the JAX package's
    ``warmup_collectives``)."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    given = {"RANK": rank, "WORLD_SIZE": world_size, "MASTER_ADDR": init_method,
             "MASTER_PORT": init_method}
    missing = [v for v in LAUNCHER_VARIABLES if given[v] is None and v not in env]
    if missing:
        raise ValueError(f"initialize_distributed: {', '.join(missing)} not set: start the "
                         f"ranks with a launcher (torchrun) or pass rank, world_size and "
                         f"init_method")
    init_method = init_method or "env://"
    rank = int(env["RANK"]) if rank is None else rank
    world_size = int(env["WORLD_SIZE"]) if world_size is None else world_size
    device = device_for_rank(device, rank)
    backend = backend or default_backend(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size)
    warm = torch.ones(1, device=device if backend == "nccl" else "cpu")
    dist.all_reduce(warm)
    if float(warm) != world_size:
        raise RuntimeError(f"initialize_distributed: the first all-reduce gave {float(warm)}, "
                           f"want {world_size}")
    return world_size > 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def default_group():
    """The default process group, or None outside one."""
    return dist.group.WORLD if dist.is_initialized() else None


def device_for_rank(device: Device = "cuda", rank_: Optional[int] = None) -> torch.device:
    """This rank's device: ``device`` as given when it names an index or the
    CPU, else ``cuda:LOCAL_RANK`` (the launcher's variable; the rank where
    there is none)."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    local = os.environ.get("LOCAL_RANK")
    index = int(local) if local is not None else (rank() if rank_ is None else rank_)
    return torch.device("cuda", index)


def put_batch(batch: Dict[str, Any], device: Device) -> Dict[str, torch.Tensor]:
    """This rank's host shard (the NumPy arrays of a `BatchLoader` batch) as
    tensors on its device: through pinned host memory and a non-blocking
    copy on a card. The batch's other entries (host metadata) stay behind."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            t = torch.from_numpy(v)
            if device.type == "cuda":
                t = t.pin_memory().to(device, non_blocking=True)
            out[k] = t
    return out


def _flat_apply(tensors: Sequence[torch.Tensor], collective: Callable[[torch.Tensor], Any]
                ) -> None:
    """``collective`` on one flat buffer of the tensors (one launch, not one
    per tensor), then the buffer's values back into the tensors."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    collective(flat)
    parts = torch.split(flat, [t.numel() for t in tensors])
    torch._foreach_copy_(list(tensors), [p.view_as(t) for p, t in zip(parts, tensors)])


def put_replicated(model: torch.nn.Module, group=None) -> torch.nn.Module:
    """Every parameter and buffer of ``model`` set to rank 0's, in one
    broadcast a dtype: the replicas start equal, as the JAX package's
    replicated parameters are one array. No-op outside a group."""
    group = group if group is not None else default_group()
    if group is None or dist.get_world_size(group) == 1:
        return model
    src = dist.get_global_rank(group, 0)
    tensors = [t.data for t in list(model.parameters()) + list(model.buffers())]
    with torch.no_grad():
        for dtype in sorted({t.dtype for t in tensors}, key=str):
            _flat_apply([t for t in tensors if t.dtype == dtype],
                        lambda flat: dist.broadcast(flat, src=src, group=group))
    return model


def all_reduce_gradients(named_parameters, group) -> None:
    """Sum every parameter's gradient across the ranks of ``group``, in one
    all-reduce of a flat buffer, in place. Every parameter must have a
    gradient: each rank reduces the same buffer, so a parameter that one
    route leaves without one is an error here (DDP's
    ``find_unused_parameters=False``), not a silent skip."""
    params = []
    for name, p in named_parameters:
        if p.grad is None:
            raise RuntimeError(f"all_reduce_gradients: parameter {name} has no gradient; every "
                               f"rank must reduce every parameter")
        params.append(p.grad)
    _flat_apply(params, lambda flat: dist.all_reduce(flat, group=group))


def all_reduce_sums(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """``tensor`` summed over the ranks, in place (one collective: an
    epoch's loss sums, valid counts and recall counts together). Returns it;
    outside a group, unchanged."""
    group = group if group is not None else default_group()
    if group is not None and dist.get_world_size(group) > 1:
        dist.all_reduce(tensor, group=group)
    return tensor


def barrier(group=None) -> None:
    """Wait for every rank; no-op outside a group."""
    group = group if group is not None else default_group()
    if group is not None and dist.get_world_size(group) > 1:
        dist.barrier(group=group)


@dataclasses.dataclass(frozen=True)
class Grid2D:
    """This rank's place on the (data x seq) grid and the groups it is in:
    data index ``data`` of ``nd`` and seq index ``seq_index`` of ``seq``;
    ``seq_group`` the seq ranks of its data shard (the sequence-parallel
    collectives), ``data_group`` the ranks of its seq index (an epoch's sums
    over the data shards), ``world_group`` every rank (the gradients)."""

    nd: int
    seq: int
    data: int
    seq_index: int
    seq_group: Any
    data_group: Any
    world_group: Any


def make_grid_2d(seq: int, group=None) -> Grid2D:
    """The (data x seq) grid over the ranks of ``group`` (default: the
    default group), as ``arrange_2d`` reshapes the devices to (total // seq,
    seq): rank r at data index r // seq, seq index r % seq. Every rank must
    call this together: each makes every seq group, then every data group,
    with ``dist.new_group`` in the same order, and warms the two it is in
    with one small all-reduce while the ranks are still together. Raises
    ValueError when ``seq`` does not divide the world, or does not divide
    ``LOCAL_WORLD_SIZE`` where a launcher set it (a seq group across nodes).
    Outside a process group (a world of one, ``seq`` 1) every group is
    None."""
    group = group if group is not None else default_group()
    world = 1 if group is None else dist.get_world_size(group)
    if world % seq:
        raise ValueError(f"device count ({world}) not divisible by seq ({seq})")
    local = os.environ.get("LOCAL_WORLD_SIZE")
    if seq > 1 and local is not None and int(local) % seq:
        raise ValueError(
            f"seq axis would span hosts ({local} ranks per node): sequence-parallel "
            f"collectives must stay within a node. Use seq_devices that divides the per-host "
            f"device count ({local} per host here).")
    nd = world // seq
    if group is None:
        return Grid2D(nd, seq, 0, 0, None, None, None)
    r = dist.get_rank(group)
    ranks = [dist.get_global_rank(group, i) for i in range(world)]
    seq_groups = [dist.new_group(ranks[d * seq:(d + 1) * seq]) for d in range(nd)]
    data_groups = [dist.new_group(ranks[s::seq]) for s in range(seq)]
    grid = Grid2D(nd, seq, r // seq, r % seq, seq_groups[r // seq], data_groups[r % seq], group)
    for g in (grid.seq_group, grid.data_group):
        warm = torch.ones(1)
        if dist.get_backend(g) == "nccl":
            warm = warm.to(torch.device("cuda", torch.cuda.current_device()))
        dist.all_reduce(warm, group=g)
        if float(warm) != dist.get_world_size(g):
            raise RuntimeError(f"make_grid_2d: a group's first all-reduce gave {float(warm)}")
    return grid


# --------------------------------------------------------------------- #
def _rank_main(index: int, fn: Callable, nprocs: int, devices: Sequence[str], backend: str,
               init_method: str, threads: int, args: tuple) -> None:
    """A spawned rank: join the group, run ``fn(rank, *args)``, leave. A CPU
    rank takes ``threads`` intra-op threads: its share of the parent's, not
    all of the host's cores."""
    device = torch.device(devices[index])
    if device.type == "cpu":
        torch.set_num_threads(threads)
    initialize_distributed(backend, index, nprocs, init_method, device=device)
    try:
        fn(index, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, nprocs: int, devices: Sequence[Device], backend: Optional[str] = None,
          args: tuple = (), timeout_s: Optional[float] = None) -> None:
    """Run ``fn(rank, *args)`` in ``nprocs`` new processes (the ``spawn``
    start method), rank r on ``devices[r]``, all in one process group
    (``backend``: `spawn_backend` of the devices unless named) met
    through a ``file://`` store in a fresh temporary directory.

    Returns when every rank has returned. The first rank that raises or dies
    makes this raise (`torch.multiprocessing.ProcessRaisedException`, with
    the rank's traceback, or `ProcessExitedException`) after the other ranks
    are terminated; past ``timeout_s`` seconds every rank is terminated and
    TimeoutError raised. ``fn`` and ``args`` must pickle: ``fn`` a function
    at a module's top level."""
    import torch.multiprocessing as mp

    if len(devices) != nprocs:
        raise ValueError(f"spawn: {len(devices)} devices for {nprocs} ranks")
    devices = [str(torch.device(d)) for d in devices]
    backend = backend or spawn_backend(devices)
    store = tempfile.mkdtemp(prefix="vml-rendezvous-")
    try:
        ctx = mp.start_processes(
            _rank_main, args=(fn, nprocs, devices, backend,
                              "file://" + os.path.join(store, "store"),
                              max(1, torch.get_num_threads() // nprocs), args),
            nprocs=nprocs, join=False, start_method="spawn")
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        while not ctx.join(timeout=0.5):
            if deadline is not None and time.monotonic() > deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.terminate()
                for p in ctx.processes:
                    p.join(10)
                    if p.is_alive():
                        p.kill()
                raise TimeoutError(f"spawn: ranks still running after {timeout_s} s")
    finally:
        shutil.rmtree(store, ignore_errors=True)
