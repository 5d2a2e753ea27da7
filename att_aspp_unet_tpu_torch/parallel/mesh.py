"""Data parallelism over devices, the counterpart of
``att_aspp_unet_tpu/parallel/mesh.py``.

The JAX package shards one global array over the ``data`` axis of a mesh and
lets GSPMD insert the collectives, so a run on D devices computes the
one-device run's function up to the order of its f32 sums.  The port keeps
that property with explicit code, in two forms:

- serving, in one process: the frames of a sweep split into D contiguous
  shards cut at the per-shard work's micro-batch boundaries, the layout of
  the JAX package's ``stage_frames`` without its zero padding (XLA needs
  equal static shards; eager PyTorch does not, and unpadded shards run
  exactly the one-device run's micro-batches, so a card gives bitwise the
  one-device result); each device runs the per-frame work of its shard, and
  what the rest of the path needs is gathered onto the primary device
  (:func:`split_frames`, :func:`gather`);
- training, one process per device (``torch.distributed``): every rank holds
  the parameters and its contiguous rows of each global batch
  (:func:`shard_rows`).  BatchNorm's statistics and the losses' numerators and
  denominators are summed over the ranks by :func:`all_reduce_sum`, whose
  backward sums the gradients flowing back, and the parameter gradients are
  summed once per step (:func:`all_reduce_grads`).  Random draws
  (augmentation, Dropout) are made for the global batch on every rank, each
  keeping its rows, so a D-rank run draws what the one-process run draws.

A ``model`` axis (``MeshConfig.model_parallelism``) replicates the model in
the JAX package; here it leaves one data device per group of that many.
"""

from __future__ import annotations

import contextlib
import datetime
import socket
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..config import MeshConfig
from ..device import resolve_device

Devices = Sequence["torch.device | str"]


# ---------------- the data axis ----------------

def visible_devices() -> List[torch.device]:
    """Every visible card; raises when there is none (no CPU fallback)."""
    resolve_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def resolve_devices(devices: Devices) -> List[torch.device]:
    """Each entry as a ``torch.device`` with its index; a card that is not
    there raises.  A card may be listed more than once: its shards then
    share it."""
    out = []
    for d in devices:
        dev = resolve_device(d)
        if dev.type == "cuda":
            idx = torch.cuda.current_device() if dev.index is None \
                else dev.index
            if idx >= torch.cuda.device_count():
                raise ValueError(f"device {d!r}: only "
                                 f"{torch.cuda.device_count()} card(s) are "
                                 "visible")
            dev = torch.device("cuda", idx)
        out.append(dev)
    if not out:
        raise ValueError("devices is empty")
    return out


def make_mesh(cfg: MeshConfig = MeshConfig(),
              devices: Optional[Devices] = None) -> List[torch.device]:
    """The data axis over ``devices`` (default: every visible card): one
    device of each group of ``model_parallelism``."""
    devs = resolve_devices(devices) if devices is not None \
        else visible_devices()
    mp = max(1, cfg.model_parallelism)
    if len(devs) % mp:
        raise ValueError(f"{len(devs)} devices not divisible by "
                         f"model_parallelism={mp}")
    return devs[::mp]


def make_mesh_for_batch(cfg: MeshConfig, batch_size: int,
                        devices: Optional[Devices] = None
                        ) -> List[torch.device]:
    """The data axis whose size divides ``batch_size``: the largest count of
    at most (devices / ``model_parallelism``) that does (batch 4 on 8 cards
    takes 4)."""
    devs = resolve_devices(devices) if devices is not None \
        else visible_devices()
    mp = max(1, cfg.model_parallelism)
    avail = len(devs) // mp
    data = max(d for d in range(1, avail + 1) if batch_size % d == 0)
    return make_mesh(cfg, devs[: data * mp])


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def split_frames(frames, devices: Sequence[torch.device], align: int = 1
                 ) -> List[torch.Tensor]:
    """An (N, ...) array or tensor as contiguous shards, shard d on
    ``devices[d]``: rows [d p, (d+1) p) with p = ceil(N / (D align)) align,
    the layout of JAX's ``stage_frames`` (``batch_sharding`` of the frame axis
    padded to a multiple of D align) without its padding rows, so the last
    shards are shorter, and empty ones are left out.  With ``align`` the
    micro-batch of the per-shard work, every shard's micro-batches are the
    one-device run's.  Only a shard's own frames are copied to its device."""
    D = len(devices)
    per = pad_to_multiple(int(frames.shape[0]), D * align) // D
    shards = []
    for d, dev in enumerate(devices):
        part = frames[d * per:(d + 1) * per]
        if part.shape[0] == 0:
            break
        if not isinstance(part, torch.Tensor):
            part = torch.from_numpy(np.ascontiguousarray(part))
        shards.append(part.to(dev))
    return shards


def gather(shards: Sequence[torch.Tensor], device: torch.device
           ) -> torch.Tensor:
    """The shards' concatenation on ``device`` (one shard: itself, moved)."""
    if len(shards) == 1:
        return shards[0].to(device)
    return torch.cat([s.to(device) for s in shards])


# ---------------- the process group (training) ----------------

_local = False


@contextlib.contextmanager
def local():
    """Within the block this process reduces nothing: a batch that every
    rank holds whole (the ragged last eval batch) gives the one-process
    numbers on each."""
    global _local
    prev, _local = _local, True
    try:
        yield
    finally:
        _local = prev


def group_size() -> int:
    """Ranks that share the reductions: the default group's size, 1 without
    one or inside :func:`local`."""
    if _local or not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size()


def group_rank() -> int:
    return 0 if group_size() == 1 else dist.get_rank()


def is_primary() -> bool:
    """Whether this process writes the run's files: rank 0, or the only
    process."""
    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


def shard_rows(x):
    """This rank's contiguous rows of a global batch (array or tensor),
    ``len(x) / group_size()`` of them; the whole batch without a group."""
    world = group_size()
    if world == 1:
        return x
    n = int(x.shape[0])
    if n % world:
        raise ValueError(f"a batch of {n} does not split over {world} ranks")
    k = n // world
    r = group_rank()
    return x[r * k:(r + 1) * k]


class _AllReduceSum(torch.autograd.Function):
    """SUM over the ranks; the backward sums the incoming gradients the same
    way, so each rank's backward yields its share of the gradient of the
    sum of every rank's (equal) loss."""

    @staticmethod
    def forward(ctx, t):
        t = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
        return t

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, op=dist.ReduceOp.SUM)
        return g


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks, differentiable; ``t`` itself without a
    group."""
    return t if group_size() == 1 else _AllReduceSum.apply(t)


@torch.no_grad()
def all_reduce_grads(grads: List[torch.Tensor]) -> List[torch.Tensor]:
    """The global batch's gradients from each rank's: one flattened buffer,
    summed over the ranks and divided by their count.  Every rank computes
    the same global loss, and :func:`all_reduce_sum`'s backward makes each
    rank's gradients its share of (ranks x loss)'s, so their sum over the
    count is the loss's own."""
    world = group_size()
    if world == 1:
        return grads
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    flat.div_(world)
    out, at = [], 0
    for g in grads:
        out.append(flat[at:at + g.numel()].view_as(g))
        at += g.numel()
    return out


@torch.no_grad()
def broadcast_from_primary(t: torch.Tensor) -> torch.Tensor:
    """Rank 0's ``t`` on every rank (in place), so that decisions taken from
    it (best checkpoint, early stop) agree."""
    if group_size() > 1:
        dist.broadcast(t, src=0)
    return t


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def backend_for(devices: Sequence[torch.device]) -> str:
    """NCCL over distinct cards; gloo on the CPU, or where a card is listed
    twice (NCCL refuses two ranks on one card)."""
    cards = [d for d in devices if d.type == "cuda"]
    if len(cards) == len(devices) and len(set(cards)) == len(cards):
        return "nccl"
    return "gloo"


def init_process_group(rank: int, world: int, backend: str, port: int,
                       timeout_s: float = 600.0) -> None:
    """Join the ``world``-rank default group at ``tcp://127.0.0.1:port``;
    raises if the rendezvous or the backend fails."""
    dist.init_process_group(
        backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout_s))


def _rank_main(rank: int, fn: Callable, devices: List[torch.device],
               backend: str, port: int, args: tuple) -> None:
    dev = devices[rank]
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    init_process_group(rank, len(devices), backend, port)
    try:
        fn(rank, dev, *args)
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, devices: Sequence[torch.device], *args) -> None:
    """Run ``fn(rank, device, *args)`` in one spawned process per entry of
    ``devices``, joined in one process group (:func:`backend_for`); returns
    when all have finished, raises if any failed (the others are stopped).
    ``fn`` and ``args`` are pickled: ``fn`` must be importable."""
    import torch.multiprocessing as tmp

    devices = resolve_devices(devices)
    tmp.spawn(_rank_main, args=(fn, devices, backend_for(devices),
                                free_port(), args),
              nprocs=len(devices), join=True)
