"""Data parallelism over ``torch.distributed``: the process group, the span
math and the collectives of the data-parallel step and evaluation.

Counterpart of ``vitsom_tpu/parallel/distributed.py``. The JAX step is one
program over the global batch on a ``data`` mesh; here every rank runs the
same step on its span of every global batch and the ranks meet in
collectives, so that N ranks take the one-rank step of the global batch:

- ``maybe_initialize`` joins the group torchrun describes (``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), as the
  JAX module reads ``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES`` and
  ``JAX_PROCESS_ID``: NCCL on the card (``cuda:LOCAL_RANK``), gloo on the
  CPU. Without that environment nothing changes: one process, no group. A
  caller may also create the group itself (a one-rank NCCL group, or gloo
  on the card); the trainer takes the data-parallel path whenever a group
  exists;
- ``local_span``, ``truncate_to_multiple`` and ``local_batch_indices`` are
  the JAX package's span functions, under the same names;
- ``average_gradients`` all-reduces the gradients and divides them by the
  world size, in one flat buffer a dtype (the trainer runs it just before
  the optimizer's step); ``sync_mean`` is a mean over the ranks whose
  cotangent is averaged too (BatchNorm's statistics over the global batch);
  ``mean_value`` a mean over the ranks whose gradient is the rank's own
  (the fused SOM's loss, the JAX ``pmean``: every rank's cotangent is the
  same, and the trainer averages the gradients);
- ``all_gather_rows`` concatenates equal-sized per-rank rows in rank order
  (the sharded evaluation's outputs).

On NCCL these collectives are captured with the train step (each is a
launch on the card); a gloo collective cannot be captured, so a gloo group
trains eagerly. gloo takes CUDA tensors as well: its CUDA work copies them
through the host itself.
"""

from __future__ import annotations

import os
from typing import Iterable

import torch
import torch.distributed as dist


def maybe_initialize(device="cuda") -> bool:
    """Join the process group torchrun's environment describes (module
    docstring): NCCL when ``device`` is the card, gloo on the CPU; the card
    becomes ``cuda:LOCAL_RANK``. A no-op when a group exists already, and
    without that environment or with ``WORLD_SIZE`` 1. Returns whether a
    group exists. A failed initialisation raises."""
    if initialized():
        return True
    n = int(os.environ.get("WORLD_SIZE", "1") or "1")
    if "MASTER_ADDR" not in os.environ or n <= 1:
        return False
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.set_device(local_rank())
    dist.init_process_group("nccl" if cuda else "gloo", init_method="env://",
                            world_size=n, rank=int(os.environ["RANK"]))
    return True


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0") or "0")


def local_device(device="cuda") -> torch.device:
    """``device``, with the card made ``cuda:LOCAL_RANK`` in a group whose
    caller named no card."""
    dev = torch.device(device)
    if initialized() and dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", local_rank())
    return dev


def process_count() -> int:
    return dist.get_world_size() if initialized() else 1


def process_index() -> int:
    return dist.get_rank() if initialized() else 0


def is_primary() -> bool:
    """True on the rank that writes checkpoints, events and the protocol's
    JSON."""
    return process_index() == 0


def capturable() -> bool:
    """Whether the step's collectives can be captured in a CUDA graph: no
    group, or an NCCL group."""
    return not initialized() or dist.get_backend() == "nccl"


def barrier() -> None:
    if initialized():
        dist.barrier()


def warm_up(device) -> None:
    """One eager collective on ``device``, which creates the communicator
    before a capture needs it."""
    if initialized():
        t = torch.zeros(1, device=device)
        dist.all_reduce(t)
        if t.is_cuda:
            torch.cuda.synchronize(t.device)


# ---------------------------------------------------------------------------
# span math (the JAX package's, unit-tested against it)
# ---------------------------------------------------------------------------


def local_span(global_n: int, pidx: int, pcount: int) -> slice:
    """The contiguous row span rank ``pidx`` of ``pcount`` owns of
    ``global_n`` rows; raises unless they split evenly (truncate first)."""
    if global_n % pcount != 0:
        raise ValueError(
            f"global size {global_n} does not split evenly over {pcount} "
            "processes; truncate_to_multiple first"
        )
    per = global_n // pcount
    return slice(pidx * per, (pidx + 1) * per)


def truncate_to_multiple(n: int, pcount: int) -> int:
    """Largest n' <= n with n' % pcount == 0 (drop-last across ranks)."""
    return (n // pcount) * pcount


def local_batch_indices(global_idx, pidx: int, pcount: int):
    """A global batch's example indices cut to rank ``pidx``'s rows: every
    rank draws the same permutation and takes its span, so the ranks'
    batches concatenated in rank order are the one-rank batch."""
    return global_idx[local_span(len(global_idx), pidx, pcount)]


def local_epoch_rows(t: torch.Tensor, batch_size: int, pidx: int, pcount: int) -> torch.Tensor:
    """Rank ``pidx``'s rows of every global batch of an epoch's rows ``t``
    ([steps * batch_size, ...]), batch after batch: [steps * batch_size /
    pcount, ...]."""
    if pcount == 1:
        return t
    rows = t.view(-1, batch_size, *t.shape[1:])
    return rows[:, local_span(batch_size, pidx, pcount)].reshape(-1, *t.shape[1:])


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def all_reduce_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean of ``t`` over the ranks (a new tensor): the sum, then a
    division by the world size, exact for a power of two."""
    out = t.clone()
    dist.all_reduce(out)
    return out.div_(process_count())


class _SyncMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return all_reduce_mean(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_mean(g)


class _MeanValue(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return all_reduce_mean(x)

    @staticmethod
    def backward(ctx, g):
        return g


def sync_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the ranks, its cotangent averaged over the
    ranks too: with the gradients averaged after the backward, each rank's
    share of a statistic of the global batch gets the global gradient.
    ``x`` itself without a group."""
    return _SyncMean.apply(x) if initialized() else x


def mean_value(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the ranks, differentiated as ``x`` (module
    docstring); ``x`` itself without a group."""
    return _MeanValue.apply(x) if initialized() else x


def average_gradients(params: Iterable[torch.Tensor]) -> None:
    """Every gradient replaced by its mean over the ranks, in one flat
    all-reduce a dtype; parameters without a gradient are skipped (the
    same ones on every rank)."""
    by_dtype = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat)
        flat.div_(process_count())
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))


def average_before_step(optimizer: torch.optim.Optimizer) -> None:
    """Average the optimizer's gradients over the ranks just before each of
    its steps (a step pre-hook: inside a captured step, the all-reduce is
    captured with it)."""
    params = [p for group in optimizer.param_groups for p in group["params"]]
    optimizer.register_step_pre_hook(lambda opt, args, kwargs: average_gradients(params))


def all_gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) concatenated along the first axis
    in rank order; ``t`` itself without a group."""
    if not initialized():
        return t
    parts = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(parts, t.contiguous())
    return torch.cat(parts)
