"""The data-parallel layout: one axis, ``data``, over the ranks.

Counterpart of ``vitsom_tpu/parallel/mesh.py``: the JAX trainer builds a
1-D ``data`` mesh of ``train.mesh_shape[0]`` devices (all of them when
unset), replicates the parameters and shards each batch on it. Here the
axis is the process group: each rank holds the whole model and runs its
span of every global batch (``parallel/distributed.py``). ``train.
mesh_shape`` is honoured or refused: ``[n]`` must name the world size.
"""

from __future__ import annotations

from vitsom_tpu_torch.config import Config
from vitsom_tpu_torch.parallel import distributed as dist_lib

DATA_AXIS = "data"


def data_parallel_size(cfg: Config) -> int:
    """The ranks the config's step runs over: the world size, checked
    against ``train.mesh_shape`` and against the batch, which must split
    evenly over them (as the JAX trainer's ``batch_size % n_dev``)."""
    n = dist_lib.process_count()
    shape = cfg.train.mesh_shape
    if shape is not None and tuple(shape) != (n,):
        raise ValueError(
            f"train.mesh_shape {list(shape)} asks for a {DATA_AXIS} axis other than the "
            f"{n} rank(s) of this run: launch {shape[0]} processes (torchrun "
            f"--nproc_per_node {shape[0]}) or drop the key")
    if cfg.batch_size % n != 0:
        raise ValueError(
            f"batch_size {cfg.batch_size} must divide evenly across the "
            f"{n}-rank data-parallel mesh")
    return n


class DataSpan:
    """A data module's place on the ``data`` axis: rank ``rank`` of
    ``world`` takes ``batch`` = ``batch_size / world`` rows of every global
    batch (``epoch_rows``) and, in the sharded evaluation, its span of a
    split truncated to a multiple of ``world`` (``eval_span``). One rank
    (the default) takes everything."""

    rank = 0
    world = 1

    def shard(self, rank: int, world: int) -> None:
        """Place the module at ``rank`` of ``world``, before its first epoch
        buffer."""
        self.rank, self.world = rank, world

    @property
    def batch(self) -> int:
        """The rows of each global batch this rank trains on."""
        return self.cfg.batch_size // self.world

    def epoch_rows(self, t):
        """This rank's rows of every global batch of an epoch's rows ``t``."""
        return dist_lib.local_epoch_rows(t, self.cfg.batch_size, self.rank, self.world)

    def eval_span(self, n: int) -> slice:
        """This rank's rows of an ``n``-row split in the sharded evaluation,
        the JAX package's ``_local_eval_span``: the split truncated to a
        multiple of the world size, then its even span."""
        return dist_lib.local_span(dist_lib.truncate_to_multiple(n, self.world), self.rank,
                                   self.world)
