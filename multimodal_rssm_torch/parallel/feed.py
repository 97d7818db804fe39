"""A rank's local batch block against the global batch.

Port of the JAX package's ``parallel/feed.py``.  There each host gives its
[L, B_local, ...] block and ``global_batch_from_local`` assembles global
arrays sharded over the data axis for one controller.  In the port each
rank steps on its block itself, so the step never assembles the global
batch: every feed gathers only its rows of the shared index matrix
(``data/buffer.py``, ``data/device_buffer.py``; ``mesh.shard_batch`` cuts
them from a global batch), and ``global_batch_from_local`` is the oracle
that puts the blocks of every rank back together (``all_gather``: on the
CPU's gloo, or NCCL; gloo has no ``all_gather`` for CUDA tensors).
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from multimodal_rssm_torch.parallel.mesh import DataParallel


def global_batch_from_local(local_batch: Any, dp: DataParallel,
                            train: bool = True):
    """The global [L, B, ...] batch whose blocks the ranks hold: every
    rank's block gathered and each row put back in its place."""
    shard = dp.train if train else dp.eval
    size = shard.size

    def assemble(x: torch.Tensor) -> torch.Tensor:
        blocks = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(blocks, x.contiguous(), group=dp.group)
        out = torch.empty((x.shape[0], shard.batch_size, *x.shape[2:]),
                          dtype=x.dtype, device=x.device)
        for rank, block in enumerate(blocks):
            rows = shard._replace(rank=rank).rows
            out[:, torch.as_tensor(rows, device=x.device)] = block
        return out

    observations, *rest = local_batch
    return ({k: assemble(v) for k, v in observations.items()},
            *(assemble(x) for x in rest))
