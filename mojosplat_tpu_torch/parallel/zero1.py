"""The update of replicated parameters over a mesh: the gradients'
all-reduce, and ZeRO-1.

Counterpart of ``_zero1_rows`` and ``_zero1_apply`` in
``mojosplat_tpu.train``. The sharded training steps
(``train.train_step_sharded``, ``train.train_step_sharded_surfel``)
all-reduce every parameter's gradient over the mesh and then apply one
update on every rank: either the optimizer over the replicated
parameters, or ZeRO-1, where each rank's optimizer holds only its 1/n of
every parameter's rows (``zero1_rows``) and the updated slices are
all-gathered back into the replicas.
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.distributed as dist

from .sharding import Mesh, all_gather_parts


def zero1_rows(params: Mapping[str, torch.Tensor], mesh: Mesh) -> dict[str, torch.Tensor]:
    """This rank's ZeRO-1 shard: trainable copies of rows ``[r * N / n, (r
    + 1) * N / n)`` of every parameter, r this rank's index in the mesh of n
    ranks. Make the optimizer over them (``make_optimizer(shards)``), so
    its moments hold only those rows, and pass them to a sharded step as
    ``zero1``. Raises unless n divides N."""
    n, r = mesh.size, mesh.rank
    out = {}
    for k, v in params.items():
        if v.shape[0] % n:
            raise ValueError(
                f"zero1 needs N ({v.shape[0]}) divisible by the device count ({n})")
        m = v.shape[0] // n
        out[k] = v.detach()[r * m:(r + 1) * m].clone().requires_grad_(True)
    return out


def _zero1_apply(params, shards, optimizer, mesh: Mesh) -> None:
    """The ZeRO-1 update: copy this rank's rows of each (all-reduced)
    gradient into its shard, step the optimizer over the shards, and
    all-gather the updated shards back into the replicated parameters.
    Adam works element by element, so this is the replicated update."""
    n, r = mesh.size, mesh.rank
    for k, p in params.items():
        m = p.shape[0] // n
        shards[k].grad = p.grad[r * m:(r + 1) * m].clone()
    optimizer.step()
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(torch.cat(all_gather_parts(shards[k].detach(), mesh.group)))


def clear_grads(params, optimizer) -> None:
    for p in params.values():
        p.grad = None
    optimizer.zero_grad(set_to_none=True)


def all_reduce_grads(params, mesh: Mesh) -> None:
    """Sum every parameter's gradient over the mesh (a parameter the
    rank's render did not reach takes zeros)."""
    for p in params.values():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        dist.all_reduce(p.grad, group=mesh.group)


def replicated_update(params, optimizer, mesh: Mesh, zero1) -> None:
    """Step the replicated ``params`` from their all-reduced gradients:
    ``optimizer`` over ``params`` when ``zero1`` is None, else ZeRO-1 over
    this rank's shard ``zero1``, which ``optimizer`` holds."""
    if zero1 is None:
        optimizer.step()
    else:
        _zero1_apply(params, zero1, optimizer, mesh)
