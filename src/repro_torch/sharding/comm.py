"""The collectives of the sharded decode path.  In the reference GSPMD
inserts them; here they are explicit, on the process groups of a
``launch.mesh.Mesh``.

  * ``row_sum``      — a row-parallel product (attention's ``wo``, the
                       MLP's ``w2``, the BPD heads' ``w2``, RWKV-6's
                       ``tm/wo`` and ``cm/wv``, Mamba's ``x_proj`` and
                       ``out_proj``): each rank's partial product summed
                       over ``model``; ``partial`` / ``partial_sum`` are
                       its halves, for the MoE MLP's routed experts and
                       shared expert summed in one ``all_reduce``;
  * ``model_sum``    — the ``model``-axis sum (also the vocab-parallel
                       embedding's rows, one non-zero term each);
  * ``model_gather`` — a vocab-sharded last dimension put back together;
  * ``merge_top_t``  — per-shard top-T values and ids merged into the
                       whole vocabulary's top-T;
  * ``data_gather``  — batch rows sharded over the batch axes (pod×data,
                       or ``data``) put back together: also the serving
                       engine's gather of a group's slot status and rows;
  * ``any_row``      — a flag of this rank's rows or-ed over the batch
                       axes (the engine window's mesh-wide ``go``);
  * ``all_finished`` — the world-wide "every row is done" flag that keeps
                       every rank's decode loop in step;
  * ``broadcast_plan`` — rank 0's host plan to every rank, over the gloo
                       control group (the serving engine's ticks);
  * ``pod_gather``   — the prefill→decode handoff: each pod's rows of a
                       prefill packet to every rank, one ``all_gather`` of
                       their bytes over ``pod``.

Each is the identity on a 1-sized axis.  Sums are ``all_reduce`` in fp32
(float64 stays float64), integer ones in int64.  A row-parallel partial
product of 16-bit inputs is formed in fp32 (``torch.mm(..., out_dtype=)``
on the card) and rounded to the compute dtype once, after the sum, as one
device's product accumulates in fp32 and rounds once.  Gathers are
``all_gather_into_tensor``, which NCCL and gloo both have, gloo on CUDA
tensors as on the CPU: they move each rank's slice in its own dtype and do
no arithmetic.  ``CALLS`` counts the collectives issued, by kind.
"""
from __future__ import annotations

import collections
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.sharding.policy import batch_axes, batch_shard, prefill_axes

CALLS: collections.Counter = collections.Counter()   # kind -> collectives

# all_gather_single is all_gather_into_tensor's newer name
all_gather_into_tensor = (getattr(dist, "all_gather_single", None)
                          or dist.all_gather_into_tensor)


def cut(node, leaf: str):
    """The dim of ``node[leaf]`` cut over the ``model`` axis, or None for a
    whole leaf: what a sharded ``models.model.ParamTree`` records."""
    return getattr(node, "shard_dims", {}).get(leaf)


def _reduce(x: torch.Tensor, mesh, axis: str, op=dist.ReduceOp.SUM):
    """``x`` all-reduced in place over ``mesh``'s ``axis`` group."""
    dist.all_reduce(x, op=op, group=mesh.groups[axis])
    CALLS["all_reduce"] += 1
    return x


def _wide(x: torch.Tensor) -> torch.dtype:
    if x.dtype == torch.float64:
        return x.dtype
    return torch.float32 if x.is_floating_point() else torch.int64


def _gather0(mesh, axis: str, x: torch.Tensor) -> torch.Tensor:
    """(...) on each ``axis`` rank -> (n, ...), rank i's ``x`` at [i]."""
    group = mesh.groups[axis]
    n = dist.get_world_size(group)
    out = torch.empty((n * x.numel(),), dtype=x.dtype, device=x.device)
    all_gather_into_tensor(out, x.contiguous().reshape(-1), group=group)
    CALLS["all_gather"] += 1
    return out.reshape(n, *x.shape)


def model_sum(mesh, x: torch.Tensor) -> torch.Tensor:
    """Sum of every ``model`` rank's ``x``, in fp32, in ``x``'s dtype."""
    if mesh.shape["model"] == 1:
        return x
    return _reduce(x.to(_wide(x), copy=True), mesh, "model").to(x.dtype)


def partial(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` ((N, n) @ (n, d), or batched (k, N, n) @ (k, n, d)), ``w``
    read in ``x``'s dtype, with an fp32 result: 16-bit inputs are
    multiplied with fp32 accumulation and not rounded (on the card
    ``out_dtype``; on the CPU widened first).  A rank's partial product of
    a row-parallel weight, before its ``model``-axis sum."""
    w = w.to(x.dtype)
    if x.dtype not in (torch.bfloat16, torch.float16):
        return x @ w
    if not x.is_cuda:
        return x.float() @ w.float()
    mm = torch.mm if x.dim() == 2 else torch.bmm
    return mm(x, w, out_dtype=torch.float32)


def partial_sum(mesh, part: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Every ``model`` rank's fp32 ``part`` summed in fp32 (in place, one
    ``all_reduce``), rounded once to ``dtype``."""
    if mesh.shape["model"] > 1:
        _reduce(part, mesh, "model")
    return part.to(dtype)


def row_sum(mesh, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` where the inner dim of ``w`` (its rows) is cut over the
    ``model`` axis and ``x`` holds this rank's matching columns: (N, n) @
    (n, d) -> (N, d), or (k, N, n) @ (k, n, d) -> (k, N, d).  Each rank's
    partial product in fp32, summed in fp32, rounded once to ``x``'s
    dtype."""
    return partial_sum(mesh, partial(x, w), x.dtype)


def model_gather(mesh, x: torch.Tensor) -> torch.Tensor:
    """(..., n) on each ``model`` rank -> (..., M·n), rank m's ``x`` at
    lanes [m·n, (m+1)·n)."""
    m = mesh.shape["model"]
    if m == 1:
        return x
    return _gather0(mesh, "model", x).movedim(0, -2).reshape(
        *x.shape[:-1], m * x.shape[-1])


def merge_top_t(mesh, vals: torch.Tensor, ids: torch.Tensor, top_t: int):
    """Each ``model`` rank's (N, T) fp32 top-T ``vals`` and int32 global
    ``ids`` -> the (N, top_t) top-T of their union, ordered by (value desc,
    id asc): the tie rule of the fused-heads kernel and of ``lax.top_k``, so
    the merged ids are those of one launch over the whole vocabulary.  One
    gather carries both, the ids as the bits of fp32 lanes (a gather copies
    bits)."""
    t = vals.shape[-1]
    both = model_gather(mesh, torch.cat(
        [vals.float(), ids.to(torch.int32).view(torch.float32)], -1))
    both = both.reshape(*both.shape[:-1], -1, 2, t)
    vals = both[..., 0, :].flatten(-2)
    ids = both[..., 1, :].flatten(-2).contiguous().view(torch.int32)
    by_id = torch.argsort(ids, dim=-1, stable=True)
    vals, ids = vals.gather(-1, by_id), ids.gather(-1, by_id)
    order = torch.argsort(vals, dim=-1, descending=True, stable=True)[..., :top_t]
    return vals.gather(-1, order), ids.gather(-1, order)


def _batch_group(mesh, batch_size: int) -> Tuple[int, int, Optional[str]]:
    """(shards, this rank's shard, the group over them: "slots" for
    pod×data, "data" for the data axis alone, None for one shard) of a
    ``batch_size`` batch under ``policy.batch_axes``."""
    axes = batch_axes(mesh, batch_size)
    n, i = batch_shard(mesh, batch_size, axes)
    if n == 1:
        return 1, 0, None
    return n, i, ("data" if axes == ("data",) else "slots")


def data_rows(mesh, batch_size: int) -> slice:
    """The rows of a ``batch_size`` batch this rank holds: its shard's
    where ``policy.batch_axes`` shards the batch (over pod×data, or over
    ``data``), else all of them (the batch replicated)."""
    n, i, _ = _batch_group(mesh, batch_size)
    per = batch_size // n
    return slice(i * per, (i + 1) * per)


def data_gather(mesh, x: torch.Tensor, batch_size: int) -> torch.Tensor:
    """This rank's rows ``data_rows(mesh, batch_size)`` of a batch-leading
    tensor -> the whole batch, on every rank."""
    n, _, group = _batch_group(mesh, batch_size)
    if n == 1:
        return x
    return _gather0(mesh, group, x).reshape(batch_size, *x.shape[1:])


def any_row(mesh, flag: torch.Tensor, batch_size: int) -> torch.Tensor:
    """A () bool ``flag`` of this rank's rows of a ``batch_size`` batch,
    or-ed over the shards of the batch: the same () bool on every rank."""
    n, _, group = _batch_group(mesh, batch_size)
    if n == 1:
        return flag
    return _reduce(flag.to(torch.int32).reshape(1), mesh, group,
                   op=dist.ReduceOp.MAX)[0] > 0


def broadcast_plan(mesh, plan=None):
    """Rank 0's ``plan`` (any picklable object; the others pass None) on
    every rank of the mesh, over the gloo "control" group as CPU tensors,
    whatever the backend of the other groups."""
    box = [plan]
    dist.broadcast_object_list(box, src=mesh.ranks[0],
                               group=mesh.groups["control"])
    CALLS["broadcast"] += 1
    return box[0]


def pod_gather(mesh, leaves: List[torch.Tensor],
               width: int) -> Tuple[List[torch.Tensor], int]:
    """The prefill→decode handoff of a ``width``-wide prefill batch whose
    rows shard over ``pod`` (``policy.prefill_axes``): each pod's rows of
    every leaf -> all ``width`` rows on every rank, in one
    ``all_gather_into_tensor`` over ``pod`` of the leaves' bytes packed as
    int32 words (a gather moves bits; int32 is a type every backend
    gathers).  Returns (the whole leaves, bytes received a rank); the
    identity, with 0 bytes, where the batch is replicated."""
    if prefill_axes(mesh, width) is None:
        return leaves, 0
    parts = [t.contiguous().reshape(-1).view(torch.uint8) for t in leaves]
    sizes = [b.numel() for b in parts]
    pad = -sum(sizes) % 4
    if pad:
        parts.append(torch.zeros(pad, dtype=torch.uint8,
                                 device=parts[0].device))
    words = torch.cat(parts).view(torch.int32)
    got = _gather0(mesh, "pod", words).view(torch.uint8)   # (P, bytes)
    out, at = [], 0
    for t, nb in zip(leaves, sizes):
        block = got[:, at:at + nb].contiguous().view(t.dtype)
        out.append(block.reshape(-1, *t.shape[1:]))
        at += nb
    return out, got.numel() - got.shape[1]


def all_finished(mesh, finished: torch.Tensor) -> bool:
    """True when every row of every rank of the mesh is finished: the
    decode loop's exit test, so that no rank leaves while its peers still
    wait for it in a collective.  One host read, as the loop makes without
    a mesh."""
    done = finished.all().to(torch.int32).reshape(1)
    if "world" in mesh.groups:
        _reduce(done, mesh, "world", op=dist.ReduceOp.MIN)
    return bool(done.item())
