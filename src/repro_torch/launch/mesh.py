"""The ("data", "model") process mesh, and the ("pod", "data", "model") one
of disaggregated serving, as ``repro.launch.mesh``'s ``make_host_mesh(pod=,
require=True)``.

The reference runs one controller over every device and GSPMD inserts the
collectives.  Here every rank is a process of its own, and the collectives
are explicit (``sharding.comm``).  A ``Mesh`` holds the grid's ``shape``
({"data": D, "model": M}, or {"pod": P, "data": D, "model": M} when P > 1,
row-major as ``jax.make_mesh`` lays it out: rank r sits at (r // M, r % M),
or at (r // (D·M), (r // M) % D, r % M)), this rank's coordinates, one
process group per axis of more than one rank, the "slots" group of the
pod×data product (the ranks of one ``model`` coordinate: the serving
engine's slot slab shards over it), the group of all the mesh's ranks, and
this rank's device.

The "control" group is gloo over every rank of the mesh, whatever the
backend of the others: the serving engine's host plans (``comm.
broadcast_plan``) travel on it as CPU tensors.  Under NCCL (one card per
rank) a host object cannot ride the NCCL groups, so the control group is
a second, gloo, group beside them; that pairing is not exercised on a
machine with one card, where every group is gloo.

``spawn(fn, data, model, pod=1)`` starts the P·D·M ranks
(``torch.multiprocessing`` with "spawn"; a TCP store on 127.0.0.1 at a free
port), builds each rank's mesh and returns what ``fn(mesh, *args)``
returned on every rank.  The process-group backend is decided before init
(``choose_backend``): NCCL when every rank has a card of its own, gloo when
ranks share a card (NCCL refuses two ranks on one device) or run on the CPU.
"""
from __future__ import annotations

import datetime
import math
import queue as queue_lib
import socket
import time
import traceback
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import resolve_device

AXES = ("data", "model")
POD_AXES = ("pod", "data", "model")


def _name(pod: int, data: int, model: int) -> str:
    return f"{pod}x{data}x{model}" if pod > 1 else f"{data}x{model}"


class Mesh:
    """One rank's view of a ("data", "model") grid of ranks, or of a
    ("pod", "data", "model") one when ``pod`` > 1.

    ``groups`` maps "data", "model", "pod", "slots" (pod×data), "world"
    (every rank of the mesh) and "control" (gloo, for host plans) to a
    process group, or to None where the axis has one rank (the collectives
    of ``sharding.comm`` are then the identity).  A mesh made with no groups
    at all is a layout only: ``sharding.shard_params`` and ``model.init``
    read its shape and coordinates, and nothing is communicated.
    ``ranks`` are the global ranks of the mesh's members, mesh index 0
    first."""

    axis_names = AXES

    def __init__(self, data: int, model: int, *, pod: int = 1,
                 index: int = 0, groups: Optional[Dict[str, Any]] = None,
                 device=None, backend: str = "",
                 ranks: Optional[Sequence[int]] = None):
        size = pod * data * model
        if min(pod, data, model) < 1 or not 0 <= index < size:
            raise ValueError(f"mesh {_name(pod, data, model)} has no rank "
                             f"{index}")
        if pod > 1:
            self.axis_names = POD_AXES
        dims = {"pod": int(pod), "data": int(data), "model": int(model)}
        self.shape = {a: dims[a] for a in self.axis_names}
        self.index = int(index)
        coords = {"pod": index // (data * model),
                  "data": (index // model) % data, "model": index % model}
        self.coords = {a: coords[a] for a in self.axis_names}
        self.groups = dict(groups or {})
        self.device = torch.device("cpu") if device is None else torch.device(device)
        self.backend = backend
        self.ranks = list(range(size)) if ranks is None else list(ranks)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, coords={self.coords}, "
                f"device={self.device}, backend={self.backend or 'none'})")


def rank_device(rank: int, device=None) -> torch.device:
    """``cuda:(rank % device_count)``, or ``device`` when the caller names a
    CPU device; a CUDA device without a card raises (``resolve_device``)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    return torch.device("cuda", rank % torch.cuda.device_count())


def choose_backend(world: int, device=None) -> Tuple[str, str]:
    """(backend, why): NCCL when each of ``world`` ranks has a card of its
    own, else gloo (ranks sharing a card, or on the CPU)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return "gloo", f"{world} ranks on the CPU"
    cards = torch.cuda.device_count()
    if world <= cards:
        return "nccl", f"{world} ranks on {cards} cards, one card each"
    return "gloo", (f"{world} ranks share {cards} card"
                    f"{'s' if cards > 1 else ''}: NCCL refuses two ranks on "
                    f"one device")


def make_mesh(data: int = 1, model: int = 1, *, pod: int = 1, device=None,
              ranks: Optional[Sequence[int]] = None) -> Optional[Mesh]:
    """This rank's ``Mesh`` over ``ranks`` (default every rank of the
    initialised process group; a lone process is a world of one).

    Raises when the ranks are not ``pod × data × model``, as the reference's
    ``make_host_mesh(require=True)`` does.  Every rank of the world must call
    it (a process group is made collectively); a rank outside ``ranks``
    gets None.  ``device`` as ``rank_device``."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    members = list(range(world)) if ranks is None else [int(r) for r in ranks]
    need = pod * data * model
    if need != len(members) or any(not 0 <= r < world for r in members):
        raise RuntimeError(
            f"mesh {_name(pod, data, model)} needs {need} ranks, got "
            f"{len(members)} of a world of {world}: start pod × data × model "
            f"ranks (repro_torch.launch.mesh.spawn)")
    groups: Dict[str, Any] = {}
    if world > 1:
        at = lambda p, d, m: members[(p * data + d) * model + m]  # noqa: E731
        grid = [(p, d, m) for p in range(pod) for d in range(data)
                for m in range(model)]

        def lines(key):
            """The ranks of each line along the axes a key leaves out."""
            out: Dict[Any, list] = {}
            for p, d, m in grid:
                out.setdefault(key(p, d, m), []).append(at(p, d, m))
            return list(out.values())

        # every rank makes every group, in one order (new_group's contract)
        axis_lines = {"model": lines(lambda p, d, m: (p, d)),
                      "data": lines(lambda p, d, m: (p, m)),
                      "world": [members]}
        if pod > 1:
            axis_lines["pod"] = lines(lambda p, d, m: (d, m))
            axis_lines["slots"] = lines(lambda p, d, m: m)
        for axis, lines_ in axis_lines.items():
            for line in lines_:
                if len(line) < 2:
                    continue
                group = (dist.group.WORLD if len(line) == world
                         else dist.new_group(line))
                if rank in line:
                    groups[axis] = group
        if len(members) > 1:
            control = dist.new_group(members, backend="gloo")
            if rank in members:
                groups["control"] = control
        if pod == 1 and "data" in groups:
            groups["slots"] = groups["data"]
    if rank not in members:
        return None
    return Mesh(data, model, pod=pod, index=members.index(rank), groups=groups,
                device=rank_device(rank, device),
                backend=dist.get_backend() if dist.is_initialized() else "",
                ranks=members)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _to_host(obj):
    """Tensors in ``obj`` (nested dicts, lists, tuples) as numpy arrays, so
    a rank's result pickles by value."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)) and not hasattr(obj, "_fields"):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _rank_main(rank: int, world: int, port: int, shape: Tuple[int, int, int],
               fn: Callable, args: tuple, device, backend: str,
               timeout: float, out) -> None:
    """One rank: join the process group, build the mesh, run ``fn`` and
    send (rank, ok, result or traceback) to the parent."""
    try:
        dev = rank_device(rank, device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:   # ranks in lock-step: an idle intra-op pool spins on their cores
            torch.set_num_threads(1)
        dist.init_process_group(
            backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout))
        pod, data, model = shape
        mesh = make_mesh(data, model, pod=pod, device=dev)
        out.put((rank, True, _to_host(fn(mesh, *args))))
    except BaseException:                   # reported to the parent, then exit 1
        out.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, data: int, model: int, *, pod: int = 1,
          args: tuple = (), device=None, timeout: float = 600.0,
          limit_run: bool = True) -> list:
    """Run ``fn(mesh, *args)`` on ``pod × data × model`` new processes and
    return each rank's result (tensors as numpy arrays), rank 0 first.

    ``fn`` must be importable by name (it is pickled by reference).  The
    process group's collectives time out after ``timeout`` seconds, and so
    does the whole run: past it, or as soon as one rank fails, every rank
    is killed and this raises with the failing rank's traceback.  With
    ``limit_run`` False (a server that runs until it is drained) only the
    collectives time out."""
    world = pod * data * model
    name = _name(pod, data, model)
    backend, _ = choose_backend(world, device)
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, name=f"mesh-rank-{r}",
                         args=(r, world, port, (pod, data, model), fn, args, device,
                               backend, timeout, out))
             for r in range(world)]
    for p in procs:
        p.start()
    results: Dict[int, Any] = {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) < world:
            try:
                rank, ok, payload = out.get(timeout=0.2)
            except queue_lib.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    try:            # its report may still be on the way
                        rank, ok, payload = out.get(timeout=2.0)
                    except queue_lib.Empty:
                        raise RuntimeError(
                            f"{dead[0].name} exited with code "
                            f"{dead[0].exitcode} and reported nothing") from None
                elif limit_run and time.monotonic() > deadline:
                    raise TimeoutError(
                        f"mesh {name}: ranks {sorted(set(range(world)) - set(results))} "
                        f"did not finish within {timeout:.0f}s")
                else:
                    continue
            if not ok:
                raise RuntimeError(f"mesh {name}: rank {rank} "
                                   f"failed:\n{payload}")
            results[rank] = payload
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        out.close()
    return [results[r] for r in range(world)]

