"""Host batches to the device, as ``repro.data.pipeline``: numpy batches
become tensors on an explicit device (through pinned host memory and a
non-blocking copy on a card), and ``prefetch`` makes the next batches on a
bounded background thread while the device trains on this one.
``stub_frontend_inputs`` makes the stub inputs of a modality frontend (the
vision_text patch embeddings).  ``sharding=`` a ``launch.mesh.Mesh`` puts
this rank's rows of each batch on its device (the reference's
``sharding=``, whose batch dim lies over the data axis: ``comm.data_rows``);
any other sharding is refused."""
from __future__ import annotations

import itertools
import queue
import threading
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.config import ModelConfig
from repro_torch.launch.mesh import Mesh
from repro_torch.sharding import comm


def _check_sharding(sharding) -> None:
    if sharding is not None and not isinstance(sharding, Mesh):
        raise NotImplementedError(
            f"sharding={type(sharding).__name__}: a batch shards over a "
            f"repro_torch.launch.mesh.Mesh's data axis only; other shardings "
            f"are not ported yet (ROADMAP.md §1 item 8d, sharded training)")


def to_device(batch: Dict[str, np.ndarray], device=None, *,
              sharding=None) -> Dict[str, torch.Tensor]:
    """``batch``'s arrays (this rank's rows of them under a ``Mesh``
    ``sharding``) as tensors on ``device`` (default the mesh's device, else
    the card)."""
    _check_sharding(sharding)
    if sharding is not None:
        rows = comm.data_rows(sharding, len(next(iter(batch.values()))))
        batch = {k: np.asarray(v)[rows] for k, v in batch.items()}
        device = sharding.device if device is None else device
    dev = resolve_device(device)
    if dev.type != "cuda":
        return {k: torch.as_tensor(np.asarray(v), device=dev)
                for k, v in batch.items()}
    return {k: torch.as_tensor(np.asarray(v)).pin_memory().to(
        dev, non_blocking=True) for k, v in batch.items()}


class _Failed:
    def __init__(self, exc: BaseException):
        self.exc = exc


_END = object()


def prefetch(it: Iterator[Dict], depth: int = 2, *, device=None,
             sharding=None) -> Iterator[Dict]:
    """Yield ``it``'s batches on ``device`` in order, made and copied by a
    background thread that runs at most ``depth`` batches ahead.  An
    exception in ``it`` is raised here; closing the generator stops the
    thread.  ``sharding`` as ``to_device``."""
    _check_sharding(sharding)
    if device is None and sharding is not None:
        device = sharding.device
    dev = resolve_device(device)
    slots: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                slots.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def work():
        try:
            for batch in it:
                if not put(to_device(batch, dev, sharding=sharding)):
                    return
        except Exception as exc:              # handed to the consumer
            put(_Failed(exc))
            return
        put(_END)

    worker = threading.Thread(target=work, name="prefetch", daemon=True)
    worker.start()
    try:
        while True:
            item = slots.get()
            if item is _END:
                return
            if isinstance(item, _Failed):
                raise item.exc
            yield item
    finally:
        stop.set()
        worker.join(timeout=10)


def stub_frontend_inputs(cfg: ModelConfig, rng: np.random.Generator,
                         batch: int, text_len: int) -> Dict[str, np.ndarray]:
    """The frontends are stubs: precomputed patch embeddings of the right
    shape, (batch, ``num_patch_tokens``, d) for a vision_text config, then
    the (batch, ``text_len``) tokens, drawn from ``rng`` in that order (the
    reference's arrays for the same generator state)."""
    out: Dict[str, np.ndarray] = {}
    if cfg.modality == "vision_text" and cfg.num_patch_tokens:
        out["patch_embeds"] = rng.normal(
            size=(batch, cfg.num_patch_tokens, cfg.d_model)).astype(np.float32)
    out["tokens"] = rng.integers(0, cfg.vocab_size,
                                 (batch, text_len)).astype(np.int32)
    return out


def take(it: Iterator, n: int):
    return list(itertools.islice(it, n))
