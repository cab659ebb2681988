"""Multi-host deployment: process coordination and device meshes (port of
orbslamm_tpu/parallel/multihost.py).

The reference's communication backend is shared-memory mutexes inside one
process (SURVEY.md §2.3 C1: every System holds the same MultiMapper
pointer). The JAX package scales it with one controller per host. This
package keeps that model, in PyTorch's idiom:

  * inside one host, one process drives every local device. A ``Mesh`` of
    local devices names where each part lives: the StreamBank's robots
    (``parallel/streams.py``), the edge shards of the distributed BA and the
    keyframe blocks of the sharded global BA (``parallel/dist_ba.py``).
    Tensors move between them with ``.to(device)`` and partial sums are
    added on the mesh's first device in mesh order: no NCCL and no
    ``torch.distributed`` inside a host (the counterpart of the all-reduce
    that GSPMD inserts);
  * between hosts, every process runs this same program, joined by
    ``initialize()`` into a ``torch.distributed`` group on the gloo backend.
    Every payload that crosses hosts is host bytes (merge notifications, map
    signatures, shipped maps: ``parallel/multihost_mapper.py``), moved by
    ``all_gather_bytes`` / ``barrier`` on CPU tensors.

A mesh's device list may repeat a device: ``stream_mesh(["cpu"] * 8)`` is
eight slots on the CPU and ``stream_mesh(["cuda:0"] * 4)`` four slots on one
card. That stands in for the JAX tests' eight virtual CPU devices
(``--xla_force_host_platform_device_count=8``) and runs every partitioned
code path on one device.

A single process (no coordinator configured) needs no initialization:
``process_count()`` is 1 and the collectives return their input.
"""

from __future__ import annotations

import datetime
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist


class Mesh:
    """A named grid of devices: ``devices`` is a numpy object array of
    ``torch.device`` (entries may repeat), ``axis_names`` one name per
    axis."""

    def __init__(self, devices, axis_names: tuple[str, ...]):
        names = np.asarray(devices, dtype=object)
        grid = np.empty(names.shape, dtype=object)
        for idx in np.ndindex(grid.shape):
            grid[idx] = torch.device(names[idx])
        if grid.ndim != len(axis_names):
            raise ValueError(f"a {grid.ndim}-d device grid needs {grid.ndim} axis names, "
                             f"got {axis_names}")
        if grid.size == 0:
            raise ValueError("a mesh needs at least one device")
        self.devices = grid
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def flat(self) -> list[torch.device]:
        """The devices in mesh order (row-major)."""
        return list(self.devices.flat)

    def __len__(self) -> int:
        return self.devices.size

    def __repr__(self) -> str:
        names = [str(d) for d in self.flat]
        return f"Mesh({dict(self.shape)}, devices={names})"


def _local_devices(devices) -> list[torch.device]:
    if devices is not None:
        return [torch.device(d) for d in devices]
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: name the mesh's devices (devices=['cpu', ...])")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, timeout_s: float = 300.0) -> None:
    """Join the process group of a multi-host run: ``torch.distributed``
    on the gloo backend, process 0 serving the rendezvous at
    ``coordinator_address`` (``host:port``).

    With no argument, the standard environment (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``) is used; with neither an
    argument nor that environment this is a no-op and the run is a single
    process. A group that cannot be joined (a coordinator that does not
    answer within ``timeout_s``) raises: the run never carries on as a
    single process instead."""
    timeout = datetime.timedelta(seconds=timeout_s)
    if coordinator_address is None and num_processes is None and process_id is None:
        if "MASTER_ADDR" not in os.environ and "WORLD_SIZE" not in os.environ:
            return
        dist.init_process_group("gloo", init_method="env://", timeout=timeout)
        return
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("initialize needs coordinator_address, num_processes and process_id "
                         "together")
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id, timeout=timeout)


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def host_mesh(devices=None) -> Mesh:
    """[host, chip] mesh: one row per process, each row the devices of one
    host. Shard robot streams over ``host`` (independent between merges)
    and keyframe blocks or BA edges over ``chip``.

    A process addresses only its own devices, so every row names them as
    its own process does: the same local layout on every host. ``devices``
    (default: every local CUDA device) is that layout."""
    local = _local_devices(devices)
    return Mesh(np.array([local] * process_count(), dtype=object), ("host", "chip"))


def stream_mesh(devices=None) -> Mesh:
    """Flat mesh over this process's devices (default: every local CUDA
    device), axis ``("d",)``: one robot slice per device in the StreamBank,
    no collectives on the tracking path. Entries may repeat."""
    return Mesh(np.array(_local_devices(devices), dtype=object), ("d",))


def barrier() -> None:
    """Cross-process barrier (the reference's finish/stop handshakes,
    MultiMapper.cc:954-971); returns at once in a single process."""
    if process_count() == 1:
        return
    dist.barrier()


def all_gather_bytes(payload: bytes, max_len: int = 1 << 16) -> list[bytes]:
    """Exchange small host-side payloads (merge notifications, keyframe
    headers) between all processes through one padded uint8 all-gather:
    each process sends a 4-byte length and its payload padded to
    ``max_len``. Returns every process's payload in process order. Every
    process must call it collectively; a payload above ``max_len`` raises
    ``ValueError``."""
    n_proc = process_count()
    if n_proc == 1:
        return [payload]
    ln = len(payload)
    if ln > max_len:
        raise ValueError(f"payload {ln} > max_len {max_len}")
    buf = np.zeros(max_len + 4, np.uint8)
    buf[:4] = np.frombuffer(np.uint32(ln).tobytes(), np.uint8)
    buf[4:4 + ln] = np.frombuffer(payload, np.uint8)
    mine = torch.from_numpy(buf)
    rows = [torch.empty_like(mine) for _ in range(n_proc)]
    dist.all_gather(rows, mine)
    out = []
    for row in rows:
        row = row.numpy()
        k = int(np.frombuffer(row[:4].tobytes(), np.uint32)[0])
        out.append(row[4:4 + k].tobytes())
    return out


def broadcast_pytree(tree, source: int = 0, max_len: int = 1 << 16):
    """Replicate a small host object from process ``source`` to every
    process (vocabulary, config digests): pickle over ``all_gather_bytes``.
    This package's own trees go as numpy first
    (``convert.vocabulary_to_numpy``). ``max_len`` bounds the pickle."""
    if process_count() == 1:
        return tree
    payload = pickle.dumps(tree) if process_index() == source else b""
    return pickle.loads(all_gather_bytes(payload, max_len=max_len)[source])
