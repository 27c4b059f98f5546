"""Multi-process serving (port of ``flexflow_tpu/parallel/distributed.py``).

Every process runs the same program: ``init_distributed`` forms the
``torch.distributed`` default group that ``parallel/mesh.make_mesh`` then
cuts into the mesh's groups. Rank 0 is the controller: it owns the request
queue. The followers run the same request manager against the same engine
(each over its own cut of the model), fed the same request stream through
:class:`RequestBroadcaster`, a length-prefixed pickle fan-out over TCP.
Because the scheduler is deterministic given the requests and the seed,
every rank then makes the same scheduling decisions and issues the same
collectives in the same order.

The broadcaster is a plain socket, not a collective: the collectives of a
process group pair up in the order they are issued (``parallel/mesh.py``),
so a control message over a group that also carries a step's collectives
would meet the wrong partner. Its wire format is JAX's: an 8-byte
little-endian length (``struct "<Q"``), then the pickle; ``None`` is the
shutdown sentinel.

``serve_distributed`` is one distributed ``generate``: the controller
broadcasts the prompts and the generation config, and every rank runs the
same ``rm.generate``. The background server under a mesh
(``serving/request_manager.BackgroundServing``, ``serve.LLM.start_server``)
broadcasts one tick of new requests per scheduling step instead.
"""

from __future__ import annotations

import os
import pickle
import socket
import struct
import time
from typing import Any, Optional, Union

import torch
import torch.distributed as dist

from flexflow_tpu_torch.device import resolve_device
from flexflow_tpu_torch.parallel.mesh import _default_device

DEFAULT_PORT = 47551
CONNECT_S = 60.0  # how long a follower retries, and a controller waits, for the other side
_CHUNK = 1 << 20  # the most one recv() reads


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None, process_id: Optional[int] = None, *,
                     device: Optional[Union[str, torch.device]] = None,
                     backend: Optional[str] = None) -> None:
    """Form the default process group over ``tcp://coordinator_address``.

    Arguments default from the environment: ``FF_COORDINATOR_ADDRESS``
    (``host:port``), ``FF_NUM_PROCESSES`` and ``FF_PROCESS_ID``. Does
    nothing when ``num_processes <= 1``. ``device`` is this process's
    card (where JAX takes ``local_device_ids``): ``cuda:LOCAL_RANK`` unless
    named, as in ``make_mesh``; only ``device="cpu"`` gives a CPU group.
    The backend is NCCL for a CUDA device and gloo for the CPU unless
    ``backend`` names one (two ranks may share one card over gloo)."""
    coordinator_address = coordinator_address or os.environ.get("FF_COORDINATOR_ADDRESS")
    if num_processes is None:
        num_processes = int(os.environ.get("FF_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("FF_PROCESS_ID", "0"))
    if num_processes <= 1:
        return
    if not coordinator_address:
        raise ValueError("init_distributed over several processes needs the coordinator's "
                         "host:port (coordinator_address or FF_COORDINATOR_ADDRESS)")
    device = _default_device() if device is None else resolve_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def is_controller() -> bool:
    """Rank 0 of the default group; true when no group exists."""
    return not dist.is_initialized() or dist.get_rank() == 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


class RequestBroadcaster:
    """The controller's fan-out to its followers: the controller calls
    ``broadcast(obj)``, every follower ``recv()``. Each message is an 8-byte
    ``<Q`` length and the pickle; ``None`` is the shutdown sentinel.

    The controller binds ``0.0.0.0:port`` and accepts ``process_count() -
    1`` followers; a follower connects to ``host`` (default
    ``FF_COORDINATOR_ADDRESS``'s host, else ``127.0.0.1``), retrying for
    ``CONNECT_S`` seconds while the controller comes up. ``stats`` counts
    the controller's messages, their bytes and the seconds their sends
    took."""

    def __init__(self, port: int = DEFAULT_PORT, host: Optional[str] = None):
        self.port = port
        self.controller = is_controller()
        self._conns = []
        self.closed = False
        self.stats = dict(messages=0, bytes=0, seconds=0.0, max_seconds=0.0)
        if self.controller:
            n_follow = process_count() - 1
            if n_follow:
                srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
                srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                srv.bind(("0.0.0.0", port))
                srv.listen(n_follow)
                srv.settimeout(CONNECT_S)
                try:
                    for _ in range(n_follow):
                        conn, _ = srv.accept()
                        self._conns.append(conn)
                except socket.timeout:
                    self.close()
                    raise ConnectionError(f"{n_follow - len(self._conns)} of {n_follow} "
                                          f"followers did not connect to port {port}") from None
                finally:
                    srv.close()
        else:
            host = host or os.environ.get("FF_COORDINATOR_ADDRESS", "127.0.0.1").split(":")[0]
            deadline = time.monotonic() + CONNECT_S
            while True:  # the controller may bind a moment later than followers connect
                conn = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
                try:
                    conn.connect((host, port))
                    break
                except OSError:
                    conn.close()
                    if time.monotonic() >= deadline:
                        raise ConnectionError(f"controller at {host}:{port} not up") from None
                    time.sleep(0.1)
            self._conns.append(conn)
        for c in self._conns:  # a tick per step: no Nagle delay behind an unacknowledged one
            c.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    def broadcast(self, obj: Any) -> Any:
        if not self.controller:
            raise RuntimeError("only the controller (rank 0) broadcasts")
        if self.closed:
            raise ConnectionError("the broadcaster is closed")
        t0 = time.perf_counter()
        blob = pickle.dumps(obj)
        msg = struct.pack("<Q", len(blob)) + blob
        for c in self._conns:
            c.sendall(msg)
        dt = time.perf_counter() - t0
        st = self.stats
        st["messages"] += 1
        st["bytes"] += len(msg) * len(self._conns)
        st["seconds"] += dt
        st["max_seconds"] = max(st["max_seconds"], dt)
        return obj

    def _read(self, n: int, what: str) -> bytes:
        c, parts, got = self._conns[0], [], 0
        while got < n:
            chunk = c.recv(min(_CHUNK, n - got))
            if not chunk:
                raise ConnectionError(what)
            parts.append(chunk)
            got += len(chunk)
        return b"".join(parts)

    def recv(self) -> Any:
        if self.controller:
            raise RuntimeError("the controller (rank 0) does not receive")
        if self.closed:
            raise ConnectionError("controller closed")
        (n,) = struct.unpack("<Q", self._read(8, "controller closed"))
        return pickle.loads(self._read(n, "controller closed mid-message"))

    def close(self) -> None:
        self.closed = True
        for c in self._conns:
            try:
                c.close()
            except OSError:
                pass
        self._conns = []


def serve_distributed(rm, broadcaster: RequestBroadcaster, prompts=None, config=None):
    """One distributed ``generate``: the controller broadcasts ``(prompts,
    config)`` and every rank runs the same deterministic ``rm.generate``.
    The controller passes them, the followers ``None``; every rank returns
    the requests (their outputs equal)."""
    if broadcaster.controller:
        broadcaster.broadcast((prompts, config))
    else:
        prompts, config = broadcaster.recv()
    return rm.generate(prompts, config)
