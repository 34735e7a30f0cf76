"""Real multi-process serving fleet behind the router registry (port of
``repro.serving.realfleet``).

:class:`~repro_torch.serving.fleet.FleetQueueSim` *predicts* what
``n_servers`` micro-batching servers behind a router would do.  This module
*runs* that deployment on one host, so the prediction can be held against
wall-clock measurements (``repro_torch.benchmarks.realfleet``):

* :class:`WorkerServer` — one micro-batching policy server: a localhost
  TCP listener whose admission loop does CONTINUOUS batching (admit every
  request that arrived while the previous micro-batch was in service, up
  to ``max_batch``; the running batch's service time is the batching
  window).  Runs in-process for tests, or as the body of a spawned worker
  process (:func:`_worker_main`, which rebuilds the server half from the
  deployment manifest on its device).
* :class:`FleetClient` — the front door: one socket per worker, requests
  routed by the SAME registered policies the simulator uses
  (``repro_torch.serving.fleet.ROUTERS``), with per-request timeouts and
  bounded retries that re-route around dead or stalled workers.
* :class:`RealFleet` — the process manager: spawns ``n_servers`` worker
  processes from one manifest and a numpy parameter tree, wires up a
  :class:`FleetClient`, and on :meth:`RealFleet.close` drains in-flight
  requests (a graceful SHUTDOWN frame) before joining, returning the PIDs
  of any worker that had to be killed.
* :func:`run_load` — the open-loop load generator (N clients at a fixed
  decision rate, the Table 6 protocol) whose latency sample is held
  against the simulator's p95.

Wire format: length-prefixed frames (``!I`` byte count, then a 1-byte
message type and the body) carrying the wire codecs' payloads.
:func:`pack_payload` writes the reference's bytes for equal payloads;
torch tensors, on the card or not, are moved to the host once.  numpy has
no bfloat16, so :func:`unpack_payload` returns a bfloat16 tensor as a CPU
``torch.Tensor`` and every other one as a numpy array, each bitwise equal
to what was packed.  The framing and the protocol equal the reference's,
so a port client talks to a reference worker and the reverse.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import itertools
import queue
import socket
import struct
import threading
import time
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.nn.module import tree_map
from repro_torch.schema import check_version
from repro_torch.serving.fleet import Router, get_router

SHAPING_VERSION = 1

# ---------------------------------------------------------------------------
# Framing: length-prefixed messages carrying wire-codec payloads
# ---------------------------------------------------------------------------

MSG_REQ = 1        # !I req_id + packed payload
MSG_RESP = 2       # !I req_id + !H served-batch-size + packed {"action": a}
MSG_ERR = 3        # !I req_id + utf-8 message
MSG_SHUTDOWN = 4   # empty body: drain queued requests, respond, exit

_BF16 = "bfloat16"   # the reference's token: ml_dtypes' registered name


def _dtype_token(dtype: np.dtype) -> str:
    """Reversible wire name for a dtype.  ``dtype.str`` is
    endianness-explicit for every native dtype but collapses extension
    dtypes (``ml_dtypes.bfloat16``) to an opaque void: use the registered
    name for those."""
    return dtype.str if dtype.str[1] != "V" else dtype.name


def _dtype_from_token(token: str) -> np.dtype:
    """Inverse of :func:`_dtype_token` for numpy's own dtypes."""
    return np.dtype(token)


def _host(v):
    """One payload tensor on the host: a torch tensor is moved there once
    and becomes a numpy array, except bfloat16, which stays a CPU tensor."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        return v if v.dtype == torch.bfloat16 else v.numpy()
    return np.asarray(v)


def _stack(values):
    """Stack per-request tensors along a new leading axis (numpy, or torch
    for the bfloat16 tensors :func:`unpack_payload` returns)."""
    if isinstance(values[0], torch.Tensor):
        return torch.stack(values)
    return np.stack(values)


def pack_payload(payload) -> bytes:
    """Serialise a wire-codec payload dict to bytes, bitwise-reversibly.

    Per tensor: key, dtype token (endianness-explicit), shape, then the
    raw C-order buffer: the reference's layout, so equal payloads give
    equal bytes.  Values may be numpy arrays or torch tensors on any
    device.
    """
    parts = [struct.pack("!B", len(payload))]
    for key in sorted(payload):
        arr = _host(payload[key])
        if isinstance(arr, torch.Tensor):        # bfloat16
            token, shape = _BF16, tuple(arr.shape)
            raw = arr.contiguous().view(torch.int16).numpy().tobytes()
        else:
            token, shape = _dtype_token(arr.dtype), arr.shape
            raw = arr.tobytes(order="C")
        kb, db = key.encode(), token.encode()
        parts += [struct.pack("!H", len(kb)), kb,
                  struct.pack("!H", len(db)), db,
                  struct.pack("!B", len(shape)),
                  struct.pack(f"!{len(shape)}I", *shape),
                  struct.pack("!Q", len(raw)), raw]
    return b"".join(parts)


def unpack_payload(data: bytes) -> dict:
    """Inverse of :func:`pack_payload`: numpy arrays, and CPU tensors for
    bfloat16, bitwise equal to what was packed."""
    (n,) = struct.unpack_from("!B", data, 0)
    off = 1
    out = {}
    for _ in range(n):
        (klen,) = struct.unpack_from("!H", data, off); off += 2
        key = data[off:off + klen].decode(); off += klen
        (dlen,) = struct.unpack_from("!H", data, off); off += 2
        token = data[off:off + dlen].decode(); off += dlen
        (ndim,) = struct.unpack_from("!B", data, off); off += 1
        shape = struct.unpack_from(f"!{ndim}I", data, off); off += 4 * ndim
        (nbytes,) = struct.unpack_from("!Q", data, off); off += 8
        buf = data[off:off + nbytes]
        if token == _BF16:
            out[key] = torch.from_numpy(
                np.frombuffer(buf, np.int16).reshape(shape).copy()
            ).view(torch.bfloat16)
        else:
            out[key] = np.frombuffer(
                buf, dtype=_dtype_from_token(token)).reshape(shape)
        off += nbytes
    return out


def _send_frame(sock: socket.socket, mtype: int, body: bytes = b"",
                lock: Optional[threading.Lock] = None) -> None:
    data = struct.pack("!IB", len(body) + 1, mtype) + body
    if lock is not None:
        with lock:
            sock.sendall(data)
    else:
        sock.sendall(data)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return bytes(buf)


def _recv_frame(sock: socket.socket):
    """(message type, body) or (None, None) on a clean EOF."""
    hdr = _recv_exact(sock, 4)
    if hdr is None:
        return None, None
    (length,) = struct.unpack("!I", hdr)
    data = _recv_exact(sock, length)
    if data is None:
        return None, None
    return data[0], data[1:]


# ---------------------------------------------------------------------------
# Ingress shaping: token-bucket on the worker's request path
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapingConfig:
    """Token-bucket ingress shaping for one worker's socket.

    The sims model a bandwidth-shaped uplink in front of the fleet; raw
    localhost loopback has none.  This config shapes each worker's
    REQUEST ingress to ``rate_mbps`` with a ``burst_bytes`` bucket (the
    tc-tbf stand-in), and is stamped into the calibration artifact so
    shaped and unshaped measurements never get conflated.
    """
    rate_mbps: float
    burst_bytes: int = 16384

    def __post_init__(self):
        if self.rate_mbps <= 0.0:
            raise ValueError(f"rate_mbps must be > 0: {self.rate_mbps}")
        if self.burst_bytes < 1:
            raise ValueError(f"burst_bytes must be >= 1: {self.burst_bytes}")

    def to_dict(self) -> dict:
        return {"version": SHAPING_VERSION,
                "rate_mbps": self.rate_mbps,
                "burst_bytes": self.burst_bytes}

    @classmethod
    def from_dict(cls, d: dict) -> "ShapingConfig":
        check_version("ShapingConfig", d.get("version", SHAPING_VERSION),
                      (SHAPING_VERSION,))
        return cls(rate_mbps=float(d["rate_mbps"]),
                   burst_bytes=int(d.get("burst_bytes", 16384)))

    def bucket(self) -> "TokenBucket":
        return TokenBucket(rate_bps=self.rate_mbps * 1e6,
                           burst_bytes=self.burst_bytes)


class TokenBucket:
    """Thread-safe GCRA token bucket: ``reserve(nbytes)`` returns how
    long the caller must sleep before admitting ``nbytes``.

    Virtual-scheduling form: ``_tat`` is the theoretical arrival time of
    the NEXT conforming byte; a reservation pushes it forward by the
    payload's transmission time at ``rate_bps`` and the caller waits
    until the new ``_tat`` minus the burst allowance.  An idle bucket
    regains its full burst; the first ``burst_bytes`` always pass
    unshaped.  ``clock`` is injectable so tests run on virtual time.
    """

    def __init__(self, *, rate_bps: float, burst_bytes: int,
                 clock: Callable[[], float] = time.monotonic):
        if rate_bps <= 0.0:
            raise ValueError(f"rate_bps must be > 0: {rate_bps}")
        self._bytes_per_s = rate_bps / 8.0
        self._burst_s = burst_bytes / self._bytes_per_s
        self._tat = -np.inf          # full burst available at t=0
        self._clock = clock
        self._lock = threading.Lock()

    def reserve(self, nbytes: int) -> float:
        with self._lock:
            now = self._clock()
            tat = max(self._tat, now)
            self._tat = tat + nbytes / self._bytes_per_s
            return max(0.0, self._tat - self._burst_s - now)


# ---------------------------------------------------------------------------
# The worker: one continuous-batching policy server
# ---------------------------------------------------------------------------

_SHUTDOWN = object()


@dataclasses.dataclass
class _Request:
    conn: socket.socket
    lock: threading.Lock
    req_id: int
    payload: dict


class WorkerServer:
    """One micro-batching policy server on a localhost TCP socket.

    ``serve_batch_fn`` maps a stacked payload dict (a leading batch axis
    on every tensor, as ``repro_torch.core.wire.stack_payloads`` gives) to
    stacked actions, a numpy array or a torch tensor on any device; the
    actions come to the host once a batch, which is its one sync.

    Admission is CONTINUOUS batching: the serve loop blocks for the first
    request, then admits everything already queued (up to ``max_batch``)
    and launches at once; requests arriving while a batch is in service
    form the next batch.  There is no ``max_wait`` hold.

    A ``MSG_SHUTDOWN`` frame starts a graceful drain: every request
    already received is served and answered, then the loop exits.  An
    exception in ``serve_batch_fn`` answers every request of its batch
    with ``MSG_ERR``; no client is left waiting.
    """

    def __init__(self, serve_batch_fn: Callable, *, max_batch: int = 8,
                 host: str = "127.0.0.1", port: int = 0,
                 shaper: Optional[TokenBucket] = None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1: {max_batch}")
        self.serve_batch_fn = serve_batch_fn
        self.max_batch = max_batch
        self.shaper = shaper
        self.shaped_sleep_s = 0.0
        self._host, self._port = host, port
        self._q: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._draining = False
        self._conns: list[socket.socket] = []
        self.n_served = 0
        self.batch_sizes: list[int] = []
        self.addr: Optional[tuple[str, int]] = None

    # ---- lifecycle ---------------------------------------------------------
    def listen(self) -> tuple[str, int]:
        """Bind and listen, accepting connections on a background thread;
        returns the bound (host, port).  Requests queue until the serve
        loop runs (:meth:`start`'s thread, or :meth:`serve_forever`)."""
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((self._host, self._port))
        self._listener.listen()
        self.addr = self._listener.getsockname()
        self._accept_t = threading.Thread(target=self._accept_loop,
                                          daemon=True)
        self._accept_t.start()
        return self.addr

    def start(self) -> tuple[str, int]:
        """Bind, listen, and serve on background threads; returns the
        bound (host, port)."""
        addr = self.listen()
        self._serve_t = threading.Thread(target=self.serve_forever,
                                         daemon=True)
        self._serve_t.start()
        return addr

    def join(self, timeout: Optional[float] = None) -> None:
        """Block until the serve loop exits (graceful drain or stop)."""
        self._serve_t.join(timeout)

    def stop(self) -> None:
        """Hard stop: abort the loop and drop every connection (tests use
        it to stand for a worker crash without a process kill)."""
        self._stop.set()
        with contextlib.suppress(OSError):
            self._listener.close()
        for c in self._conns:
            # shutdown() before close(): close() alone does not send FIN
            # while another thread is blocked in recv() on the same socket,
            # so peers would only notice through their request timeout
            with contextlib.suppress(OSError):
                c.shutdown(socket.SHUT_RDWR)
            with contextlib.suppress(OSError):
                c.close()

    # ---- socket side -------------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._conns.append(conn)
            threading.Thread(target=self._reader, args=(conn,),
                             daemon=True).start()

    def _reader(self, conn: socket.socket) -> None:
        lock = threading.Lock()
        while not self._stop.is_set():
            try:
                mtype, body = _recv_frame(conn)
            except OSError:
                return
            if mtype is None:
                return
            if mtype == MSG_SHUTDOWN:
                self._q.put(_SHUTDOWN)
                return
            if mtype == MSG_REQ:
                if self.shaper is not None:
                    # ingress shaping: hold the frame (and, like a backed-
                    # up pipe, everything behind it on this connection)
                    # until the bucket admits its bytes.  All connections
                    # share one bucket, the worker's front door.
                    wait = self.shaper.reserve(len(body))
                    if wait > 0.0:
                        self.shaped_sleep_s += wait
                        time.sleep(wait)
                (req_id,) = struct.unpack_from("!I", body)
                self._q.put(_Request(conn, lock, req_id,
                                     unpack_payload(body[4:])))

    # ---- the continuous-batching admission loop ----------------------------
    def _admit(self) -> Optional[list[_Request]]:
        """Next micro-batch, or None when stopped or drained.

        Blocks for the first request, then sweeps the queue WITHOUT
        waiting: whatever arrived during the previous batch's service is
        admitted now (capped at ``max_batch``); later arrivals go to the
        next batch.
        """
        batch: list[_Request] = []
        while not batch:
            if self._stop.is_set():
                return None
            try:
                item = self._q.get(timeout=0.05)
            except queue.Empty:
                if self._draining:
                    return None
                continue
            if item is _SHUTDOWN:
                self._draining = True
                continue
            batch.append(item)
        while len(batch) < self.max_batch:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is _SHUTDOWN:
                self._draining = True
                break
            batch.append(item)
        return batch

    def serve_forever(self) -> None:
        """The serve loop, on the calling thread, until stopped or
        drained."""
        while True:
            batch = self._admit()
            if batch is None:
                break
            self._serve(batch)
        self._stop.set()
        with contextlib.suppress(OSError):
            self._listener.close()

    def _serve(self, batch: list[_Request]) -> None:
        stacked = {k: _stack([r.payload[k] for r in batch])
                   for k in batch[0].payload}
        try:
            out = _host(self.serve_batch_fn(stacked))
        except Exception as e:  # serve_batch_fn is arbitrary code: answer MSG_ERR rather than hang the clients
            msg = f"{type(e).__name__}: {e}".encode()[:2000]
            for r in batch:
                with contextlib.suppress(OSError):
                    _send_frame(r.conn, MSG_ERR,
                                struct.pack("!I", r.req_id) + msg, r.lock)
            return
        for i, r in enumerate(batch):
            body = struct.pack("!IH", r.req_id, len(batch)) \
                + pack_payload({"action": out[i]})
            with contextlib.suppress(OSError):
                _send_frame(r.conn, MSG_RESP, body, r.lock)
        self.n_served += len(batch)
        self.batch_sizes.append(len(batch))


def _numerics() -> dict:
    """This process's float32 numerics, which a spawned process does not
    inherit (it starts at torch's defaults): TF32 in matmuls and in cuDNN
    convolutions, and the intra-op thread count of the CPU's kernels."""
    return {"matmul_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn_tf32": torch.backends.cudnn.allow_tf32,
            "threads": torch.get_num_threads()}


def _set_numerics(numerics: dict) -> None:
    torch.backends.cuda.matmul.allow_tf32 = numerics["matmul_tf32"]
    torch.backends.cudnn.allow_tf32 = numerics["cudnn_tf32"]
    torch.set_num_threads(numerics["threads"])


def _worker_main(manifest: dict, params, max_batch: int, conn,
                 precompile: bool = True, shaping: Optional[dict] = None,
                 device: str = "cuda",
                 numerics: Optional[dict] = None) -> None:
    """Entry point of one spawned worker process.

    Builds ``repro_torch.deploy.Deployment`` from the manifest on
    ``device`` (the parent deployment's: ``"cuda"`` on the card, ``"cpu"``
    in the tests; a ``"cuda"`` worker on a host without CUDA raises, and
    the parent reports the dead worker) and moves the numpy parameter
    tree there.  ``numerics`` (:func:`_numerics` of the parent) sets the
    TF32 switches and the thread count the parent serves with, so a batch
    of one gives the parent's actions bit for bit.  ``precompile`` serves
    every admissible batch size 1..``max_batch`` once before the worker
    reports ready (on the card: cuBLAS handles, the allocator and the
    first launches, including the edge kernel that makes the example
    payload), and collects its garbage once before it reports ready.  Then
    it reports its bound (host, port) through ``conn`` and serves until a
    SHUTDOWN frame drains it, on the thread that warmed up: cuBLAS handles
    and other CUDA state are per thread, and a serve loop on a fresh
    thread would build its own on its first live batch.

    The edge kernel's library is built at first use; several workers
    starting on a checkout where it is not built yet each run nvcc (the
    result is atomic and correct, only slow), so build first
    (``repro_torch.kernels._build.build()``).
    """
    from repro_torch.deploy import Deployment, DeploymentConfig  # noqa: the deploy module imports this one
    if numerics is not None:
        _set_numerics(numerics)
    cfg = DeploymentConfig.from_dict(manifest)
    dep = Deployment.build(cfg, device=device)
    dev = dep.device
    tparams = tree_map(lambda a: torch.from_numpy(np.array(a)).to(dev),
                       params)
    batch_fn = dep.server_batch_fn(tparams)

    def serve(stacked):
        return batch_fn({k: torch.as_tensor(v).to(dev)
                         for k, v in stacked.items()})

    if precompile:
        with torch.inference_mode():
            edge = dep.split.edge_step(
                Deployment._split_params(tparams)["edge"],
                torch.zeros((1, cfg.in_h, cfg.in_w, cfg.spec.layers[0].c_in),
                            device=dev))
        # per-request payloads keep their leading 1-axis (stacking matches
        # wire.stack_payloads: the micro-batch is (B, 1, ...))
        example = {k: _host(v) for k, v in edge.items()}
        for b in range(1, max_batch + 1):
            _host(serve({k: _stack([v] * b) for k, v in example.items()}))
    # one full collection now, and its survivors (torch's and the model's
    # objects, hundreds of thousands) moved out of the collector's reach:
    # otherwise the worker's first full collection, which walks them all,
    # stalls a live batch
    gc.collect()
    gc.freeze()
    shaper = (ShapingConfig.from_dict(shaping).bucket()
              if shaping is not None else None)
    ws = WorkerServer(serve, max_batch=max_batch, shaper=shaper)
    conn.send(ws.listen())
    conn.close()
    ws.serve_forever()


# ---------------------------------------------------------------------------
# The front door: router + retries over per-worker sockets
# ---------------------------------------------------------------------------

class FleetTimeout(Exception):
    """A request exhausted its per-attempt timeout and retry budget."""


class FleetError(Exception):
    """The worker answered with an error frame."""


class _Pending:
    __slots__ = ("event", "result", "error", "batch")

    def __init__(self):
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.batch = 0


class _ServerConn:
    """One worker connection: framed send + a reader thread matching
    responses to pending requests by id."""

    def __init__(self, addr: tuple[str, int], *, connect_timeout_s: float):
        self.addr = addr
        self.sock = socket.create_connection(addr, timeout=connect_timeout_s)
        self.sock.settimeout(None)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._send_lock = threading.Lock()
        self._plock = threading.Lock()
        self._pending: dict[int, _Pending] = {}
        self.alive = True
        self.n_sent = 0
        threading.Thread(target=self._reader, daemon=True).start()

    @property
    def n_outstanding(self) -> int:
        with self._plock:
            return len(self._pending)

    def request_async(self, req_id: int, payload_bytes: bytes) -> _Pending:
        p = _Pending()
        with self._plock:
            self._pending[req_id] = p
        try:
            _send_frame(self.sock, MSG_REQ,
                        struct.pack("!I", req_id) + payload_bytes,
                        self._send_lock)
        except OSError as e:
            self.forget(req_id)
            self._fail_all(ConnectionError(f"send to {self.addr}: {e}"))
            raise ConnectionError(str(e)) from e
        self.n_sent += 1
        return p

    def forget(self, req_id: int) -> None:
        with self._plock:
            self._pending.pop(req_id, None)

    def _fail_all(self, err: Exception) -> None:
        self.alive = False
        with self._plock:
            pending, self._pending = dict(self._pending), {}
        for p in pending.values():
            p.error = err
            p.event.set()

    def _reader(self) -> None:
        while True:
            try:
                mtype, body = _recv_frame(self.sock)
            except OSError as e:
                self._fail_all(ConnectionError(f"recv from {self.addr}: {e}"))
                return
            if mtype is None:
                self._fail_all(ConnectionError(
                    f"worker at {self.addr} closed the connection"))
                return
            if mtype == MSG_RESP:
                req_id, batch = struct.unpack_from("!IH", body)
                with self._plock:
                    p = self._pending.pop(req_id, None)
                if p is not None:
                    p.result = unpack_payload(body[6:])["action"]
                    p.batch = batch
                    p.event.set()
            elif mtype == MSG_ERR:
                (req_id,) = struct.unpack_from("!I", body)
                with self._plock:
                    p = self._pending.pop(req_id, None)
                if p is not None:
                    p.error = FleetError(body[4:].decode(errors="replace"))
                    p.event.set()

    def send_shutdown(self) -> None:
        with contextlib.suppress(OSError):
            _send_frame(self.sock, MSG_SHUTDOWN, b"", self._send_lock)

    def close(self) -> None:
        # shutdown() wakes our reader thread (close() alone would leave it
        # blocked in recv and the fd open)
        with contextlib.suppress(OSError):
            self.sock.shutdown(socket.SHUT_RDWR)
        with contextlib.suppress(OSError):
            self.sock.close()


class FleetClient:
    """Routes requests to a set of live workers through the registered
    routing policies, with per-request timeouts and bounded retries.

    The router sees the view the simulator gives it: per-server
    outstanding counts as ``queue_lens`` and a busy/idle ``free`` estimate
    (``now`` when idle, ``now + outstanding * est_service_s`` when busy;
    the wall clock cannot observe a remote server's true free time).  A
    retry excludes the failed server and re-routes; a connection error
    marks the worker dead for all later requests.
    """

    def __init__(self, addrs: Sequence[tuple[str, int]], *,
                 router: Union[str, Router] = "round_robin",
                 timeout_s: float = 10.0, retries: int = 2,
                 est_service_s: float = 1e-3,
                 connect_timeout_s: float = 10.0):
        self.conns = [_ServerConn(a, connect_timeout_s=connect_timeout_s)
                      for a in addrs]
        self.set_router(router)
        self.timeout_s = timeout_s
        self.retries = retries
        self.est_service_s = est_service_s
        self._seq = itertools.count()       # routing sequence (sim's `seq`)
        self._ids = itertools.count()       # wire request ids
        self.stats = {"requests": 0, "retries": 0, "timeouts": 0,
                      "errors": 0, "per_server": [0] * len(addrs),
                      "max_served_batch": 0}

    @property
    def n_servers(self) -> int:
        return len(self.conns)

    def set_router(self, router: Union[str, Router]) -> None:
        self.router = router
        self._route = get_router(router)

    def _pick(self, client: int, seq: int, tried: set) -> Optional[int]:
        avail = [s for s in range(self.n_servers)
                 if self.conns[s].alive and s not in tried]
        if not avail:
            return None
        now = time.monotonic()
        queue_lens = [c.n_outstanding for c in self.conns]
        free = [now + queue_lens[s] * self.est_service_s
                if queue_lens[s] else now for s in range(self.n_servers)]
        s = self._route(client, seq, now, queue_lens, free)
        if s in avail:
            return s
        # the registered routers know nothing about dead/excluded workers;
        # snap to the least-loaded available one deterministically
        return min(avail, key=lambda x: (queue_lens[x], x))

    def request(self, payload, *, client: int = 0,
                timeout_s: Optional[float] = None) -> np.ndarray:
        """Send one request, wait for its action; retries re-route.

        ``payload`` is a wire-codec payload dict (or pre-packed bytes:
        the load generator packs once and reuses the buffer).
        """
        body = payload if isinstance(payload, bytes) else pack_payload(payload)
        timeout = self.timeout_s if timeout_s is None else timeout_s
        self.stats["requests"] += 1
        tried: set[int] = set()
        last_err: Optional[Exception] = None
        seq = next(self._seq)
        for attempt in range(self.retries + 1):
            if attempt:
                self.stats["retries"] += 1
            s = self._pick(client, seq, tried)
            if s is None:
                break
            req_id = next(self._ids)
            try:
                p = self.conns[s].request_async(req_id, body)
            except ConnectionError as e:
                last_err, tried = e, tried | {s}
                continue
            self.stats["per_server"][s] += 1
            if not p.event.wait(timeout):
                self.conns[s].forget(req_id)
                self.stats["timeouts"] += 1
                last_err = FleetTimeout(
                    f"server {s} {self.conns[s].addr}: no response in "
                    f"{timeout:.2f}s")
                tried.add(s)
                continue
            if p.error is not None:
                last_err, tried = p.error, tried | {s}
                if isinstance(p.error, FleetError):
                    self.stats["errors"] += 1
                continue
            self.stats["max_served_batch"] = max(
                self.stats["max_served_batch"], p.batch)
            return p.result
        raise FleetTimeout(
            f"request failed after {self.retries + 1} attempt(s) across "
            f"servers {sorted(tried) or 'none-available'}: {last_err}") \
            from last_err

    def shutdown(self, *, wait_pending_s: float = 10.0) -> None:
        """Graceful drain: SHUTDOWN every worker, wait for in-flight
        responses, then close the sockets."""
        for c in self.conns:
            if c.alive:
                c.send_shutdown()
        deadline = time.monotonic() + wait_pending_s
        for c in self.conns:
            while c.alive and c.n_outstanding \
                    and time.monotonic() < deadline:
                time.sleep(0.01)
        for c in self.conns:
            c.close()


# ---------------------------------------------------------------------------
# The process manager
# ---------------------------------------------------------------------------

class RealFleet:
    """``n_servers`` spawned worker processes + a routed front door.

    Built from ONE deployment manifest dict and a numpy parameter tree
    (both picklable across the spawn boundary; each worker rebuilds its
    server half with ``Deployment.build`` on ``device``).  Use
    :meth:`~repro_torch.deploy.Deployment.fleet` to construct one from a
    built deployment.

    Workers start by ``spawn``: a child forked from a parent that has
    initialised CUDA cannot use the card, so a CUDA fleet refuses
    ``mp_context="fork"`` when it is constructed.
    """

    def __init__(self, manifest: dict, params, *, n_servers: int = 1,
                 router: Union[str, Router] = "round_robin",
                 max_batch: int = 8, timeout_s: float = 10.0,
                 retries: int = 2, precompile: bool = True,
                 shaping: Optional[Union[ShapingConfig, dict]] = None,
                 mp_context: str = "spawn", device: str = "cuda"):
        if n_servers < 1:
            raise ValueError(f"n_servers must be >= 1: {n_servers}")
        if torch.device(device).type == "cuda" and mp_context == "fork":
            raise ValueError(
                "a CUDA fleet cannot fork its workers: a child forked from "
                "a parent that has initialised CUDA cannot use the card; "
                "use mp_context='spawn'")
        self.manifest = dict(manifest)
        self.params = params
        self.n_servers = n_servers
        self.router = router
        self.max_batch = max_batch
        self.timeout_s = timeout_s
        self.retries = retries
        self.precompile = precompile
        if isinstance(shaping, dict):
            shaping = ShapingConfig.from_dict(shaping)
        self.shaping = shaping
        self.device = str(device)
        self._mp_context = mp_context
        self.processes: list = []
        self.client: Optional[FleetClient] = None
        self.closed = False
        self.startup_s: Optional[float] = None   # spawn to every worker ready
        self.close_s: Optional[float] = None     # drain and join

    # ---- lifecycle ---------------------------------------------------------
    def start(self, *, start_timeout_s: float = 120.0) -> "RealFleet":
        """Spawn the workers, collect their ports, connect the client."""
        import multiprocessing as mp
        from concurrent.futures import ThreadPoolExecutor
        t0 = time.perf_counter()
        ctx = mp.get_context(self._mp_context)
        numerics = _numerics()
        pipes, child_conns = [], []
        for _ in range(self.n_servers):
            parent_conn, child_conn = ctx.Pipe(duplex=False)
            self.processes.append(ctx.Process(
                target=_worker_main,
                args=(self.manifest, self.params, self.max_batch, child_conn,
                      self.precompile, None if self.shaping is None
                      else self.shaping.to_dict(), self.device, numerics),
                daemon=True))
            pipes.append(parent_conn)
            child_conns.append(child_conn)
        # start() writes the pickled arguments into a pipe that the child
        # drains only after importing this module (and torch, seconds):
        # the parameters overflow the pipe's buffer, so started one after
        # another each worker would wait for the one before it
        addrs = []
        try:
            with ThreadPoolExecutor(self.n_servers) as pool:
                list(pool.map(lambda p: p.start(), self.processes))
            for c in child_conns:
                c.close()
            deadline = time.monotonic() + start_timeout_s
            for i, conn in enumerate(pipes):
                # poll in short slices so a worker that died during startup
                # fails the launch at once instead of eating the full
                # start timeout
                while not conn.poll(0.2):
                    p = self.processes[i]
                    if not p.is_alive():
                        raise RuntimeError(
                            f"worker {i} (pid {p.pid}) died during startup "
                            f"(exitcode={p.exitcode}; its traceback is on "
                            f"stderr); spawned workers re-import the parent "
                            f"__main__ module: run from a file or pytest, "
                            f"not stdin")
                    if time.monotonic() > deadline:
                        raise RuntimeError(
                            f"worker {i} (pid {p.pid}) did not report a "
                            f"port within {start_timeout_s:.0f}s")
                addrs.append(conn.recv())
                conn.close()
        except BaseException:
            self._kill_all()
            raise
        self.client = FleetClient(addrs, router=self.router,
                                  timeout_s=self.timeout_s,
                                  retries=self.retries)
        self.startup_s = time.perf_counter() - t0
        return self

    def __enter__(self) -> "RealFleet":
        return self if self.client is not None else self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # ---- serving -----------------------------------------------------------
    def request(self, payload, *, client: int = 0,
                timeout_s: Optional[float] = None) -> np.ndarray:
        if self.client is None:
            raise RuntimeError("fleet not started (call start())")
        return self.client.request(payload, client=client,
                                   timeout_s=timeout_s)

    def set_router(self, router: Union[str, Router]) -> None:
        """Switch the front door's routing policy (workers are untouched:
        routing is a parent-side decision, exactly as in the sim)."""
        self.router = router
        if self.client is not None:
            self.client.set_router(router)

    @property
    def stats(self) -> dict:
        return {} if self.client is None else self.client.stats

    # ---- shutdown ----------------------------------------------------------
    def _kill_all(self) -> None:
        for p in self.processes:
            if p.is_alive():
                p.terminate()
        for p in self.processes:
            if p.is_alive():
                p.join(timeout=2.0)
            if p.is_alive():
                p.kill()
                p.join(timeout=2.0)

    def close(self, *, grace_s: float = 15.0) -> list[int]:
        """Graceful shutdown: drain in-flight requests, join the workers.

        Returns the PIDs of workers that did NOT exit gracefully and had
        to be terminated; the leak gates assert this is empty.
        """
        if self.closed:
            return []
        self.closed = True
        t0 = time.perf_counter()
        if self.client is not None:
            self.client.shutdown(wait_pending_s=grace_s)
        deadline = time.monotonic() + grace_s
        for p in self.processes:
            p.join(timeout=max(0.1, deadline - time.monotonic()))
        leaked = [p.pid for p in self.processes if p.is_alive()]
        self._kill_all()
        self.close_s = time.perf_counter() - t0
        return leaked


# ---------------------------------------------------------------------------
# Open-loop load generation (the Table 6 protocol, for real)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LoadReport:
    """Latency sample from one :func:`run_load` run."""

    latencies_s: np.ndarray        # decision latency per completed request
    n_requests: int
    n_failures: int
    duration_s: float
    failures: tuple = ()

    def p95(self) -> float:
        if self.latencies_s.size == 0:
            return float("inf")
        return float(np.percentile(self.latencies_s, 95))

    def p50(self) -> float:
        if self.latencies_s.size == 0:
            return float("inf")
        return float(np.percentile(self.latencies_s, 50))


def run_load(client: FleetClient, payload, *, n_clients: int = 8,
             rate_hz: float = 10.0, duration_s: float = 2.0,
             timeout_s: Optional[float] = None) -> LoadReport:
    """N clients issuing requests at a fixed rate against the fleet.

    Mirrors ``QueueSim._request_arrivals``: clients are staggered by
    ``period / n_clients`` and each issues every ``period`` seconds.
    Latency is measured from the SCHEDULED observation time to response
    receipt (so a backlog at the client counts against latency, exactly
    as queueing does in the sim).  The payload is packed once and the
    same bytes are reused for every request.
    """
    body = payload if isinstance(payload, bytes) else pack_payload(payload)
    period = 1.0 / rate_hz
    t_start = time.monotonic() + 0.05
    lats: list[float] = []
    failures: list[tuple] = []

    def client_loop(c: int) -> None:
        # schedule in offsets from t_start, NOT by accumulating onto the
        # monotonic clock: adding `period` to a large clock value rounds
        # differently depending on the host's uptime, which would make the
        # request COUNT (k*period < duration) depend on the machine's state
        offset = c * period / n_clients
        k = 0
        while offset + k * period < duration_s:
            t_k = t_start + offset + k * period
            now = time.monotonic()
            if now < t_k:
                time.sleep(t_k - now)
            try:
                client.request(body, client=c, timeout_s=timeout_s)
                lats.append(time.monotonic() - t_k)
            except (FleetTimeout, FleetError, ConnectionError) as e:
                failures.append((c, t_k - t_start, repr(e)))
            k += 1

    threads = [threading.Thread(target=client_loop, args=(c,))
               for c in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return LoadReport(latencies_s=np.asarray(sorted(lats), float),
                      n_requests=len(lats) + len(failures),
                      n_failures=len(failures), duration_s=duration_s,
                      failures=tuple(failures))


__all__ = ["FleetClient", "FleetError", "FleetTimeout", "LoadReport",
           "RealFleet", "ShapingConfig", "TokenBucket", "WorkerServer",
           "pack_payload", "run_load", "unpack_payload", "MSG_REQ",
           "MSG_RESP", "MSG_ERR", "MSG_SHUTDOWN"]
