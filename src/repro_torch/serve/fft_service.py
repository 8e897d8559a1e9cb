"""FFT-as-a-service: a fault-tolerant dynamic-batching front-end.

The paper's pitch is turning batch FFT into something analysts treat as an
interactive service on cheap, failure-prone servers; the engine underneath
this module is already a serving backend — a process-level plan cache
(tables built once, nothing rebuilt on repeat execute) and async
coalesced dispatch (core/pipeline/stream.py). `FftService` is the missing front-end, built to
stay *correct and bounded under overload and faults*:

  admit    `submit()` runs admission control synchronously on the caller
           thread: a bounded queue (occupancy cap — reject with
           `ServiceOverload(reason="queue_full")`, never unbounded
           growth), plus optional per-spec token-bucket rate limiting and
           per-spec inflight caps. Every rejection is a structured error
           on the returned ticket; nothing blocks, nothing is dropped
           silently.
  batch    ONE batcher thread drains the queue and groups requests by
           their resolved `FftSpec` cache key (the resolved spec modulo
           batch rows), launching coalesced `execute_async` batches. Plan
           reuse follows stream.py's 2-plan full/tail trick, generalized:
           per spec key every launch uses either the FULL plan
           (`coalesce x rows`, short groups zero-padded up to it) or the
           SINGLE plan (one request, taken when the queue is idle) — so a
           key touches at most two cache entries no matter how traffic
           fragments.
  deadline per-request deadlines resolved against the injectable
           `RetryPolicy` clock at admit and enforced end-to-end: late
           requests are shed BEFORE launch (and swept while queued), and
           a result that realizes past its deadline is degraded to a
           `DeadlineExceeded` carrying the queue/batch/execute breakdown.
  execute  launches go through `repro_torch.fft.plan(...).execute_async`
           — the service never holds executables of its own, the plan
           cache is the warm path — each on its plan's own CUDA stream,
           inside a bounded in-flight window (semaphore released at
           realization, exactly the stream executor's discipline; the
           device tensors stay alive in the `AsyncResult` until then).
           Writeback workers realize results (`AsyncResult.realize`, the
           only host wait), slice rows back per request, and resolve
           tickets.
  degrade  on sustained overload (consecutive queue-full rejections) the
           batcher sheds queued load by policy — "oldest_deadline" (the
           requests least likely to make it) or "smallest_batch" (the
           spec groups that coalesce worst) — completing victims with
           `ServiceOverload(reason="shed")` and logging a
           `service_degrade` event. On `meshstate` device loss the next
           launches re-plan via `plan(..., fallback="degrade")` and the
           epoch change is logged as a `service_degrade` event too.

Failure semantics: the fault sites `serve.admit` / `serve.batch` /
`serve.execute` (`repro_torch.core.resilience.faults.SITES`) thread
`FaultInjector` through all three stages; batch failures re-enter each
member into the retry path under the service's ONE `RetryPolicy` until
attempts/deadline are spent, then resolve as `RequestFailed` chaining the
last cause. An unexpected batcher crash fails only the requests it held
and recovers to an empty-but-serving state (`service_crash_recovered`
event); `close(drain=True)` launches everything still queued and joins
every thread, leaving the process at idle. Under an open-loop overload
with a 25% seeded fault storm, every admitted request returns a
bitwise-correct result or a classified structured error
(tests/test_torch_service.py, and the service phase of chip_smoke.py on
the card).

``device="cuda"`` (the default) launches the hand-written kernels,
``device="cpu"`` their plain PyTorch versions.

Over a mesh of more than one rank the service is SPMD, with one
controller. Every rank of the mesh constructs ``FftService(mesh=...)``
with the same arguments. The mesh's first rank ("rank 0") alone admits,
groups, sheds, retries, verifies and resolves tickets; every other rank
is a follower, whose `start` runs a loop that obeys rank 0 and whose
`submit` raises. The batcher's grouping depends on timing, so rank 0
decides each launch and tells the followers (`ControlChannel`, a gloo
group of the mesh's ranks built at construction, so its messages never
interleave with the collectives of plans, the tuner or
`meshstate.shrunk_mesh`):

  launch   a launch whose plan resolves to ``segmented``: rank 0 sends the
           spec (kind, shape, total rows), scatters each rank its
           contiguous dim-0 shard of the gathered operands
           (`core.fft.distributed.local_shard`'s order), every rank runs
           the same cached plan's `execute_async` on its shard, and rank 0
           gathers the realized rows in global order before writeback —
           ABFT, Parseval and the fault sites see exactly what a one-rank
           service sees. A launch that resolves ``local`` (the ABFT
           checksum row, an indivisible batch) runs on rank 0 alone.
  order    every collective of the service is started by one thread a
           rank (rank 0's batcher, the follower loop), the gather as an
           ``async_op`` handle that writeback waits on, so the ranks start
           them in one order at any ``max_inflight``.
  health   rank 0 puts the lost ranks into every message and re-sends them
           before it plans on a changed set; each follower marks them
           (`meshstate.lose_devices`) and every rank then builds the
           shrunk mesh together (its groups are collective) before anyone
           plans with ``fallback="degrade"``. A rank left out of the shrunk
           mesh keeps taking part in the channel.
  idle     rank 0 sends a no-op when nothing else went out for a quarter
           of the channel's timeout, so an idle follower never times out.
  stop     rank 0's `close` ends the followers; a follower's `close` (or
           its context exit) waits for that message.
"""

from __future__ import annotations

import contextlib
import datetime
import json
import math
import queue
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field, replace

import numpy as np

import torch

from repro_torch.core.resilience import verify as abft
from repro_torch.core.resilience.events import record_event
from repro_torch.core.resilience.faults import (corrupt_salt, maybe_fire,
                                                perturb_array)
from repro_torch.core.resilience.retry import RetryPolicy
from repro_torch.fft import spec as spec_mod

SHED_POLICIES = ("oldest_deadline", "smallest_batch")
# the fixed size of a control message: JSON, zero-padded
MSG_BYTES = 4096


# ---------------------------------------------------------------------------
# error taxonomy: every client-visible failure is one of these, each
# carrying enough structure for dashboards/tests to classify without
# parsing message text (DESIGN.md §12)


class ServiceError(Exception):
    """Base class for every structured service-side failure."""

    stage = "service"

    def as_dict(self) -> dict:
        return {"error": type(self).__name__, "stage": self.stage,
                "message": str(self)}


class ServiceOverload(ServiceError):
    """Admission control rejected (or shed) the request.

    ``reason``: "queue_full" | "rate_limit" | "inflight_cap" | "shed".
    """

    stage = "admit"

    def __init__(self, reason: str, detail: str = ""):
        super().__init__(f"service overloaded ({reason})"
                         + (f": {detail}" if detail else ""))
        self.reason = reason

    def as_dict(self) -> dict:
        return {**super().as_dict(), "reason": self.reason}


class ServiceClosed(ServiceError):
    """The service is shut (or shutting) down; the request was not run."""

    stage = "admit"


class DeadlineExceeded(ServiceError):
    """The request missed its deadline; carries the end-to-end breakdown.

    ``queue_s`` covers submit -> group formation, ``batch_s`` group
    formation -> launch (host gather + dispatch), ``execute_s`` launch ->
    realization (0.0 when the request was shed before launching — the
    normal case, late work never reaches the device). ``stage`` names
    where the deadline tripped: "queue" | "execute".
    """

    def __init__(self, deadline_s: float, queue_s: float,
                 batch_s: float = 0.0, execute_s: float = 0.0,
                 stage: str = "queue"):
        super().__init__(
            f"deadline {deadline_s * 1e3:.1f} ms exceeded at {stage} "
            f"(queue {queue_s * 1e3:.1f} ms, batch {batch_s * 1e3:.1f} ms, "
            f"execute {execute_s * 1e3:.1f} ms)")
        self.deadline_s = deadline_s
        self.queue_s = queue_s
        self.batch_s = batch_s
        self.execute_s = execute_s
        self.stage = stage

    def as_dict(self) -> dict:
        return {**super().as_dict(), "deadline_s": self.deadline_s,
                "queue_s": self.queue_s, "batch_s": self.batch_s,
                "execute_s": self.execute_s}


class RequestFailed(ServiceError):
    """The request's retry budget is spent; chains the last cause."""

    def __init__(self, stage: str, attempts: int, cause: BaseException):
        super().__init__(
            f"request failed at {stage} after {attempts} attempt(s): "
            f"{cause!r}")
        self.stage = stage
        self.attempts = attempts
        self.__cause__ = cause

    def as_dict(self) -> dict:
        return {**super().as_dict(), "attempts": self.attempts,
                "cause": repr(self.__cause__)}


# ---------------------------------------------------------------------------
# the control channel of a service over more than one rank


def encode_message(msg: dict) -> torch.Tensor:
    """A control message as the fixed-size uint8 tensor the channel
    broadcasts: its JSON, zero-padded to `MSG_BYTES`."""
    data = json.dumps(msg, separators=(",", ":")).encode()
    if len(data) > MSG_BYTES:
        raise ValueError(f"control message of {len(data)} bytes exceeds "
                         f"MSG_BYTES={MSG_BYTES}")
    buf = torch.zeros(MSG_BYTES, dtype=torch.uint8)
    buf[:len(data)] = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    return buf


def decode_message(buf: torch.Tensor) -> dict:
    """Inverse of `encode_message` (JSON holds no zero byte)."""
    return json.loads(bytes(buf.numpy()).rstrip(b"\0"))


class ControlChannel:
    """Rank 0's messages, shards and gathers over a gloo group of the mesh's
    ranks, on CPU tensors. Built collectively (`dist.new_group`): every
    rank of the default group constructs it at the same point.

    ``rank`` is this process's index in the group (0 is the controller);
    ``timeout_s`` bounds every operation, so rank 0 sends a no-op after
    ``keepalive_s`` (a quarter of it) of silence. ``seconds`` sums the
    wall time of each of rank 0's steps of a segmented launch: "shard"
    (cutting the operands), "send", "scatter" and "gather_wait" (a
    writeback's wait for every rank's rows).
    """

    def __init__(self, mesh, timeout_s: float):
        import torch.distributed as dist
        self.ranks = [int(r) for r in mesh.mesh.reshape(-1).tolist()]
        self.group = dist.new_group(
            self.ranks, backend="gloo",
            timeout=datetime.timedelta(seconds=timeout_s))
        self.rank = dist.get_rank(self.group)
        if self.rank < 0:
            raise ValueError(f"rank {dist.get_rank()} is not part of the "
                             f"service's mesh {self.ranks}")
        self.root = self.ranks[0]
        self.keepalive_s = timeout_s / 4
        self.last_send = time.monotonic()
        # rank 0: one message and its collectives go out together
        self.lock = threading.RLock()
        self.seconds = dict.fromkeys(
            ("shard", "send", "scatter", "gather_wait"), 0.0)
        self._seconds_lock = threading.Lock()

    @contextlib.contextmanager
    def timed(self, step: str):
        """Add the block's wall time to ``seconds[step]``."""
        t0 = time.monotonic()
        try:
            yield
        finally:
            with self._seconds_lock:
                self.seconds[step] += time.monotonic() - t0

    def send(self, msg: dict) -> None:
        """Rank 0: broadcast ``msg`` to every follower."""
        import torch.distributed as dist
        with self.timed("send"):
            dist.broadcast(encode_message(msg), src=self.root,
                           group=self.group)
        self.last_send = time.monotonic()

    def recv(self) -> dict:
        """A follower: the next message from rank 0."""
        import torch.distributed as dist
        buf = torch.empty(MSG_BYTES, dtype=torch.uint8)
        dist.broadcast(buf, src=self.root, group=self.group)
        return decode_message(buf)

    def scatter(self, shape, parts=None) -> torch.Tensor:
        """Rank 0 passes ``parts`` (one float32 tensor of ``shape`` a group
        rank); every rank returns its own."""
        import torch.distributed as dist
        out = torch.empty(shape, dtype=torch.float32)
        with self.timed("scatter"):
            dist.scatter(out, None if parts is None else list(parts),
                         src=self.root, group=self.group)
        return out

    def gather(self, part: torch.Tensor):
        """Every rank sends ``part``; returns the ``async_op`` work handle
        and, on rank 0, the list it fills (one entry a group rank)."""
        import torch.distributed as dist
        got = ([torch.empty_like(part) for _ in self.ranks]
               if self.rank == 0 else None)
        work = dist.gather(part, got, dst=self.root, group=self.group,
                           async_op=True)
        return work, got

    def close(self) -> None:
        """After the stop message: wait for every rank, then drop the
        group."""
        import torch.distributed as dist
        dist.barrier(group=self.group)
        dist.destroy_process_group(self.group)


def _shard_shapes(kind: str, shape: tuple, total: int, devices: int):
    """A segmented launch's per-rank operand (planes, rows/D, *shape) and
    output (2, rows/D, *one-sided for r2c) shapes."""
    rows = total // devices
    out_row = (shape if kind == "c2c"
               else (*shape[:-1], shape[-1] // 2 + 1))
    return ((2 if kind == "c2c" else 1, rows, *shape), (2, rows, *out_row))


class _MeshResult:
    """A segmented launch over the mesh, as rank 0 sees it: its own shard's
    `AsyncResult` (None when rank 0 holds no shard) and the gather of every
    rank's realized rows. `realize` returns the global host planes.

    Each gathered part is the flat output shard with one status value
    appended (0: the rank computed its shard)."""

    def __init__(self, local, error, work, parts, order, out_shape,
                 channel):
        self.local, self.error = local, error
        self.work, self.parts = work, parts
        self.order = order          # group rank holding shard s, for each s
        self.out_shape = out_shape  # (2, rows/D, *row shape)
        self.channel = channel

    def realize(self):
        try:
            own = None if self.local is None else self.local.realize()
        finally:
            with self.channel.timed("gather_wait"):
                self.work.wait()
        if self.error is not None:
            raise self.error
        shards = []
        for i in self.order:
            if i == 0 and own is not None:
                shards.append(own)
                continue
            flat = self.parts[i]
            if float(flat[-1]) != 0.0:
                raise RuntimeError(f"follower {i} of the service's mesh "
                                   f"failed its shard")
            planes = flat[:-1].reshape(self.out_shape).numpy()
            shards.append((planes[0], planes[1]))
        return tuple(np.concatenate([sh[k] for sh in shards])
                     for k in range(2))


# ---------------------------------------------------------------------------


class FftTicket:
    """Client handle for one submitted request (a tiny settable future).

    Resolved exactly once, with either ``value`` (planar result arrays)
    or ``error`` (a classified exception — usually a `ServiceError`).
    """

    def __init__(self, seq: int, kind: str, shape: tuple, rows: int,
                 deadline_s: float | None):
        self.seq = seq
        self.kind = kind
        self.shape = shape
        self.rows = rows
        self.deadline_s = deadline_s
        self.value = None
        self.error: BaseException | None = None
        self.attempts = 0
        #: total batch rows of the launch that produced the result (the
        #: full coalesced size or this request's own rows for a singleton
        #: launch); the fault-free oracle replays THIS size
        #: (`loadgen.oracle`) — row position and co-batched content do not
        #: affect a row's result.
        self.batch_rows: int | None = None
        self._occupies = False   # holds an admission slot until resolved
        self._energy: float | None = None  # input energy (verify modes)
        self._corrupt_hit = False          # quarantined at least once
        self.timings: dict = {}   # queue_s / batch_s / execute_s / total_s
        self._event = threading.Event()
        # internal routing state (service-owned, not part of the API)
        self._key = None
        self._operands: tuple = ()
        self._squeeze = False
        self._deadline_at: float | None = None
        self._t_submit = 0.0
        self._t_formed = 0.0
        self._t_launch = 0.0

    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: float | None = None) -> bool:
        return self._event.wait(timeout)

    def result(self, timeout: float | None = None):
        """Block for the outcome; returns the planar arrays or raises the
        classified error."""
        if not self._event.wait(timeout):
            raise TimeoutError(f"request {self.seq} still pending")
        if self.error is not None:
            raise self.error
        return self.value


@dataclass
class ServiceStats:
    """Thread-safe service counters; snapshot() adds latency percentiles.
    On a follower rank only ``batches`` moves: the shards it ran."""

    submitted: int = 0
    admitted: int = 0
    rejected: dict = field(default_factory=dict)  # reason -> count
    completed: int = 0
    failed: int = 0
    deadline_exceeded: int = 0
    shed: int = 0
    retries: int = 0
    batches: int = 0
    batched_requests: int = 0
    padded_rows: int = 0
    max_queued: int = 0
    degrade_events: int = 0
    crash_recoveries: int = 0
    corruption_detected: int = 0    # verify checks that tripped
    corruption_recomputed: int = 0  # quarantined requests later completed

    def __post_init__(self):
        self._lock = threading.Lock()
        self._latencies: list[float] = []

    def bump(self, name: str, by: int = 1) -> None:
        with self._lock:
            setattr(self, name, getattr(self, name) + by)

    def reject(self, reason: str) -> None:
        with self._lock:
            self.rejected[reason] = self.rejected.get(reason, 0) + 1

    def saw_queue(self, depth: int) -> None:
        with self._lock:
            if depth > self.max_queued:
                self.max_queued = depth

    def record_latency(self, total_s: float) -> None:
        with self._lock:
            self._latencies.append(total_s)

    @staticmethod
    def _pct(sorted_vals: list[float], q: float) -> float:
        if not sorted_vals:
            return 0.0
        i = min(len(sorted_vals) - 1, int(math.ceil(q * len(sorted_vals))) - 1)
        return sorted_vals[max(i, 0)]

    def snapshot(self) -> dict:
        with self._lock:
            lat = sorted(self._latencies)
            doc = {k: v for k, v in self.__dict__.items()
                   if not k.startswith("_")}
            doc["rejected"] = dict(self.rejected)
        doc["rejected_total"] = sum(doc["rejected"].values())
        doc["latency"] = {
            "count": len(lat),
            "p50_ms": round(self._pct(lat, 0.50) * 1e3, 3),
            "p99_ms": round(self._pct(lat, 0.99) * 1e3, 3),
            "max_ms": round((lat[-1] if lat else 0.0) * 1e3, 3),
        }
        if self.batches:
            doc["mean_requests_per_launch"] = round(
                self.batched_requests / self.batches, 3)
        return doc


class _TokenBucket:
    """Per-spec admission rate limiter on the service's injectable clock."""

    def __init__(self, rate: float, burst: float, clock):
        self.rate = float(rate)
        self.burst = float(burst)
        self.clock = clock
        self.tokens = float(burst)
        self.t = clock()

    def try_take(self) -> bool:
        now = self.clock()
        self.tokens = min(self.burst,
                          self.tokens + (now - self.t) * self.rate)
        self.t = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False


@dataclass
class _Group:
    """One forming/launched batch: same spec key, FIFO tickets."""

    key: object
    tickets: list
    # ABFT state for verify="abft" launches: the checksum row appended at
    # gather is `verify_weights @ rows[:verify_rows]`; writeback replays
    # the combination on the realized output
    verify_weights: object = None
    verify_rows: int = 0


class FftService:
    """The planned engine behind a bounded, deadline-aware request front.

    Args:
      impl/layout/device: forwarded to every `repro_torch.fft.plan` call;
        ``device`` defaults to "cuda" ("cpu" runs the plain versions).
      mesh/placement: optional `DeviceMesh` for segmented specs; placement
        defaults to "auto" (mesh-free requests resolve local). Over more
        than one rank every rank constructs the service, rank 0 admits
        and the others follow (module docstring).
      control_timeout_s: the bound on every operation of the control
        channel (a mesh of more than one rank only).
      queue_depth: admission bound — a submit is rejected with
        `ServiceOverload(reason="queue_full")` once this many admitted
        requests are outstanding (queued, batching, in flight, or
        retrying — a request holds its slot from admission to
        resolution), so total service occupancy is hard-bounded by
        ``queue_depth``, retries included.
      coalesce: requests per full batch (the dynamic batcher's target).
      max_inflight: launched-but-unrealized batch window (semaphore
        released at realization — the only sync point).
      max_batch_delay_s: how long a short group may wait for company
        before launching as a padded tail.
      default_deadline_s: deadline applied when submit passes none.
      per_spec_qps / per_spec_burst: token-bucket admission per spec key
        (None disables); per_spec_inflight: cap of admitted-incomplete
        requests per spec key (None disables).
      shed_policy: "oldest_deadline" | "smallest_batch" — victim order
        under sustained overload.
      shed_after: consecutive queue-full rejections that trigger a shed;
        shed_fraction: fraction of queued requests shed per trigger.
      retry: the service's ONE `RetryPolicy` (attempts/backoff/clock);
        its clock also times deadlines and latency stats.
      degrade: pass fallback="degrade" to every plan call (re-plans on
        mesh loss instead of raising); injector: `FaultInjector` wired to
        the serve.* sites.
      verify: "off" | "parseval" | "abft" — ABFT silent-corruption
        defense (DESIGN.md §13). "parseval" checks every request's
        output energy against its input energy recorded at admission
        (per-request quarantine); "abft" instead appends one linearity
        checksum row to every
        launch (riding the full-plan padding trick, so a spec key still
        touches at most two plan-cache entries). A failed check raises
        `SilentCorruption`, quarantines the unit (the single request for
        an energy miss, the whole batch for a checksum miss — linearity
        cannot name the culprit row) and recomputes it through the ONE
        retry path; `corruption_detected` / `corruption_recomputed`
        count the round trips.
    """

    def __init__(self, *, impl: str = "matfft", device="cuda",
                 layout: str = "zero_copy", mesh=None,
                 placement: str = "auto", queue_depth: int = 256,
                 coalesce: int = 4, max_inflight: int = 4, writers: int = 2,
                 max_batch_delay_s: float = 0.002,
                 default_deadline_s: float | None = None,
                 per_spec_qps: float | None = None,
                 per_spec_burst: float | None = None,
                 per_spec_inflight: int | None = None,
                 shed_policy: str = "oldest_deadline", shed_after: int = 8,
                 shed_fraction: float = 0.25,
                 retry: RetryPolicy | None = None, degrade: bool = True,
                 injector=None, poll_interval_s: float = 0.001,
                 verify: str = "off", control_timeout_s: float = 60.0,
                 start: bool = True):
        if queue_depth < 1:
            raise ValueError(f"queue_depth must be >= 1, got {queue_depth}")
        if coalesce < 1:
            raise ValueError(f"coalesce must be >= 1, got {coalesce}")
        if shed_policy not in SHED_POLICIES:
            raise ValueError(f"unknown shed_policy {shed_policy!r}; "
                             f"expected one of {SHED_POLICIES}")
        self.impl = impl
        self.device = str(spec_mod.resolve_device(
            mesh.device_type if mesh is not None and device is None
            else device))
        self.layout = layout
        self.mesh = mesh
        self.placement = placement
        self.queue_depth = queue_depth
        self.coalesce = coalesce
        self.max_inflight = max(max_inflight, 1)
        self.max_batch_delay_s = max_batch_delay_s
        self.default_deadline_s = default_deadline_s
        self.per_spec_qps = per_spec_qps
        self.per_spec_burst = (per_spec_burst if per_spec_burst is not None
                               else 2.0 * coalesce)
        self.per_spec_inflight = per_spec_inflight
        self.shed_policy = shed_policy
        self.shed_after = max(shed_after, 1)
        self.shed_fraction = shed_fraction
        self.policy = retry or RetryPolicy()
        self.degrade = degrade
        self.injector = injector
        self.poll_interval_s = poll_interval_s
        self.verify = abft.check_mode(verify)
        self.stats = ServiceStats()
        self._clock = self.policy.clock

        self._admit_lock = threading.Lock()
        self._seq = 0
        self._occupancy = 0          # admitted requests awaiting launch
        self._overload_strikes = 0   # consecutive queue-full rejections
        self._shed_requested = threading.Event()
        self._buckets: dict = {}     # spec key -> _TokenBucket
        self._spec_inflight: dict = {}  # spec key -> admitted-incomplete

        self._queue: queue.SimpleQueue = queue.SimpleQueue()
        self._events: queue.SimpleQueue = queue.SimpleQueue()
        self._pending: dict = {}     # spec key -> deque[FftTicket]
        self._inflight = threading.BoundedSemaphore(self.max_inflight)
        self._outstanding = 0        # launched batches not yet resolved
        self._outstanding_lock = threading.Lock()
        self._closing = threading.Event()   # drain mode: flush then exit
        self._stopped = threading.Event()   # hard stop (close(drain=False))
        self._mesh_epoch = None
        self._batcher: threading.Thread | None = None
        self._writers = ThreadPoolExecutor(max_workers=max(writers, 1))
        #: the control channel over a mesh of more than one rank (None:
        #: this process is the whole service); ``rank`` 0 is the controller
        self._channel = None
        self.rank = 0
        if mesh is not None and mesh.mesh.numel() > 1:
            self._channel = ControlChannel(mesh, control_timeout_s)
            self.rank = self._channel.rank
        self._lost_seen = frozenset()  # the lost ranks last sent or obeyed
        self._followers_stopped = False
        self._follower_error: BaseException | None = None
        if start:
            self.start()

    # ------------------------------------------------------------- lifecycle

    def start(self) -> None:
        """Rank 0 (or a one-rank service): start the batcher. A follower:
        start the loop that obeys rank 0 until its stop message."""
        if self._batcher is not None and (self._batcher.is_alive()
                                          or self.rank != 0):
            return
        if self._closing.is_set():
            raise ServiceClosed("service has been closed")
        loop, name = ((self._batch_loop, "fft-service-batcher")
                      if self.rank == 0
                      else (self._follow_loop, "fft-service-follower"))
        self._batcher = threading.Thread(target=loop, name=name, daemon=True)
        self._batcher.start()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close(drain=exc == (None, None, None))

    def mesh_seconds(self) -> dict | None:
        """Over more than one rank, rank 0's summed seconds in each step
        of its segmented launches (`ControlChannel.seconds`); else None."""
        if self._channel is None:
            return None
        with self._channel._seconds_lock:
            return dict(self._channel.seconds)

    def idle(self) -> bool:
        """True when nothing is queued, pending, or in flight."""
        with self._outstanding_lock:
            outstanding = self._outstanding
        with self._admit_lock:
            occupancy = self._occupancy
        return occupancy == 0 and outstanding == 0

    def close(self, drain: bool = True, timeout: float | None = 30.0) -> None:
        """Stop admitting; drain (launch everything queued, wait for every
        outcome) or cancel pending with `ServiceClosed`. Idempotent.

        Rank 0's close also stops the followers. A follower's close waits
        for that stop, however long rank 0 serves (the channel's timeout
        bounds each wait, not ``timeout``), and raises `ServiceError` if
        its loop failed."""
        if self.rank != 0:
            self.start()
            self._batcher.join()
            self._writers.shutdown(wait=True)
            if self._follower_error is not None:
                raise ServiceError(
                    f"follower {self.rank} of the service's mesh failed: "
                    f"{self._follower_error!r}") from self._follower_error
            return
        self._closing.set()
        if not drain:
            self._stopped.set()
        if self._batcher is not None:
            self._batcher.join(timeout=timeout)
        else:
            # start() was never called (start=False tests): resolve the
            # queue here so close() leaves no ticket forever-pending
            self._stopped.set()
            self._flush_cancelled()
            self._stop_followers()
        self._writers.shutdown(wait=True)
        if self._batcher is None or not self._batcher.is_alive():
            self._flush_cancelled()

    def _flush_cancelled(self) -> None:
        """Resolve everything still queued/pending after a hard stop."""
        while True:
            try:
                t = self._queue.get_nowait()
            except queue.Empty:
                break
            if isinstance(t, FftTicket):
                self._complete(t, error=ServiceClosed(
                    "service closed before the request launched"))
        for dq in self._pending.values():
            while dq:
                self._complete(dq.popleft(), error=ServiceClosed(
                    "service closed before the request launched"))

    # ------------------------------------------------------------- admission

    def submit(self, kind: str, *operands, shape=None,
               deadline_s: float | None = None) -> FftTicket:
        """Submit one transform; never blocks, always returns a ticket.

        kind="c2c" takes planar ``(xr, xi)``; kind="r2c" takes real
        ``(x,)``. The trailing ``shape`` axes (default: the last axis) are
        the transform; leading axes collapse into batch rows. Rejections
        resolve the ticket immediately with a structured error. Only rank
        0 admits: a follower's submit raises `ServiceError`.
        """
        if self.rank != 0:
            raise ServiceError(
                f"rank {self.rank} of the service's mesh is a follower: "
                f"only rank 0 admits requests")
        now = self._clock()
        with self._admit_lock:
            seq = self._seq
            self._seq += 1
        dl = deadline_s if deadline_s is not None else self.default_deadline_s
        ops, shape_t, rows, squeeze = self._normalize_operands(
            kind, operands, shape)
        ticket = FftTicket(seq, kind, shape_t, rows, dl)
        ticket._operands = ops
        ticket._squeeze = squeeze
        if self.verify == "parseval":
            # the Parseval baseline: input energy measured at the trust
            # boundary, before the request ever touches service state.
            # abft mode skips this — the checksum row is the (stronger)
            # invariant and the per-request energy passes were the
            # dominant verification cost.
            ticket._energy = abft.energy(*ops)
        ticket._t_submit = now
        ticket._deadline_at = None if dl is None else now + dl
        # spec-key resolution validates the transform up front (pow2 axes,
        # placement feasibility) — a bad spec is a synchronous ValueError,
        # a client bug rather than a service condition
        ticket._key = self._spec_key(kind, shape_t, rows)
        self.stats.bump("submitted")

        if self._closing.is_set():
            return self._reject(ticket, ServiceClosed(
                "service is shutting down"), reason="closed")
        try:
            maybe_fire(self.injector, "serve.admit", seq)
        except IOError as e:
            self.stats.reject("admit_fault")
            return self._reject(ticket, RequestFailed("admit", 1, e),
                                reason=None)
        with self._admit_lock:
            if self._occupancy >= self.queue_depth:
                self._overload_strikes += 1
                if self._overload_strikes >= self.shed_after:
                    self._shed_requested.set()
                err = ServiceOverload(
                    "queue_full",
                    f"{self._occupancy} queued >= depth {self.queue_depth}")
                reject = err
            elif not self._admit_spec(ticket._key):
                reject = self._spec_rejection(ticket._key)
            else:
                self._overload_strikes = 0
                self._occupancy += 1
                ticket._occupies = True
                self._spec_inflight[ticket._key] = (
                    self._spec_inflight.get(ticket._key, 0) + 1)
                self.stats.saw_queue(self._occupancy)
                reject = None
        if reject is not None:
            return self._reject(ticket, reject, reason=reject.reason)
        self.stats.bump("admitted")
        self._queue.put(ticket)
        return ticket

    def _reject(self, ticket: FftTicket, err: ServiceError,
                reason: str | None) -> FftTicket:
        if reason is not None:
            self.stats.reject(reason)
        ticket.error = err
        ticket._event.set()
        return ticket

    def _admit_spec(self, key) -> bool:
        """Per-spec admission (called under _admit_lock)."""
        if (self.per_spec_inflight is not None
                and self._spec_inflight.get(key, 0) >= self.per_spec_inflight):
            return False
        if self.per_spec_qps is not None:
            bucket = self._buckets.get(key)
            if bucket is None:
                bucket = self._buckets[key] = _TokenBucket(
                    self.per_spec_qps, self.per_spec_burst, self._clock)
            if not bucket.try_take():
                return False
        return True

    def _spec_rejection(self, key) -> ServiceOverload:
        if (self.per_spec_inflight is not None
                and self._spec_inflight.get(key, 0) >= self.per_spec_inflight):
            return ServiceOverload(
                "inflight_cap",
                f"{self._spec_inflight.get(key, 0)} inflight for this spec")
        return ServiceOverload("rate_limit",
                               f"{self.per_spec_qps}/s token bucket empty")

    @staticmethod
    def _normalize_operands(kind, operands, shape):
        if kind not in ("c2c", "r2c"):
            raise ValueError(f"kind must be 'c2c' or 'r2c', got {kind!r}")
        want = 2 if kind == "c2c" else 1
        if len(operands) != want:
            raise ValueError(
                f"kind={kind!r} takes {want} operand(s) "
                f"({'xr, xi' if want == 2 else 'x'}), got {len(operands)}")
        ops = tuple(np.ascontiguousarray(o, dtype=np.float32)
                    for o in operands)
        if any(o.shape != ops[0].shape for o in ops[1:]):
            raise ValueError(
                f"operand shapes differ: {[o.shape for o in ops]}")
        full = ops[0].shape
        if shape is None:
            if not full:
                raise ValueError("operands must have at least one axis")
            shape_t = (int(full[-1]),)
        else:
            shape_t = ((int(shape),) if isinstance(shape, int)
                       else tuple(int(d) for d in shape))
        if len(shape_t) > len(full) or tuple(full[-len(shape_t):]) != shape_t:
            raise ValueError(
                f"trailing operand axes {full} do not match transform "
                f"shape {shape_t}")
        rows = int(math.prod(full[:-len(shape_t)] or (1,)))
        squeeze = len(full) == len(shape_t)
        ops = tuple(o.reshape(rows, *shape_t) for o in ops)
        return ops, shape_t, rows, squeeze

    def _spec_key(self, kind: str, shape: tuple, rows: int):
        """The resolved `FftSpec` cache key modulo batch rows — requests
        that share it can share a plan at any coalesced batch size."""
        num_devices = (int(self.mesh.mesh.numel())
                       if self.mesh is not None else None)
        resolved = spec_mod.resolve(
            kind=kind, shape=shape, batch_shape=(rows,),
            placement=self.placement, layout=self.layout, impl=self.impl,
            device=self.device, num_devices=num_devices,
            verify=self.verify)
        return replace(resolved, batch_shape=(rows,), placement="auto")

    # --------------------------------------------------------------- batcher

    def _plan(self, key, total_rows: int):
        """The plan of a ``total_rows`` launch; over more than one rank,
        after rank 0 has sent the lost ranks it plans on (`_sync_health`;
        the caller holds `_held`)."""
        self._sync_health()
        return self._plan_for(key.kind, key.shape, total_rows)

    def _plan_for(self, kind: str, shape: tuple, total_rows: int):
        import repro_torch.fft as fft_api
        return fft_api.plan(
            kind=kind, shape=shape, batch_shape=(total_rows,),
            impl=self.impl, device=self.device, layout=self.layout,
            mesh=self.mesh, placement=self.placement,
            fallback="degrade" if self.degrade else "error",
            verify=self.verify)

    def warmup(self, profile) -> dict:
        """Pre-plan and pre-build every batch size a hot spec can hit.

        ``profile`` is an iterable of ``{"kind", "shape", "rows"}`` dicts
        (or ``(kind, shape, rows)`` tuples) describing expected traffic.
        For each record this plans BOTH sizes the batcher can dispatch —
        the singleton (``rows`` + the ABFT checksum row if enabled) and
        the full coalesced batch (``coalesce * rows`` + checksum) — and
        runs zeros through each plan once, so its tables are on the
        device, its kernels built and bound and its stream created. After
        warmup, the first real request for a profiled spec causes ZERO
        plan-cache misses and zero builds. Over more than one rank this
        warms rank 0 (its shard of a segmented plan); followers build at
        their first launch.

        Returns a summary: specs seen, plans warmed, and the cache_info
        snapshot afterwards.
        """
        import repro_torch.fft as fft_api
        extra = 1 if self.verify == "abft" else 0
        specs = plans = 0
        for rec in profile:
            if isinstance(rec, dict):
                kind = rec.get("kind", "c2c")
                shape = rec["shape"]
                rows = int(rec.get("rows", 1))
            else:
                kind, shape, rows = rec
                rows = int(rows)
            shape_t = ((int(shape),) if isinstance(shape, int)
                       else tuple(int(d) for d in shape))
            key = self._spec_key(kind, shape_t, rows)
            specs += 1
            for total in sorted({rows + extra,
                                 self.coalesce * rows + extra}):
                with self._held():
                    p = self._plan(key, total)
                if p.mesh is not None and p.mesh.get_coordinate() is None:
                    continue  # rank 0 holds no shard of a shrunk mesh
                ops = [np.zeros(p.operand_shape, np.float32)
                       for _ in range(1 if kind == "r2c" else 2)]
                if kind == "r2c":
                    p.execute_real(*ops)
                else:
                    p.execute(*ops)
                if p.device.type == "cuda":
                    torch.cuda.synchronize(p.device)
                plans += 1
        return {"specs": specs, "plans": plans,
                "cache_info": fft_api.cache_info()}

    def _batch_loop(self) -> None:
        while True:
            try:
                if self._step():
                    break
            except Exception as e:  # crash containment: fail only what we
                # hold, recover to an empty-but-serving state
                self.stats.bump("crash_recoveries")
                record_event("service_crash_recovered", error=repr(e))
        self._stop_followers()

    def _step(self) -> bool:
        """One batcher iteration; True = drained and done, exit the loop."""
        self._keepalive()
        self._drain_events()
        self._check_mesh_epoch()
        self._sweep_deadlines()
        if self._shed_requested.is_set():
            self._shed_requested.clear()
            self._shed()
        if self._stopped.is_set():
            self._flush_cancelled()
            return self._quiesced()
        # move newly admitted tickets into their spec groups
        moved = 0
        while True:
            try:
                t = self._queue.get(
                    timeout=0 if moved else self.poll_interval_s)
            except queue.Empty:
                break
            if isinstance(t, FftTicket):
                self._pending.setdefault(t._key, deque()).append(t)
                moved += 1
        now = self._clock()
        draining = self._closing.is_set()
        for key in list(self._pending):
            dq = self._pending.get(key)
            if not dq:
                self._pending.pop(key, None)
                continue
            while len(dq) >= self.coalesce:
                self._launch(_Group(key, [dq.popleft()
                                          for _ in range(self.coalesce)]))
            if dq and (draining
                       or now - dq[0]._t_submit >= self.max_batch_delay_s):
                # empty the queue before the launch: a retry routed back
                # while `_launch` waits for a slot joins it, and waits
                group = _Group(key, list(dq))
                dq.clear()
                self._launch(group)
        if draining:
            return self._quiesced()
        return False

    def _quiesced(self) -> bool:
        with self._outstanding_lock:
            outstanding = self._outstanding
        return (outstanding == 0 and self._events.empty()
                and not any(self._pending.values()) and self._queue.empty())

    def _drain_events(self) -> None:
        while True:
            try:
                kind, payload = self._events.get_nowait()
            except queue.Empty:
                return
            if kind == "retry":
                for t in payload:
                    self._pending.setdefault(t._key, deque()).appendleft(t)

    def _check_mesh_epoch(self) -> None:
        if self.mesh is None:
            return
        from repro_torch.core.resilience import meshstate
        epoch = meshstate.epoch()
        if self._mesh_epoch is None:
            self._mesh_epoch = epoch
        elif epoch != self._mesh_epoch:
            self._mesh_epoch = epoch
            self.stats.bump("degrade_events")
            record_event(
                "service_degrade", reason="device_loss", epoch=epoch,
                action=("replan_fallback_degrade" if self.degrade
                        else "none"))

    def _sweep_deadlines(self) -> None:
        now = self._clock()
        for dq in self._pending.values():
            kept = [t for t in dq if not self._shed_if_late(t, now)]
            if len(kept) != len(dq):
                dq.clear()
                dq.extend(kept)

    def _shed_if_late(self, t: FftTicket, now: float) -> bool:
        if t._deadline_at is None or now < t._deadline_at:
            return False
        self.stats.bump("deadline_exceeded")
        self._complete(t, error=DeadlineExceeded(
            t.deadline_s, queue_s=now - t._t_submit, stage="queue"))
        return True

    def _shed(self) -> None:
        """Sustained overload: drop queued requests by policy."""
        self._drain_events()
        while True:  # pull everything admitted so victims see the whole set
            try:
                t = self._queue.get_nowait()
            except queue.Empty:
                break
            if isinstance(t, FftTicket):
                self._pending.setdefault(t._key, deque()).append(t)
        total = sum(len(dq) for dq in self._pending.values())
        if total == 0:
            return
        n_shed = max(1, int(math.ceil(self.shed_fraction * total)))
        victims: list[FftTicket] = []
        if self.shed_policy == "oldest_deadline":
            flat = [t for dq in self._pending.values() for t in dq]
            flat.sort(key=lambda t: (t._deadline_at is None,
                                     t._deadline_at or 0.0, t.seq))
            victims = flat[:n_shed]
        else:  # smallest_batch: break the worst-coalescing groups first
            for key in sorted(self._pending,
                              key=lambda k: len(self._pending[k])):
                for t in self._pending[key]:
                    if len(victims) >= n_shed:
                        break
                    victims.append(t)
                if len(victims) >= n_shed:
                    break
        chosen = {id(t) for t in victims}
        for dq in self._pending.values():
            kept = [t for t in dq if id(t) not in chosen]
            dq.clear()
            dq.extend(kept)
        for t in victims:
            self.stats.bump("shed")
            self._complete(t, error=ServiceOverload(
                "shed", f"load shed ({self.shed_policy})"))
        self.stats.bump("degrade_events")
        record_event("service_degrade", reason="overload",
                     policy=self.shed_policy, shed=len(victims),
                     queued=total)

    # --------------------------------------------------------------- launch

    def _launch(self, group: _Group) -> None:
        now = self._clock()
        group.tickets = [t for t in group.tickets
                         if not self._shed_if_late(t, now)]
        if not group.tickets:
            return
        for t in group.tickets:
            t._t_formed = now
            t.attempts += 1
        while not self._inflight.acquire(timeout=self.poll_interval_s):
            self._keepalive()
            self._drain_events()
            if self._stopped.is_set():
                for t in group.tickets:
                    self._complete(t, error=ServiceClosed(
                        "service closed before the request launched"))
                return
        try:
            if self.injector is not None:
                self.injector.fire_group(
                    "serve.batch", [t.seq for t in group.tickets])
            handle, pad_rows = self._gather_and_launch(group)
        except BaseException as e:
            self._inflight.release()
            self._fail_group(group, e, stage="batch")
            return
        self.stats.bump("batches")
        self.stats.bump("batched_requests", len(group.tickets))
        self.stats.bump("padded_rows", pad_rows)
        with self._outstanding_lock:
            self._outstanding += 1
        self._writers.submit(self._writeback, group, handle)

    def _gather_and_launch(self, group: _Group):
        """Host gather into one batch + async dispatch; the 2-plan trick:
        a singleton group runs the SINGLE-request plan, anything larger
        pads up to the FULL ``coalesce x rows`` batch."""
        key = group.key
        rows = group.tickets[0].rows
        n_ops = len(group.tickets[0]._operands)
        extra = 1 if self.verify == "abft" else 0
        if len(group.tickets) == 1 and not extra:
            total = rows
            ops = group.tickets[0]._operands
        else:
            total = rows if len(group.tickets) == 1 \
                else self.coalesce * rows
            ops = []
            for i in range(n_ops):
                buf = np.zeros((total + extra, *key.shape), np.float32)
                r0 = 0
                for t in group.tickets:
                    buf[r0:r0 + rows] = t._operands[i]
                    r0 += rows
                ops.append(buf)
            if extra:
                # one linearity checksum row rides the batch: its
                # transform must equal the same weighted combination of
                # the rows' transforms (weights recomputable at
                # writeback from `total` alone — no state to thread)
                w = abft.checksum_weights(total, seed=total)
                for buf in ops:
                    buf[total] = (w @ buf[:total].reshape(
                        total, -1)).reshape(key.shape)
                group.verify_weights = w
                group.verify_rows = total
        pad_rows = total - rows * len(group.tickets)
        with self._held():
            plan = self._plan(key, total + extra)
            t0 = self._clock()
            if self._channel is not None and plan.placement == "segmented":
                out = self._launch_on_mesh(plan, ops)
            else:
                out = plan.execute_async(*ops)
        for t in group.tickets:
            t._t_launch = t0
            t.batch_rows = total + extra
        return out, pad_rows

    def _writeback(self, group: _Group, handle) -> None:
        try:
            self._writeback_inner(group, handle)
        finally:
            # decrement AFTER any retry events are queued, so the drain
            # exit condition can't observe outstanding == 0 with retries
            # still unrouted
            with self._outstanding_lock:
                self._outstanding -= 1

    def _corrupt_host(self, host, group: _Group):
        """Seeded silent-corruption checkpoint: perturb a hit ticket's
        realized rows AFTER every integrity/fault hook has run — only the
        ABFT invariants stand between this and the client."""
        if self.injector is None:
            return host
        rows = group.tickets[0].rows
        out = list(host)
        r0 = 0
        for t in group.tickets:
            scale = self.injector.corrupt_scale("serve.execute", t.seq)
            if scale is not None:
                for k, a in enumerate(out):
                    if not a.flags.writeable:
                        a = out[k] = np.array(a, copy=True)
                    perturb_array(a[r0:r0 + rows], scale,
                                  corrupt_salt("serve.execute", t.seq, k))
            r0 += rows
        return tuple(out)

    def _verify_group(self, host, group: _Group) -> None:
        """The batch-level linearity check; a miss quarantines the WHOLE
        group (the checksum residual cannot name the culprit row)."""
        if group.verify_weights is None:
            return
        abft.check_checksum(
            host, group.verify_weights, int(math.prod(group.key.shape)),
            "f32", site="serve.execute", index=group.tickets[0].seq,
            seqs=[t.seq for t in group.tickets])

    def _verify_member(self, t: FftTicket, value) -> None:
        """Per-request Parseval: output energy vs the energy recorded at
        admission; a miss quarantines just this request."""
        if t._energy is None:
            return
        n = int(math.prod(t.shape))
        if t.kind == "r2c":
            e_out = abft.energy_onesided(value[0], value[1], n)
        else:
            e_out = abft.energy(*value)
        abft.check_parseval(t._energy, e_out, n, "f32",
                            site="serve.execute", index=t.seq)

    def _writeback_inner(self, group: _Group, handle) -> None:
        try:
            try:
                host = handle.realize()  # the only host wait
            finally:
                self._inflight.release()
            if self.injector is not None:
                self.injector.fire_group(
                    "serve.execute", [t.seq for t in group.tickets])
            host = self._corrupt_host(host, group)
            self._verify_group(host, group)
        except BaseException as e:
            self._fail_group(group, e, stage="execute")
            return
        now = self._clock()
        rows = group.tickets[0].rows
        r0 = 0
        for t in group.tickets:
            value = tuple(a[r0] if t._squeeze else a[r0:r0 + rows]
                          for a in host)
            r0 += rows
            try:
                self._verify_member(t, value)
            except abft.SilentCorruption as e:
                self._fail_group(_Group(group.key, [t]), e, stage="execute")
                continue
            t.timings = {
                "queue_s": t._t_formed - t._t_submit,
                "batch_s": t._t_launch - t._t_formed,
                "execute_s": now - t._t_launch,
                "total_s": now - t._t_submit,
            }
            if t._deadline_at is not None and now > t._deadline_at:
                # end-to-end enforcement: a result realized too late is a
                # deadline miss, even though the math is done
                self.stats.bump("deadline_exceeded")
                self._complete(t, error=DeadlineExceeded(
                    t.deadline_s, stage="execute", **{
                        k: v for k, v in t.timings.items() if k != "total_s"}))
            else:
                self.stats.record_latency(t.timings["total_s"])
                self._complete(t, value=value)

    def _fail_group(self, group: _Group, err: BaseException,
                    stage: str) -> None:
        """Batch failure: admit each member into the retry path or fail it.

        Runs on the batcher (pre-launch faults) or a writeback worker;
        retryable members are routed back to the batcher via the events
        queue so pending state stays single-threaded.
        """
        retry: list[FftTicket] = []
        now = self._clock()
        if isinstance(err, abft.SilentCorruption):
            self.stats.bump("corruption_detected")
            for t in group.tickets:
                t._corrupt_hit = True
        for t in group.tickets:
            elapsed = now - t._t_submit
            late = t._deadline_at is not None and now >= t._deadline_at
            if (not late
                    and self.policy.should_retry(t.attempts, elapsed, err)):
                self.stats.bump("retries")
                retry.append(t)
            elif late:
                self.stats.bump("deadline_exceeded")
                self._complete(t, error=DeadlineExceeded(
                    t.deadline_s, queue_s=t._t_formed - t._t_submit,
                    batch_s=now - t._t_formed, stage=stage))
            else:
                self._complete(t, error=RequestFailed(stage, t.attempts, err))
        if retry:
            self._events.put(("retry", retry))

    # --------------------------------------------------- the mesh protocol

    @contextlib.contextmanager
    def _held(self):
        """Over more than one rank: the lost ranks stay as they are, and no
        other thread of rank 0 sends, until the block ends."""
        if self._channel is None:
            yield
            return
        from repro_torch.core.resilience import meshstate
        with meshstate.held(), self._channel.lock:
            yield

    def _mesh_lost(self) -> frozenset:
        from repro_torch.core.resilience import meshstate
        return meshstate.lost_devices() & frozenset(self._channel.ranks)

    def _send(self, op: str, **fields) -> None:
        """Rank 0: one message to every follower, carrying the mesh's lost
        ranks; a change in them is obeyed at once (`_obey_health`)."""
        from repro_torch.core.resilience import meshstate
        with self._held():
            lost = self._mesh_lost()
            self._channel.send({"op": op, "lost": sorted(lost),
                                "epoch": meshstate.epoch(), **fields})
            self._obey_health(lost)

    def _obey_health(self, lost: frozenset) -> None:
        """Every rank, at the same message: a follower marks the lost ranks
        rank 0 sent, then all build the shrunk mesh together (collective),
        before anyone plans on it."""
        if lost == self._lost_seen:
            return
        from repro_torch.core.resilience import meshstate
        if self.rank != 0:
            own = self._mesh_lost()
            meshstate.restore_devices(own - lost)
            meshstate.lose_devices(lost - own)
        self._lost_seen = lost
        if lost:
            meshstate.shrunk_mesh(self.mesh)

    def _sync_health(self) -> None:
        """Rank 0, before it plans: tell the followers of a changed set of
        lost ranks (the caller holds `_held`)."""
        if self._channel is not None and self._mesh_lost() != self._lost_seen:
            self._send("health")

    def _keepalive(self) -> None:
        """Rank 0: a no-op after a quarter of the channel's timeout of
        silence, so an idle follower's wait never times out."""
        ch = self._channel
        if ch is not None and (time.monotonic() - ch.last_send
                               >= ch.keepalive_s):
            self._send("noop")

    def _stop_followers(self) -> None:
        if self._channel is None or self._followers_stopped:
            return
        self._followers_stopped = True
        self._send("stop")
        self._channel.close()

    def _launch_on_mesh(self, plan, ops) -> _MeshResult:
        """Rank 0: send a segmented launch, scatter the shards, run its own
        and start the gather (the caller holds `_held`)."""
        from repro_torch.core.fft import distributed
        ch = self._channel
        total, k = ops[0].shape[0], plan.num_devices
        in_shape, out_shape = _shard_shapes(plan.kind, plan.shape, total, k)
        rows = in_shape[1]
        shard_of = {g: distributed.axis_index(plan.mesh, plan.spec.axes, g)
                    for g in plan.mesh.mesh.reshape(-1).tolist()}
        parts, order, filler = [], [None] * k, None
        with ch.timed("shard"):
            stacked = np.stack(ops)
            for i, g in enumerate(ch.ranks):
                s = shard_of.get(g)
                if s is None:  # outside a shrunk mesh: it holds no shard
                    if filler is None:
                        filler = torch.zeros(in_shape)
                    parts.append(filler)
                    continue
                parts.append(torch.from_numpy(np.ascontiguousarray(
                    stacked[:, s * rows:(s + 1) * rows])))
                order[s] = i
        self._send("launch", kind=plan.kind, shape=list(plan.shape),
                   rows=total, devices=k)
        own = ch.scatter(in_shape, parts)
        local = error = None
        if 0 in order:
            try:
                local = plan.execute_async(*own.unbind(0))
            except Exception as e:  # the gather must still go out
                error = e
        work, got = ch.gather(torch.zeros(math.prod(out_shape) + 1))
        return _MeshResult(local, error, work, got, order, out_shape, ch)

    def _follow_loop(self) -> None:
        """A follower: obey rank 0's messages until its stop."""
        try:
            while True:
                msg = self._channel.recv()
                self._obey_health(frozenset(msg["lost"]))
                if msg["op"] == "stop":
                    break
                if msg["op"] == "launch":
                    self._follow_launch(msg)
            self._channel.close()
        except Exception as e:  # close() raises it
            self._follower_error = e
            record_event("service_follower_failed", rank=self.rank,
                         error=repr(e))

    def _follow_launch(self, msg: dict) -> None:
        """A follower's part of one segmented launch: plan as rank 0 did,
        take its shard, run it and send the realized rows back, with a
        status value that tells rank 0 whether it computed them."""
        kind, shape = msg["kind"], tuple(msg["shape"])
        total, k = msg["rows"], msg["devices"]
        in_shape, out_shape = _shard_shapes(kind, shape, total, k)
        out = torch.zeros(math.prod(out_shape) + 1)
        out[-1] = 1.0
        try:
            plan = self._plan_for(kind, shape, total)
            if (plan.placement, plan.num_devices) != ("segmented", k):
                raise RuntimeError(
                    f"rank {self.rank} planned {plan.placement!r} on "
                    f"{plan.num_devices} ranks, rank 0 segmented on {k}")
        except Exception as e:
            plan = None
            record_event("service_follower_failed", rank=self.rank,
                         error=repr(e))
        shard = self._channel.scatter(in_shape)
        if plan is not None and plan.mesh.get_coordinate() is not None:
            try:
                yr, yi = plan.execute_async(*shard.unbind(0)).realize()
                out[:-1] = torch.from_numpy(np.stack([yr, yi])).reshape(-1)
                out[-1] = 0.0
                self.stats.bump("batches")
            except Exception as e:
                record_event("service_follower_failed", rank=self.rank,
                             error=repr(e))
        self._channel.gather(out)[0].wait()

    # ------------------------------------------------------------ completion

    def _complete(self, t: FftTicket, value=None,
                  error: BaseException | None = None) -> None:
        if t._event.is_set():
            return
        t.value = value
        t.error = error
        if t._occupies:
            t._occupies = False
            with self._admit_lock:
                self._occupancy -= 1
                left = self._spec_inflight.get(t._key, 0) - 1
                if left > 0:
                    self._spec_inflight[t._key] = left
                else:
                    self._spec_inflight.pop(t._key, None)
        if error is None:
            self.stats.bump("completed")
            if t._corrupt_hit:
                self.stats.bump("corruption_recomputed")
        elif isinstance(error, RequestFailed):
            self.stats.bump("failed")
        t._event.set()
