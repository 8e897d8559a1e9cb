"""Streaming overlapped block pipeline: the paper's map-wave/I/O overlap,
made explicit instead of emergent.

The serial `MapOnlyJob` path runs read -> decode -> H2D -> execute ->
block_until_ready -> D2H -> encode -> write per block, so the device idles
during every byte of I/O and each block pays a full dispatch round-trip.
This module restructures the job as a staged stream (EFFT, arXiv:1409.5757
— double-buffered streaming hides disk/transfer behind compute; and
arXiv:2202.12756 — batch many transforms per launch):

  read     reader threads: block I/O + crc verify + zero-copy decode
           (strided views over the block bytes). The bounded decoded
           queue is the prefetch back-pressure — readers block when the
           device side lags, capping host memory however far I/O could
           run ahead.
  h2d      the single dispatcher coalesces up to `coalesce` same-shaped
           blocks into ONE device batch (the `cufftPlanMany` amortization:
           one cached plan at batch coalesce x segments_per_block, plus one
           remainder-tail plan), gathering them into reusable preallocated
           staging buffers (`StagingPool`; pinned host memory when the
           device is a CUDA card) that feed the async launch.
  compute  `plan.execute_async` — the host-to-device copy and the kernels
           are queued on the plan's CUDA stream and an event is recorded;
           nothing waits for the device in the hot path. The dispatcher keeps
           at most `inflight` launched batches outstanding (a semaphore
           released by the writeback stage once a batch's D2H completes):
           when the window is full, dispatch stalls until the OLDEST
           in-flight batch realizes — that window boundary is the only
           sync point in the pipeline.
  d2h      writeback workers realize device results (wait on the batch's
           event, copy to host) while the dispatcher is already launching
           later batches.
  write    same workers: per-block encode + atomic offset-named writes.

Retry / speculation / manifest semantics match `MapOnlyJob`: every
transition journaled (RUNNING at dispatch into the pipeline, DONE after
the block's output write, PENDING again on retry), bounded per-block retry
budgets, and straggler speculation — a block whose attempt exceeds
``straggler_factor`` x the median completed latency is re-injected as a
duplicate attempt; atomic idempotent writes make whichever finishes first
the winner. `MapOnlyJob(pipelined=True)` routes here.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from concurrent.futures import TimeoutError as FuturesTimeout
from dataclasses import dataclass
from statistics import median
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.pipeline.blockstore import BlockStore
from repro_torch.core.pipeline.maponly import (DONE, FAILED, PENDING, RUNNING,
                                         JobConfig, JobStats, Manifest)
from repro_torch.core.pipeline.records import block_of_segments
from repro_torch.core.resilience import verify as abft
from repro_torch.core.resilience.faults import (corrupt_salt, maybe_fire,
                                          perturb_array)

STAGES = ("read", "h2d", "compute", "d2h", "write")


class _Stop(Exception):
    """Internal: pipeline is shutting down (fatal error elsewhere)."""


class StagingPool:
    """Bounded pool of reusable host staging buffers, keyed by shape.

    Holds the preallocated batch buffers the dispatcher gathers into
    (`SegmentFFTTransform.gather`): float32 CPU tensors, page-locked
    (``pinned``) when they feed a CUDA card, so their host-to-device copies
    run asynchronously. ``acquire`` blocks when ``capacity`` buffer sets
    are outstanding, bounding staging memory at O(capacity x batch)
    regardless of input size; a set is released back only once its batch
    has been realized (device provably done), which is what makes handing
    the buffers to an asynchronous copy (``donate``) safe.
    """

    def __init__(self, capacity: int, stop: threading.Event,
                 pinned: bool = False):
        self.capacity = capacity
        self.pinned = pinned
        self._stop = stop
        self._cv = threading.Condition()
        self._free: dict[tuple, list] = {}
        self._outstanding = 0

    def acquire(self, shape: tuple, count: int = 2):
        """Return ``count`` float32 tensors of ``shape`` (re/im planes)."""
        with self._cv:
            while self._outstanding >= self.capacity:
                if self._stop.is_set():
                    raise _Stop
                self._cv.wait(timeout=0.05)
            self._outstanding += 1
            free = self._free.get(shape)
            if free:
                return free.pop()
        try:
            return tuple(torch.empty(shape, dtype=torch.float32,
                                     pin_memory=self.pinned)
                         for _ in range(count))
        except BaseException:  # allocation failed: give the slot back
            with self._cv:
                self._outstanding -= 1
                self._cv.notify()
            raise

    def release(self, shape: tuple, bufs) -> None:
        with self._cv:
            self._outstanding -= 1
            self._free.setdefault(shape, []).append(bufs)
            self._cv.notify()

    def wake_all(self) -> None:
        with self._cv:
            self._cv.notify_all()


@dataclass
class Decoded:
    """One decoded block waiting in the dispatcher's coalesce group.

    ``arrays`` must be cheap views (the block bytes themselves are the
    prefetch memory); pooled staging is acquired in ``gather``, never
    here, so dropping a Decoded needs no cleanup.
    """
    index: int
    arrays: tuple          # host views consumed by gather()/launch()
    rows: int              # batch rows this block contributes
    key: Any               # coalesce group key (None = never coalesce)
    energy: float | None = None  # input energy at decode (CRC-clean
    #                              bytes), consumed by the Parseval check


class StreamTransform:
    """decode / launch / realize / encode hooks for `StreamExecutor`.

    ``launch`` must be asynchronous (return unrealized device values);
    ``realize`` is the only place a sync may happen. Blocks whose ``key``
    matches are coalesced into one ``launch`` group, so all hooks must be
    thread-safe: decode runs on reader threads, launch on the dispatcher,
    realize/encode on writeback workers.
    """

    def open(self, pool_capacity: int, stop: threading.Event) -> None:
        """Called once before streaming starts (allocate staging here)."""

    def decode(self, data: bytes, index: int) -> Decoded:
        raise NotImplementedError

    def gather(self, group: list[Decoded]):
        """Host-side batch assembly (the h2d stage clock). After this
        returns, the group's staging buffers may be reused."""
        return group

    def launch(self, batch):
        raise NotImplementedError

    def realize(self, handle):
        raise NotImplementedError

    def discard(self, batch) -> None:
        """Release a gathered batch that will never launch (failure path);
        must be safe to call on any successful `gather` result."""

    def close(self) -> None:
        """Called once when streaming ends (release pools/executors)."""

    def verify_group(self, host, group: list[Decoded]) -> None:
        """ABFT invariants over a whole realized batch (e.g. the linearity
        checksum row). Runs on writeback workers AFTER the corruption
        checkpoint; raising `SilentCorruption` quarantines every member
        back into the retry path."""

    def verify_member(self, host, row0: int, d: Decoded) -> None:
        """Per-block invariant (e.g. Parseval vs the energy recorded at
        decode). Raising quarantines just this member."""

    def encode(self, host, row0: int, d: Decoded) -> bytes:
        raise NotImplementedError


class MapFnTransform(StreamTransform):
    """Adapter: a classic ``map_fn(bytes, index) -> bytes`` map task.

    No coalescing (opaque bytes have no batchable shape). ``launch``
    submits ``map_fn`` to a small compute pool and returns the future, so
    the dispatcher never blocks on a map task — read/compute/write all
    overlap, and a hung ``map_fn`` still leaves the dispatcher free to
    speculate a twin attempt (matching the serial path's semantics).
    ``realize`` (the writeback stage) is where the future resolves.

    Known limit: a PERMANENTLY hung ``map_fn`` strands its (non-daemon)
    pool thread — ``run()`` still returns via the twin and ``close()``
    won't block (``shutdown(wait=False)``), but interpreter exit joins
    the stuck thread. Twin rescue also has a capacity bound: each hung
    attempt pins one inflight-window slot and one writeback worker until
    shutdown, so the stream survives up to min(inflight, writers) - 1
    SIMULTANEOUSLY hung blocks — the analogue of the serial path, which
    survives hung < workers (and, worse, never returns from ``run()``
    when they persist, blocked in pool shutdown). Size ``inflight`` /
    ``writers`` above the expected straggler count; a truly hung task
    needs a process-level timeout either way.
    """

    def __init__(self, map_fn: Callable[[bytes, int], bytes]):
        self.map_fn = map_fn
        self._pool: ThreadPoolExecutor | None = None
        self._stop: threading.Event | None = None

    def open(self, pool_capacity: int, stop: threading.Event) -> None:
        self._pool = ThreadPoolExecutor(max_workers=pool_capacity)
        self._stop = stop

    def close(self) -> None:
        if self._pool is not None:
            # wait=False: a genuinely hung map task must not hang close
            self._pool.shutdown(wait=False)
            self._pool = None

    def decode(self, data: bytes, index: int) -> Decoded:
        return Decoded(index=index, arrays=(data,), rows=1, key=None)

    def launch(self, batch):
        (d,) = batch
        if self._pool is None:  # transform used outside an executor
            return self.map_fn(d.arrays[0], d.index)
        return self._pool.submit(self.map_fn, d.arrays[0], d.index)

    def realize(self, handle):
        if isinstance(handle, Future):
            # stop-aware wait: when the job shuts down (e.g. a twin won
            # and the hung primary is abandoned) writeback must not block
            # shutdown on a future that will never resolve
            while True:
                try:
                    return handle.result(timeout=0.1)
                except FuturesTimeout:
                    if self._stop is not None and self._stop.is_set():
                        raise _Stop
        return handle

    def encode(self, host, row0: int, d: Decoded) -> bytes:
        return host


class SegmentFFTTransform(StreamTransform):
    """The paper's workload: each block is a batch of complex FFT segments.

    decode is zero-copy (strided re/im views of the raw block bytes);
    gather deinterleaves the whole group straight INTO a preallocated
    reusable batch staging buffer (`np.concatenate(..., out=)` — exactly
    one host copy per plane, the same copy the serial path pays for
    `ascontiguousarray`); launch fires the cached plan's `execute_async`
    on that buffer. Same-shaped groups reuse exactly one plan; the
    remainder tail keys a second — the plan-cache key includes
    `batch_shape`, so coalescing changes it by design (DESIGN.md §7).

    A staging buffer returns to the pool only in `realize`, i.e. after the
    device is provably done with it — this is what makes `donate=True`
    safe: the pinned memory an asynchronous host-to-device copy reads is
    never rewritten while a launched batch may still read it.

    ``verify`` (DESIGN.md §13): "parseval" records each block's input
    energy at decode (the bytes are CRC-clean there) and checks the
    realized spectrum's energy against it per member — detection
    localizes to one block, so only that block retries. "abft" instead
    appends ONE seeded checksum row to every gathered batch — its
    transform must equal the weighted combination of the batch rows'
    transforms (linearity), checked group-wide before encode; it catches
    corruption the energy check cannot (e.g. permutations) at the cost
    of group-granular quarantine. The extra row rides the same two plans
    per key (full -> rows+1, tail -> tail+1), so the <=2-plans-per-key
    coalescing property is preserved.

    ``device`` is where the transforms run: "cuda" (default) stages
    through pinned buffers and launches the plan's kernels on the card;
    "cpu" runs the kernels' plain versions.
    """

    def __init__(self, fft_len: int, impl: str = "matfft",
                 donate: bool = True, verify: str = "off", device="cuda"):
        from repro_torch.fft.spec import resolve_device
        self.fft_len = fft_len
        self.impl = impl
        self.donate = donate
        self.verify = abft.check_mode(verify)
        self.device = resolve_device(device)
        self._pool: StagingPool | None = None

    def open(self, pool_capacity: int, stop: threading.Event) -> None:
        self._pool = StagingPool(pool_capacity, stop,
                                 pinned=self.device.type == "cuda")

    def decode(self, data: bytes, index: int) -> Decoded:
        flat = np.frombuffer(data, dtype=np.float32)
        if flat.size % (2 * self.fft_len):
            raise ValueError(
                f"block {index}: {flat.size} floats is not a whole number "
                f"of {self.fft_len}-point complex segments")
        inter = flat.reshape(-1, self.fft_len, 2)
        shape = inter.shape[:2]
        # views, not copies: the block bytes waiting in the decode queue
        # ARE the prefetch buffer; the deinterleave happens in gather
        # decode energy feeds the per-member Parseval check; in abft mode
        # the group checksum row is the (stronger) invariant, so skip the
        # per-member energy passes entirely — they were the dominant
        # verification cost (one full read of every plane, twice)
        e_in = abft.energy(flat) if self.verify == "parseval" else None
        return Decoded(index, (inter[..., 0], inter[..., 1]),
                       rows=shape[0], key=shape, energy=e_in)

    def gather(self, group: list[Decoded]):
        rows = sum(d.rows for d in group)
        extra = 1 if self.verify == "abft" else 0
        shape = (rows + extra, self.fft_len)
        if self._pool is not None:
            batch = self._pool.acquire(shape)
        else:  # transform used outside an executor (tests)
            batch = tuple(torch.empty(shape, dtype=torch.float32)
                          for _ in range(2))
        try:
            # gather straight into the (pinned) staging tensors through
            # their numpy views: one host copy per plane
            re_b, im_b = batch[0].numpy(), batch[1].numpy()
            np.concatenate([d.arrays[0] for d in group], axis=0,
                           out=re_b[:rows])
            np.concatenate([d.arrays[1] for d in group], axis=0,
                           out=im_b[:rows])
            if extra:
                w = abft.checksum_weights(rows, seed=rows)
                re_b[rows] = w @ re_b[:rows]
                im_b[rows] = w @ im_b[:rows]
        except BaseException:  # never leak the acquired set
            self.discard(batch)
            raise
        return batch

    def launch(self, batch):
        import repro_torch.fft as fft_api
        re_b, im_b = batch
        p = fft_api.plan(kind="c2c", n=self.fft_len,
                         batch_shape=tuple(re_b.shape[:-1]), impl=self.impl,
                         verify=self.verify, device=self.device)
        return p.execute_async(re_b, im_b, donate=self.donate), batch

    def realize(self, handle):
        pending, batch = handle
        try:
            return pending.realize()  # event wait + D2H: the window sync
        finally:
            # device errors surface HERE, so the release must be
            # unconditional or each transient failure leaks a set until
            # the pool starves the dispatcher
            self.discard(batch)

    def discard(self, batch) -> None:
        if self._pool is not None:  # device done -> staging reusable
            self._pool.release(tuple(batch[0].shape), batch)

    def verify_group(self, host, group: list[Decoded]) -> None:
        if self.verify != "abft":
            return
        rows = sum(d.rows for d in group)
        w = abft.checksum_weights(rows, seed=rows)
        abft.check_checksum(host, w, self.fft_len, site="stream.realize",
                            index=group[0].index,
                            blocks=[d.index for d in group])

    def verify_member(self, host, row0: int, d: Decoded) -> None:
        if self.verify == "off" or d.energy is None:
            return
        yr, yi = host
        e_out = abft.energy(yr[row0:row0 + d.rows], yi[row0:row0 + d.rows])
        abft.check_parseval(d.energy, e_out, self.fft_len,
                            site="stream.realize", index=d.index)

    def encode(self, host, row0: int, d: Decoded) -> bytes:
        yr, yi = host
        return block_of_segments(yr[row0:row0 + d.rows],
                                 yi[row0:row0 + d.rows])


class StreamExecutor:
    """Runs a `StreamTransform` over every store block, overlapped.

    Shares `Manifest` + `JobStats` with `MapOnlyJob` so the pipelined path
    is a drop-in: same crash-restart, retry-budget and speculation
    semantics, plus per-stage clocks in ``stats.stage_s``.
    """

    def __init__(self, store: BlockStore, out_dir, transform: StreamTransform,
                 cfg: JobConfig, manifest: Manifest, stats: JobStats):
        self.store = store
        self.out_dir = out_dir
        self.transform = transform
        self.cfg = cfg
        self.manifest = manifest
        self.stats = stats
        self._stats_lock = threading.Lock()
        self._stop = threading.Event()
        self._todo: queue.SimpleQueue = queue.SimpleQueue()
        # bounded: decoded blocks waiting for the dispatcher ARE the
        # prefetch window; readers block here when the device side lags,
        # so host memory stays O(queue x block) for any input size
        self._decoded: queue.Queue = queue.Queue(
            maxsize=2 * max(cfg.coalesce, 1) + max(cfg.readers, 1))
        self._events: queue.SimpleQueue = queue.SimpleQueue()
        self._inflight = threading.Semaphore(max(cfg.inflight, 1))
        # per-block processing start (set by the reader that picks the
        # block up). Latency medians and straggler ages are measured from
        # HERE, not from enqueue time — every block is enqueued at t=0, so
        # enqueue-based clocks grow with elapsed time and would both
        # inflate the median and mark merely-queued blocks as stragglers.
        self._started: dict[int, float] = {}
        # resilience: the shared retry policy + optional fault injector
        # (DESIGN.md §10). _first_started feeds the policy's per-block
        # deadline and is never popped on retry (unlike _started, whose
        # clock restarts so straggler detection stays per-attempt).
        self._policy = cfg.retry_policy()
        self._injector = cfg.injector
        self._retry_states: dict = {}
        self._first_started: dict[int, float] = {}

    # ------------------------------------------------------------------
    def _add_stage(self, stage: str, dt: float) -> None:
        with self._stats_lock:
            self.stats.stage_s[stage] = self.stats.stage_s.get(stage, 0.) + dt

    def _put_decoded(self, item) -> None:
        while not self._stop.is_set():
            try:
                self._decoded.put(item, timeout=0.05)
                return
            except queue.Full:  # prefetch window full: back-pressure
                continue

    def _reader(self) -> None:
        while True:
            item = self._todo.get()
            if item is None or self._stop.is_set():
                return
            index, is_spec = item
            # a speculative twin keeps the primary's clock (setdefault);
            # retries clear the entry first, so their clock restarts
            self._started.setdefault(index, time.monotonic())
            try:
                t0 = time.monotonic()
                data = self.store.read_block(index)
                maybe_fire(self._injector, "stream.decode", index)
                d = self.transform.decode(data, index)
                self._add_stage("read", time.monotonic() - t0)
                self._put_decoded(("ok", index, is_spec, d))
            except _Stop:
                return
            except BaseException as e:
                self._put_decoded(("err", index, is_spec, e))

    def _corrupt_host(self, host, group: list[tuple[Decoded, bool]]):
        """Post-realize corruption checkpoint (``kind="corrupt"`` rules at
        stream.realize): silently perturb a scheduled member's rows of the
        realized host arrays. Runs AFTER the CRC-verified read and the
        device sync — only the verify hooks below can catch it."""
        host = list(host) if isinstance(host, (tuple, list)) else [host]
        row0 = 0
        for d, _ in group:
            scale = self._injector.corrupt_scale("stream.realize", d.index)
            if scale is not None:
                for k in range(len(host)):
                    a = host[k]
                    if isinstance(a, (bytes, bytearray)):
                        if len(a) % 4 or not a:
                            continue  # opaque map output; nothing to flip
                        arr = np.frombuffer(a, dtype=np.float32).copy()
                        perturb_array(arr, scale,
                                      corrupt_salt("stream.realize",
                                                   d.index, k))
                        host[k] = arr.tobytes()
                        continue
                    if not a.flags.writeable:  # realized outputs often are
                        a = host[k] = np.array(a, copy=True)
                    perturb_array(a[row0:row0 + d.rows], scale,
                                  corrupt_salt("stream.realize", d.index, k))
            row0 += d.rows
        return host[0] if len(host) == 1 else tuple(host)

    def _writeback(self, handle, group: list[tuple[Decoded, bool]]) -> None:
        try:
            t0 = time.monotonic()
            try:
                host = self.transform.realize(handle)
            finally:
                # the window boundary: oldest batch realized -> next launch
                self._inflight.release()
            self._add_stage("d2h", time.monotonic() - t0)
            # fires only after realize: the staging set is back in the
            # pool (realize's finally), so an injected fault here cannot
            # leak pool capacity and starve the dispatcher
            if self._injector is not None:
                self._injector.fire_group(
                    "stream.realize", [d.index for d, _ in group])
                host = self._corrupt_host(host, group)
            # group invariant (abft checksum row): a failure here cannot
            # name the culprit, so the whole group quarantines and retries
            self.transform.verify_group(host, [d for d, _ in group])
        except BaseException as e:
            for d, is_spec in group:
                self._events.put(("err", d.index, is_spec, e))
            return
        row0 = 0
        t_done = time.monotonic()
        for d, is_spec in group:
            try:
                t0 = time.monotonic()
                maybe_fire(self._injector, "stream.writeback", d.index)
                # per-member invariant (Parseval): quarantines just this
                # block back into the retry path — recompute-on-detect
                self.transform.verify_member(host, row0, d)
                out = self.transform.encode(host, row0, d)
                self.store.write_output_block(self.out_dir, d.index, out)
                self._add_stage("write", time.monotonic() - t0)
                self._events.put(("done", d.index, is_spec, t_done))
            except BaseException as e:
                self._events.put(("err", d.index, is_spec, e))
            row0 += d.rows

    # ------------------------------------------------------------------
    def run(self) -> JobStats:
        cfg = self.cfg
        t_start = time.monotonic()
        for s in STAGES:
            self.stats.stage_s.setdefault(s, 0.0)

        todo = self.manifest.pending()
        total_left = len(todo)
        if total_left == 0:
            self.manifest.close()  # fd hygiene; reopens on next update
            self.stats.wall_s = time.monotonic() - t_start
            return self.stats

        coalesce = max(cfg.coalesce, 1)
        # batch staging sets: the inflight window plus slack for a batch
        # being gathered while another retires (double-buffering rule)
        self.transform.open(max(cfg.inflight, 1) + 2, self._stop)

        speculated: set[int] = set()
        completed: set[int] = set()
        decode_pending = 0  # enqueued to readers, not yet taken by us
        latencies: list[float] = []
        fatal: list[BaseException] = []

        readers = [threading.Thread(target=self._reader, daemon=True)
                   for _ in range(max(cfg.readers, 1))]
        for r in readers:
            r.start()
        writers = ThreadPoolExecutor(max_workers=max(cfg.writers, 1))

        def enqueue(i: int, is_spec: bool) -> None:
            nonlocal decode_pending
            self.manifest.update(i, status=RUNNING,
                                 started_at=time.monotonic(),
                                 speculated=is_spec)
            if not is_spec:  # retry: restart the block's clock when a
                self._started.pop(i, None)  # reader picks it up again
            self._first_started.setdefault(i, time.monotonic())
            decode_pending += 1
            self.stats.attempts += 1
            if is_spec:
                self.stats.speculative_launches += 1
            self._todo.put((i, is_spec))

        def on_failure(i: int, is_spec: bool, err: BaseException) -> None:
            if i in completed or fatal:
                return
            st = self.manifest.tasks[i]
            attempts = st.attempts + 1
            now = time.monotonic()
            elapsed = now - self._first_started.get(i, now)
            if not self._policy.should_retry(attempts, elapsed, err):
                self.manifest.update(i, status=FAILED, attempts=attempts,
                                     error=repr(err))
                self.stats.failed_blocks.append(
                    {"index": i, "attempts": attempts, "error": repr(err)})
                fatal.append(RuntimeError(
                    f"block {i} failed {attempts} times"))
                fatal[-1].__cause__ = err
                self._stop.set()
                return
            self.stats.retries += 1
            self.manifest.update(i, status=PENDING, attempts=attempts,
                                 error=repr(err))
            # backoff before relaunch; default policy has zero base delay,
            # so legacy jobs keep their immediate-retry behaviour
            self._retry_states.setdefault(
                i, self._policy.new_state()).backoff()
            enqueue(i, False)

        def on_done(i: int, is_spec: bool, t_done: float) -> None:
            nonlocal total_left
            if i in completed:
                return  # a speculative twin already won; idempotent write
            completed.add(i)
            total_left -= 1
            dt = t_done - self._started.get(i, t_done)
            latencies.append(dt)
            self.stats.task_seconds.append(dt)
            self.stats.blocks_done += 1
            if is_spec:
                self.stats.speculative_wins += 1
            self.manifest.update(i, status=DONE,
                                 finished_at=time.monotonic())

        def drain_events(block: bool = False) -> None:
            while True:
                try:
                    ev = self._events.get(
                        block=block, timeout=cfg.poll_interval_s)
                except queue.Empty:
                    return
                block = False
                kind, i, is_spec, payload = ev
                if kind == "done":
                    on_done(i, is_spec, payload)
                else:
                    on_failure(i, is_spec, payload)

        def maybe_speculate() -> None:
            if (not cfg.speculation
                    or len(latencies) < cfg.min_completed_for_speculation):
                return
            med = median(latencies)
            now = time.monotonic()
            # only blocks a reader has actually STARTED can be stragglers;
            # blocks still queued are waiting on back-pressure, not stuck
            for i, started in list(self._started.items()):
                if (i not in completed and i not in speculated
                        and now - started > cfg.straggler_factor * med):
                    speculated.add(i)
                    enqueue(i, True)

        def dispatch(group: list[tuple[Decoded, bool]]) -> None:
            # h2d + launch; window back-pressure lives in the semaphore
            while not self._inflight.acquire(timeout=cfg.poll_interval_s):
                drain_events()  # keep completions flowing while we wait
                if self._stop.is_set():
                    return
            batch = None
            try:
                if self._injector is not None:
                    self._injector.fire_group(
                        "stream.launch", [d.index for d, _ in group])
                t0 = time.monotonic()
                batch = self.transform.gather([d for d, _ in group])
                self._add_stage("h2d", time.monotonic() - t0)
                t0 = time.monotonic()
                handle = self.transform.launch(batch)
                self._add_stage("compute", time.monotonic() - t0)
            except BaseException as e:
                self._inflight.release()
                if batch is not None:  # gathered but never launched
                    self.transform.discard(batch)
                for d, is_spec in group:
                    on_failure(d.index, is_spec, e)
                return
            self.stats.batches += 1
            self.stats.coalesced_blocks += max(len(group) - 1, 0)
            writers.submit(self._writeback, handle, group)

        try:
            for i in todo:
                enqueue(i, False)

            group: list[tuple[Decoded, bool]] = []
            while total_left > 0 and not self._stop.is_set():
                drain_events()
                maybe_speculate()
                try:
                    kind, i, is_spec, payload = self._decoded.get(
                        timeout=cfg.poll_interval_s)
                except queue.Empty:
                    if group and decode_pending == 0:
                        dispatch(group)
                        group = []
                    continue
                decode_pending -= 1
                if kind == "err":
                    on_failure(i, is_spec, payload)
                    continue
                d: Decoded = payload
                if i in completed:  # twin won while we were decoding
                    continue
                if group and (d.key is None or d.key != group[0][0].key
                              or len(group) >= coalesce):
                    dispatch(group)
                    group = []
                group.append((d, is_spec))
                if len(group) >= coalesce or d.key is None or (
                        decode_pending == 0 and self._decoded.empty()):
                    dispatch(group)
                    group = []
            # the loop exits only at total_left == 0 (or stop): any block
            # still in `group` was completed by a speculative twin while
            # its decode waited, so launching the leftovers would only
            # redo finished work — drop them (Decoded holds views, no
            # pooled staging, so dropping needs no cleanup)
        finally:
            try:
                self._stop.set()
                for _ in readers:
                    self._todo.put(None)
                if isinstance(getattr(self.transform, "_pool", None),
                              StagingPool):
                    self.transform._pool.wake_all()
                writers.shutdown(wait=True)
                for r in readers:
                    r.join(timeout=5.0)
                self.transform.close()
                # late finishers (stats/manifest completeness) BEFORE the
                # manifest close below — their updates must not silently
                # reopen the journal fd we are about to release
                drain_events()
            finally:
                self.manifest.close()  # fd hygiene; reopens on next update
        if fatal:
            raise fatal[0]
        self.stats.wall_s = time.monotonic() - t_start
        return self.stats
