"""Map-only job runner: Hadoop's task tracker, minus the reduce phase.

Faithful pieces (paper §III):
  * zero reducers — each map attempt writes its output block directly to the
    output directory, named by input offset, so getmerge is order-correct;
  * one block per task, batched FFT inside the task.

Large-scale-runnability pieces (Hadoop semantics the paper relies on
implicitly, implemented explicitly here):
  * crash-consistent job manifest: every state transition is journaled; a
    restarted job re-runs only non-DONE blocks (checkpoint/restart);
  * bounded retries per block with failure isolation (one poisoned block
    cannot take down the job until its retry budget is spent);
  * speculative execution: when a running attempt exceeds
    ``straggler_factor`` x the median completed-task latency, a duplicate
    attempt is launched; block writes are atomic + idempotent so whichever
    attempt finishes first wins and the loser's write is a harmless replace;
  * worker pool == "servers": thread workers model the paper's S servers
    (PyTorch's kernels release the GIL, so threads genuinely overlap I/O
    with compute the way Hadoop overlaps map waves).
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from concurrent.futures import FIRST_COMPLETED, Future, ThreadPoolExecutor, wait
from dataclasses import dataclass, field
from pathlib import Path
from statistics import median
from typing import Callable

from repro_torch.core.pipeline.blockstore import BlockStore
from repro_torch.core.resilience.faults import maybe_corrupt_bytes, maybe_fire
from repro_torch.core.resilience.retry import RetryPolicy

PENDING, RUNNING, DONE, FAILED = "PENDING", "RUNNING", "DONE", "FAILED"


@dataclass
class JobConfig:
    workers: int = 4
    max_retries: int = 3  # legacy knob: feeds the default RetryPolicy
    straggler_factor: float = 3.0
    speculation: bool = True
    min_completed_for_speculation: int = 3
    poll_interval_s: float = 0.02
    # --- streaming path knobs (MapOnlyJob(pipelined=True) / stream.py) ---
    readers: int = 2      # prefetch/decode threads
    writers: int = 2      # writeback (D2H + encode + write) threads
    coalesce: int = 1     # same-shaped blocks fused into one device batch
    inflight: int = 2     # launched-but-unrealized batch window
    # --- resilience (core/resilience; DESIGN.md §10) ---
    # ONE retry policy for both execution paths. None = the legacy
    # immediate-retry behaviour bounded by max_retries; pass a RetryPolicy
    # for backoff + per-block deadlines. Backoff sleeps run on the
    # coordinator/dispatcher thread through policy.sleep (injectable).
    retry: RetryPolicy | None = None
    injector: object = None  # FaultInjector for deterministic chaos runs
    # ABFT hook for the serial path (DESIGN.md §13): called as
    # verify_fn(block_bytes_in, out_bytes, index) after the map function
    # (and after the corruption checkpoint); raise SilentCorruption to
    # quarantine the attempt back into the retry budget. None = no check.
    verify_fn: Callable | None = None

    def retry_policy(self) -> RetryPolicy:
        return self.retry or RetryPolicy(max_attempts=self.max_retries)


@dataclass
class TaskState:
    index: int
    status: str = PENDING
    attempts: int = 0
    started_at: float | None = None
    finished_at: float | None = None
    speculated: bool = False
    error: str | None = None


class Manifest:
    """Crash-consistent per-block task journal (append-only, O(1)/transition).

    Layout: line-delimited JSON — one ``snapshot`` record (the full task
    table) followed by one ``update`` line per state transition. A
    transition appends + fsyncs ~100 bytes instead of rewriting the whole
    table (the seed behaviour was O(blocks) bytes per transition, so
    O(blocks²) per job — measurable manifest stalls past a few thousand
    blocks). Crash-restart semantics are unchanged: on open the journal is
    replayed in order (a torn final line from a crash mid-append is
    dropped; every earlier line was fsync-durable), RUNNING tasks demote to
    PENDING, and the journal is compacted back to a single fresh snapshot.
    Legacy single-object manifests (the pre-journal format) replay too.
    """

    def __init__(self, path: Path, num_blocks: int):
        self.path = Path(path)
        self._lock = threading.Lock()
        self._fh = None
        self.appends = 0  # transitions journaled by THIS process (stats)
        if self.path.exists():
            self.tasks = self._replay(self.path)
            for t in self.tasks.values():  # RUNNING at crash time -> retry
                if t.status == RUNNING:
                    t.status = PENDING
        else:
            self.tasks = {i: TaskState(i) for i in range(num_blocks)}
        self._compact()

    @staticmethod
    def _replay(path: Path) -> dict[int, TaskState]:
        tasks: dict[int, TaskState] = {}
        for line in path.read_text().splitlines():
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                break  # torn tail from a crash mid-append; rest is durable
            if rec.get("type") == "update":
                t = tasks[rec["index"]]
                for k, v in rec["fields"].items():
                    setattr(t, k, v)
            elif rec.get("type") == "snapshot":
                tasks = {t["index"]: TaskState(**t) for t in rec["tasks"]}
            else:  # legacy format: one JSON object {index: task_fields}
                tasks = {int(k): TaskState(**v) for k, v in rec.items()}
        return tasks

    def _compact(self) -> None:
        """Rewrite as snapshot-only (atomic), then reopen for appending."""
        if self._fh is not None:
            self._fh.close()
        snap = json.dumps({"type": "snapshot",
                           "tasks": [vars(t) for t in self.tasks.values()]})
        fd, tmp = tempfile.mkstemp(dir=self.path.parent, prefix=".mtmp_")
        try:
            with os.fdopen(fd, "w") as f:
                f.write(snap + "\n")
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
        except BaseException:
            # crash-mid-compact: the journal at self.path is untouched
            # (os.replace is all-or-nothing), so a reopen replays the SAME
            # task states; just don't leak the tmp snapshot
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        self._fh = open(self.path, "a")

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    def update(self, index: int, **fields) -> None:
        with self._lock:
            t = self.tasks[index]
            for k, v in fields.items():
                setattr(t, k, v)
            if self._fh is None:  # reopened after close(): keep appending
                self._fh = open(self.path, "a")
            self._fh.write(json.dumps(
                {"type": "update", "index": index, "fields": fields}) + "\n")
            self._fh.flush()
            os.fsync(self._fh.fileno())
            self.appends += 1

    def pending(self) -> list[int]:
        return [i for i, t in self.tasks.items() if t.status == PENDING]

    def done(self) -> list[int]:
        return [i for i, t in self.tasks.items() if t.status == DONE]


@dataclass
class JobStats:
    blocks_done: int = 0
    attempts: int = 0
    retries: int = 0
    speculative_launches: int = 0
    speculative_wins: int = 0
    wall_s: float = 0.0
    task_seconds: list[float] = field(default_factory=list)
    # streaming path: per-stage clock totals (read/h2d/compute/d2h/write)
    # and coalescing counters; empty/zero on the serial path
    stage_s: dict[str, float] = field(default_factory=dict)
    batches: int = 0
    coalesced_blocks: int = 0
    # blocks whose retry budget was exhausted this run: one structured
    # {"index", "attempts", "error"} record each (the RuntimeError the job
    # raises chains the last underlying exception as __cause__)
    failed_blocks: list[dict] = field(default_factory=list)


class MapOnlyJob:
    """Runs ``map_fn(block_bytes, index) -> bytes`` over every store block."""

    def __init__(self, store: BlockStore, out_dir: os.PathLike,
                 map_fn: Callable[[bytes, int], bytes] | None = None,
                 config: JobConfig | None = None,
                 job_dir: os.PathLike | None = None,
                 pipelined: bool = False, transform=None):
        if map_fn is None and transform is None:
            raise ValueError("need map_fn (serial / pipelined) or "
                             "transform (pipelined)")
        if transform is not None and not pipelined:
            raise ValueError("transform= requires pipelined=True")
        self.store = store
        self.out_dir = Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.map_fn = map_fn
        self.pipelined = pipelined
        self.transform = transform
        self.cfg = config or JobConfig()
        job_dir = Path(job_dir) if job_dir else self.out_dir
        job_dir.mkdir(parents=True, exist_ok=True)
        self.manifest = Manifest(job_dir / "job_manifest.json",
                                 len(store.blocks))
        self.stats = JobStats()
        self._done_latencies: list[float] = []
        self._lock = threading.Lock()

    # ------------------------------------------------------------------
    def _attempt(self, index: int) -> tuple[int, float]:
        t0 = time.monotonic()
        maybe_fire(self.cfg.injector, "maponly.attempt", index)
        data = self.store.read_block(index)
        out = self.map_fn(data, index)
        # silent-corruption checkpoint: past the CRC-verified read and the
        # map function, so only the ABFT verify hook below can see it
        out = maybe_corrupt_bytes(self.cfg.injector, "maponly.attempt",
                                  index, out)
        if self.cfg.verify_fn is not None:
            self.cfg.verify_fn(data, out, index)
        self.store.write_output_block(self.out_dir, index, out)
        return index, time.monotonic() - t0

    def run(self) -> JobStats:
        if self.pipelined:
            # the overlapped stream executor (stream.py): same manifest /
            # retry / speculation semantics, staged instead of lump-serial
            from repro_torch.core.pipeline.stream import (MapFnTransform,
                                                    StreamExecutor)
            transform = self.transform or MapFnTransform(self.map_fn)
            return StreamExecutor(self.store, self.out_dir, transform,
                                  self.cfg, self.manifest, self.stats).run()
        cfg = self.cfg
        t_start = time.monotonic()
        try:
            return self._run_serial(cfg, t_start)
        finally:
            self.manifest.close()  # fd hygiene; reopens on next update

    def _run_serial(self, cfg: JobConfig, t_start: float) -> JobStats:
        todo = self.manifest.pending()
        inflight: dict[Future, tuple[int, float, bool]] = {}
        speculated: set[int] = set()
        completed: set[int] = set(self.manifest.done())
        policy = cfg.retry_policy()
        # per-block deadline clock + jitter chain (policy state); attempt
        # COUNTS stay in the manifest so they survive crash-restarts
        first_started: dict[int, float] = {}
        retry_states: dict = {}

        with ThreadPoolExecutor(max_workers=cfg.workers) as pool:

            def launch(i: int, is_spec: bool) -> None:
                first_started.setdefault(i, time.monotonic())
                self.manifest.update(i, status=RUNNING,
                                     started_at=time.monotonic(),
                                     speculated=is_spec)
                fut = pool.submit(self._attempt, i)
                inflight[fut] = (i, time.monotonic(), is_spec)
                self.stats.attempts += 1
                if is_spec:
                    self.stats.speculative_launches += 1

            for i in todo:
                launch(i, False)

            while inflight:
                done_futs, _ = wait(list(inflight), timeout=cfg.poll_interval_s,
                                    return_when=FIRST_COMPLETED)
                now = time.monotonic()

                # --- straggler speculation ---
                if (cfg.speculation
                        and len(self._done_latencies)
                        >= cfg.min_completed_for_speculation):
                    med = median(self._done_latencies)
                    for fut, (i, started, is_spec) in list(inflight.items()):
                        if (not is_spec and i not in speculated
                                and i not in completed
                                and now - started > cfg.straggler_factor * med):
                            speculated.add(i)
                            launch(i, True)

                for fut in done_futs:
                    i, started, is_spec = inflight.pop(fut)
                    if i in completed:
                        continue  # a twin already won; idempotent write
                    err = fut.exception()
                    if err is None:
                        _, dt = fut.result()
                        completed.add(i)
                        self._done_latencies.append(dt)
                        self.stats.task_seconds.append(dt)
                        self.stats.blocks_done += 1
                        if is_spec:
                            self.stats.speculative_wins += 1
                        self.manifest.update(i, status=DONE,
                                             finished_at=time.monotonic())
                    else:
                        st = self.manifest.tasks[i]
                        attempts = st.attempts + 1
                        elapsed = now - first_started.get(i, now)
                        if not policy.should_retry(attempts, elapsed, err):
                            self.manifest.update(i, status=FAILED,
                                                 attempts=attempts,
                                                 error=repr(err))
                            self.stats.failed_blocks.append(
                                {"index": i, "attempts": attempts,
                                 "error": repr(err)})
                            raise RuntimeError(
                                f"block {i} failed {attempts} times"
                            ) from err
                        self.stats.retries += 1
                        self.manifest.update(i, status=PENDING,
                                             attempts=attempts,
                                             error=repr(err))
                        retry_states.setdefault(
                            i, policy.new_state()).backoff()
                        launch(i, False)

        self.stats.wall_s = time.monotonic() - t_start
        return self.stats

    def merge(self, dest: os.PathLike) -> int:
        return self.store.getmerge(self.out_dir, dest)
