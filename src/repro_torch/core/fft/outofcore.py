"""Out-of-core four-step FFT: transforms larger than memory, streamed
through a `BlockStore` (the paper's >1TB headline scenario; EFFT,
arXiv:1409.5757).

The four-step factorization IS an out-of-core algorithm — under the
standard permuted-layout contract that saves the extra corner-turn
shuffles (FFTW-MPI's TRANSPOSED_IN/TRANSPOSED_OUT):

  * the stored operand ``s`` is the signal in DECIMATED (corner-turned)
    layout — interpreting ``s`` as the row-major (n2, n1) matrix
    ``M[j2, j1] = s[j2*n1 + j1]``, the natural-order signal is
    ``x[j1*n2 + j2] = M[j2, j1]`` (i.e. ``x = T(s)`` with
    ``T(v) = v.reshape(n2, n1).T.ravel()``);
  * the emitted spectrum is in TRANSPOSED order:
    ``out[k1*n2 + k2] = X[k1 + n1*k2]`` where ``X = DFT_n(x)`` — the
    same operator again: ``out = T(X)``.

The algebra behind the two passes — split k = k1 + n1*k2, j = j1*n2 + j2
(k1, j1 in [0, n1)); then W_n^{j*k} factors with no cross term:

    X[k1 + n1*k2] = sum_{j2} W_n2^{j2*k2} * ( W_n^{j2*k1} * P[j2, k1] )
    P[j2, k1]     = sum_{j1} W_n1^{j1*k1} * M[j2, j1]

which streams in exactly two bounded passes plus ONE storage transpose:

  pass 1    each job reads t2 contiguous rows of M (one panel of
            t2*n1 complex samples), runs a batched length-n1 FFT through
            the cached plan on the device, applies the global twiddle
            W_n^{j2*k1} on the host in the same streamed job, and scatters
            the panel back as (t1, t2) tiles in k1-major order — the
            transposed-shuffle write. Job c is journaled DONE only after
            ALL of its tiles are atomically on disk, so a crash
            mid-shuffle re-runs only the incomplete jobs.
  pass 2    job r gathers its row-of-tiles into a (t1, n2) panel (tile
            CRCs verified against the shuffle journal), runs a batched
            length-n2 FFT, and writes one final offset-named output
            block: out[k1*n2 + k2] = X[k1 + n1*k2].

Memory never exceeds a bounded host working set: the factorization picks
the panel heights t2 (pass 1) and t1 (pass 2) so that `WS_PANELS`
concurrent panels (prefetch + staging + inflight window + writeback) fit
the caller's ``budget_bytes``; the stream executor's bounded queues
enforce the bound structurally. Both passes run through `StreamExecutor`
(core/pipeline/stream.py) under the shared `Manifest` journal
(crash-resume, one manifest per phase) and `RetryPolicy`/`FaultInjector`
wiring (sites ``ooc.shuffle`` and ``ooc.pass2``).

Each pass's plan is the cached local `ExecutablePlan` on ``device``: on a
CUDA card the panels stage through pinned buffers and run K1 (a pass
length up to MAX_LEAF) or K2 (the level-1 four-step past it); on the CPU
the kernels' plain versions run. The pass lengths are capped at the
local plan's maximum, MAX_LOCAL_N, which the port's smaller leaf reaches
in three levels.

The analytic cost model: ``passes`` (2), ``io_bytes`` (4 x operand: read
+ shuffle-write + shuffle-read + write), ``shuffle_bytes`` (2 x operand)
and ``working_set_bytes`` (the enforced peak).
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from dataclasses import dataclass, field, replace
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.pipeline.blockstore import (BlockStore, _atomic_write,
                                                  _crc)
from repro_torch.core.pipeline.maponly import (FAILED, PENDING, JobConfig,
                                               JobStats, Manifest)
from repro_torch.core.pipeline.records import block_of_segments
from repro_torch.core.pipeline.stream import (Decoded, StagingPool,
                                              StreamExecutor, StreamTransform,
                                              async_clocks)
from repro_torch.core.resilience import verify as abft
from repro_torch.core.resilience.faults import maybe_corrupt, maybe_fire
from repro_torch.kernels.fft import plan as kplan

_C64 = 8  # bytes per interleaved complex64 sample

# concurrent panels the streamed passes can hold at once: reader prefetch
# + gathered staging + the inflight launch window + a writeback copy. The
# factorization sizes panels so WS_PANELS of them fit the budget; the
# executor's bounded queues make the bound structural, not advisory.
WS_PANELS = 4


def _near_square_split(n: int) -> tuple[int, int]:
    """n = n1 * n2, both pow2, near-square, each within the single-device
    plan maximum (MAX_LOCAL_N — the pass lengths run device-local)."""
    # imported here, not at the top: repro_torch.fft imports this module
    from repro_torch.fft.spec import MAX_LOCAL_N
    if not kplan.is_pow2(n) or n < 4:
        raise ValueError(f"out-of-core transform length must be a power of "
                         f"two >= 4, got n={n}")
    p = kplan.log2i(n)
    n1 = 1 << (p // 2)
    n2 = 1 << (p - p // 2)  # n2 >= n1
    if n2 > MAX_LOCAL_N:
        raise ValueError(
            f"out-of-core split n={n} needs pass lengths n1={n1}, n2={n2}, "
            f"but each pass runs a device-local plan capped at "
            f"MAX_LOCAL_N={MAX_LOCAL_N}")
    return n1, n2


def _pow2_floor(x: int) -> int:
    return 1 << (x.bit_length() - 1) if x >= 1 else 0


@dataclass(frozen=True)
class OocPlan:
    """The pure out-of-core factorization + analytic cost model.

    Computable without a store (a 2^37-point transform can be modelled
    this way); `OutOfCorePlan` binds one to a concrete `BlockStore`.
    """

    n: int              # total transform points
    n1: int             # pass-1 FFT length (stored rows of M are length n1)
    n2: int             # pass-2 FFT length
    t2: int             # pass-1 panel height: stored rows per streamed job
    t1: int             # pass-2 panel height: spectrum rows per job
    budget_bytes: int   # caller's working-set cap the panels were sized to

    # ---------------- geometry ----------------
    @property
    def operand_bytes(self) -> int:
        return _C64 * self.n

    @property
    def pass1_jobs(self) -> int:
        return self.n2 // self.t2

    @property
    def pass2_jobs(self) -> int:
        return self.n1 // self.t1

    @property
    def pass1_panel_bytes(self) -> int:
        return _C64 * self.n1 * self.t2

    @property
    def pass2_panel_bytes(self) -> int:
        return _C64 * self.n2 * self.t1

    @property
    def tile_bytes(self) -> int:
        return _C64 * self.t1 * self.t2

    @property
    def tiles(self) -> int:
        return self.pass1_jobs * self.pass2_jobs

    # ---------------- analytic cost model ----------------
    @property
    def passes(self) -> int:
        return 2

    @property
    def io_bytes(self) -> int:
        """Total storage traffic: read input + write tiles + read tiles +
        write output — each exactly one operand, the four-step minimum."""
        return 4 * self.operand_bytes

    @property
    def shuffle_bytes(self) -> int:
        """Bytes crossing the transpose shuffle (tile write + read back)."""
        return 2 * self.operand_bytes

    @property
    def working_set_bytes(self) -> int:
        """The enforced peak host working set (WS_PANELS bounded panels)."""
        return WS_PANELS * max(self.pass1_panel_bytes, self.pass2_panel_bytes)

    @property
    def flops(self) -> float:
        """5 n log2 n, same convention as `ExecutablePlan.flops`."""
        return 5.0 * self.n * math.log2(self.n)

    def as_dict(self) -> dict:
        return {"n": self.n, "n1": self.n1, "n2": self.n2,
                "t1": self.t1, "t2": self.t2,
                "budget_bytes": self.budget_bytes,
                "operand_bytes": self.operand_bytes,
                "pass1_jobs": self.pass1_jobs, "pass2_jobs": self.pass2_jobs,
                "tiles": self.tiles, "tile_bytes": self.tile_bytes,
                "passes": self.passes, "io_bytes": self.io_bytes,
                "shuffle_bytes": self.shuffle_bytes,
                "working_set_bytes": self.working_set_bytes}


def factor_out_of_core(n: int, budget_bytes: int,
                       block_bytes: int | None = None,
                       panel_scale: int = 1) -> OocPlan:
    """Factor n = n1 * n2 and size the streaming panels against the budget.

    The memory-budget rule: WS_PANELS concurrent panels must fit, so
    t2 (pass-1 stored rows/job) is the largest power of two with
    WS_PANELS * 8*n1*t2 <= budget_bytes, and t1 (pass-2 spectrum
    rows/job) likewise against 8*n2*t1. When the operand store's
    ``block_bytes`` is given, t2 additionally aligns so each pass-1
    panel is a whole number of store blocks (jobs read block-granular,
    never split a block).

    ``panel_scale`` (pow2 >= 1) shrinks BOTH panel heights by that
    factor below the budget-maximal choice: smaller panels trade per-job
    overhead for earlier first-byte and a smaller resident set.
    """
    scale = int(panel_scale)
    if scale < 1 or scale & (scale - 1):
        raise ValueError(
            f"panel_scale must be a power of two >= 1, got {panel_scale}")
    n1, n2 = _near_square_split(n)
    row_bytes = _C64 * n1
    t2 = _pow2_floor(min(budget_bytes // (WS_PANELS * row_bytes),
                         n2)) // scale
    if block_bytes is not None and t2 >= 1 \
            and (row_bytes * t2) % block_bytes:
        # a panel is row_bytes * 2^k: if the largest affordable k fails,
        # every smaller one has fewer factors of two and fails harder
        raise ValueError(
            f"store block_bytes={block_bytes} does not tile the pass-1 "
            f"panel ({row_bytes * t2} B = {t2} rows of {row_bytes} B); "
            f"ingest with a block size that divides the panel")
    t1 = _pow2_floor(min(budget_bytes // (WS_PANELS * _C64 * n2),
                         n1)) // scale
    if t2 < 1 or t1 < 1:
        if scale > 1:
            raise ValueError(
                f"panel_scale={scale} shrinks the streaming panels below "
                f"one row for n={n} under budget_bytes={budget_bytes}; "
                f"use a smaller scale")
        need = WS_PANELS * _C64 * max(n1, n2)
        raise ValueError(
            f"memory budget {budget_bytes} B cannot hold even one "
            f"single-column working set for n={n} (needs >= {need} B = "
            f"{WS_PANELS} panels of one length-{max(n1, n2)} line); raise "
            f"budget_bytes or shrink n")
    return OocPlan(n=n, n1=n1, n2=n2, t2=t2, t1=t1,
                   budget_bytes=budget_bytes)


# ---------------------------------------------------------------------------
# twiddle: W_n^{j2*k1} with exponents reduced mod n in EXACT integer
# arithmetic (uint64 products stay exact far past any storable n), then
# float64 angles -> float32 factors, on the host. Both the streamed pass
# and the in-memory oracle call THIS function with the same global j2
# indices, which is what makes streamed-vs-oracle comparisons bitwise.


def _twiddle_rows(j2_start: int, rows: int, n1: int,
                  n: int) -> tuple[np.ndarray, np.ndarray]:
    j2 = np.arange(j2_start, j2_start + rows, dtype=np.uint64)[:, None]
    k1 = np.arange(n1, dtype=np.uint64)[None, :]
    e = (j2 * k1) % np.uint64(n)  # exact: j2*k1 < n2*n1 = n <= 2^63
    ang = (-2.0 * np.pi / n) * e.astype(np.float64)
    return (np.cos(ang).astype(np.float32),
            np.sin(ang).astype(np.float32))


def _apply_twiddle(yr: np.ndarray, yi: np.ndarray, j2_start: int,
                   n: int) -> tuple[np.ndarray, np.ndarray]:
    """(yr + i*yi)[j2_local, k1] * W_n^{(j2_start+j2_local)*k1}, float32.

    Plain elementwise numpy (two mults + add/sub per plane, each correctly
    rounded) so the streamed chunks and the full-matrix oracle reduce to
    the identical per-element operation sequence — the bitwise invariant.
    """
    wr, wi = _twiddle_rows(j2_start, yr.shape[0], yr.shape[1], n)
    return yr * wr - yi * wi, yr * wi + yi * wr


# ---------------------------------------------------------------------------
# the shuffle journal: an append-only JSONL record of every pass-1 job's
# tile CRCs, fsync'd BEFORE the job can be journaled DONE in the phase-1
# manifest. DONE in the manifest therefore implies the job's tile integrity
# metadata is durable — pass 2 verifies every tile read against it.


class TileJournal:
    """Append-only (torn-tail tolerant) CRC journal for shuffle tiles.

    Under ``verify`` modes each record also carries the per-tile ENERGY
    (float64 sum of squares) measured just before the bytes were CRC'd —
    the ABFT side-channel: a CRC only proves the bytes on disk are the
    bytes that were written, the journaled energy lets pass 2 prove the
    values are the values pass 1 computed.
    """

    def __init__(self, path: os.PathLike):
        self.path = Path(path)
        self._lock = threading.Lock()
        self._crcs: dict[str, str] = {}
        self._energies: dict[str, float] = {}
        if self.path.exists():
            for line in self.path.read_text().splitlines():
                if not line.strip():
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    break  # torn tail from a crash mid-append
                self._crcs.update(rec.get("crcs", {}))
                self._energies.update(rec.get("energies", {}))

    def record(self, job: int, crcs: dict[str, str],
               energies: dict[str, float] | None = None) -> None:
        rec: dict = {"job": job, "crcs": crcs}
        if energies:
            rec["energies"] = energies
        with self._lock:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
                f.flush()
                os.fsync(f.fileno())
            self._crcs.update(crcs)
            if energies:
                self._energies.update(energies)

    def crc(self, name: str) -> str | None:
        with self._lock:
            return self._crcs.get(name)

    def energy(self, name: str) -> float | None:
        with self._lock:
            return self._energies.get(name)


def _tile_name(r: int, c: int) -> str:
    return f"tile_{r:06d}_{c:06d}.bin"


class _IoCounter:
    """Thread-safe measured storage-traffic counters (vs the analytic
    model's `io_bytes`; reported by `OocStats.io`)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.counts = {"input_read": 0, "shuffle_write": 0,
                       "shuffle_read": 0, "output_write": 0}

    def add(self, key: str, nbytes: int) -> None:
        with self._lock:
            self.counts[key] += nbytes

    def as_dict(self) -> dict:
        with self._lock:
            d = dict(self.counts)
        d["total"] = sum(d.values())
        return d


# ---------------------------------------------------------------------------
# phase-1 plumbing: a panel-granular reader over the operand store + the
# transposed-shuffle scatter writer


class _Pass1Store:
    """Presents the operand `BlockStore` re-blocked at pass-1 panel
    granularity for `StreamExecutor` (which only needs `read_block` +
    `write_output_block`): job c reads the blocks spanning stored rows
    [c*t2, (c+1)*t2) of M and the "output write" scatters the twiddled
    panel into (t1, t2) tiles in k1-major order — the transpose
    shuffle."""

    def __init__(self, store: BlockStore, f: OocPlan, journal: TileJournal,
                 io: _IoCounter, injector=None, verify: str = "off"):
        self.store = store
        self.f = f
        self.journal = journal
        self.io = io
        self.injector = injector
        self.verify = abft.check_mode(verify)
        panel = f.pass1_panel_bytes
        if store.total_bytes != f.operand_bytes:
            raise ValueError(
                f"store holds {store.total_bytes} B but the plan transforms "
                f"n={f.n} points = {f.operand_bytes} B")
        if panel % store.block_bytes:
            raise ValueError(
                f"pass-1 panel ({panel} B) is not a whole number of store "
                f"blocks ({store.block_bytes} B); re-ingest or re-factor")
        self.blocks_per_job = panel // store.block_bytes

    def read_block(self, index: int) -> bytes:
        g = self.blocks_per_job
        parts = [self.store.read_block(i)
                 for i in range(index * g, (index + 1) * g)]
        data = parts[0] if g == 1 else b"".join(parts)
        self.io.add("input_read", len(data))
        return data

    def write_output_block(self, out_dir: os.PathLike, index: int,
                           data: bytes) -> None:
        """The transposed-shuffle write: panel -> R tiles, k1-major order,
        each atomic; the job's CRC record is fsync-durable before return
        (and therefore before the manifest can mark the job DONE)."""
        f = self.f
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        panel = np.frombuffer(data, np.float32).reshape(f.t2, f.n1, 2)
        crcs = {}
        energies: dict[str, float] = {}
        e_panel = abft.energy(panel) if self.verify != "off" else None
        for r in range(f.pass2_jobs):
            tid = r * f.pass1_jobs + index
            maybe_fire(self.injector, "ooc.shuffle", tid)
            tile = np.ascontiguousarray(
                panel[:, r * f.t1:(r + 1) * f.t1].transpose(1, 0, 2))
            # silent-corruption checkpoint: a hit perturbs the tile BEFORE
            # the CRC is taken, so the journal faithfully records the
            # corrupt bytes — only the energy invariant below can tell
            (tile,), _ = maybe_corrupt(self.injector, "ooc.shuffle", tid,
                                       [tile])
            blob = tile.tobytes()
            name = _tile_name(r, index)
            _atomic_write(out / name, blob)
            crcs[name] = _crc(blob)
            if self.verify != "off":
                energies[name] = abft.energy(tile)
            self.io.add("shuffle_write", len(blob))
        if self.verify != "off":
            # scatter is a pure rearrangement: the tiles' energies must
            # resum to the panel's (float64, positive terms — no
            # cancellation), so the tolerance is summation-order noise,
            # far tighter than the FFT Parseval bound
            e_tiles = math.fsum(energies.values())
            tol = 1e-9 * (e_panel + 1e-30)
            if abs(e_tiles - e_panel) > tol:
                raise abft.fail("ooc.shuffle", index, check="scatter_energy",
                                expected=e_panel, got=e_tiles, tol=tol)
        self.journal.record(index, crcs, energies or None)


class _PanelTransform(StreamTransform):
    """One streamed pass: a batched length-``n`` FFT of each job's
    (rows, n) panel through the cached plan on ``device`` (exactly the
    full-panel plan — panels are uniform, so one plan serves the pass).

    ``gather`` deinterleaves the job's block views into pooled staging
    tensors (pinned on a CUDA card) through their numpy views; ``launch``
    hands them to the plan's `execute_async` (``donate``: the staging set
    returns to the pool only once its batch is realized); ``realize``
    waits for the device and returns host numpy planes.
    """

    site = "ooc.pass2"

    def __init__(self, f: OocPlan, rows: int, n: int, impl: str,
                 verify: str, device):
        self.f = f
        self.rows = rows
        self.n = n
        self.impl = impl
        self.verify = abft.check_mode(verify)
        self.device = device
        self._pool: StagingPool | None = None

    def open(self, pool_capacity: int, stop: threading.Event) -> None:
        self._pool = StagingPool(pool_capacity, stop,
                                 pinned=self.device.type == "cuda")

    def close(self) -> None:
        self._pool = None

    def decode(self, data: bytes, index: int) -> Decoded:
        inter = np.frombuffer(data, np.float32).reshape(self.rows, self.n, 2)
        e_in = abft.energy(inter) if self.verify != "off" else None
        return Decoded(index, (inter[..., 0], inter[..., 1]),
                       rows=self.rows, key=None,  # one job per launch
                       energy=e_in)

    def gather(self, group):
        (d,) = group
        shape = (self.rows, self.n)
        if self._pool is not None:
            batch = self._pool.acquire(shape)
        else:  # transform used outside an executor (tests)
            batch = tuple(torch.empty(shape, dtype=torch.float32)
                          for _ in range(2))
        try:
            np.copyto(batch[0].numpy(), d.arrays[0])
            np.copyto(batch[1].numpy(), d.arrays[1])
        except BaseException:  # never leak the acquired set
            self.discard(batch)
            raise
        return batch

    def launch(self, batch):
        import repro_torch.fft as fft_api
        re_b, im_b = batch
        p = fft_api.plan(kind="c2c", n=self.n, batch_shape=(self.rows,),
                         impl=self.impl, verify=self.verify,
                         device=self.device)
        return p.execute_async(re_b, im_b, donate=True), batch

    def realize(self, handle):
        pending, batch = handle
        try:
            return pending.realize()  # event wait + D2H
        finally:
            self.discard(batch)  # unconditional: no leaked staging

    def clocks(self, handle):
        return async_clocks(handle[0])

    def discard(self, batch) -> None:
        if self._pool is not None:
            self._pool.release(tuple(batch[0].shape), batch)

    def verify_member(self, host, row0: int, d: Decoded) -> None:
        # Parseval over the realized panel: the FFT output must carry n x
        # the input energy recorded at decode
        if self.verify == "off" or d.energy is None:
            return
        yr, yi = host
        abft.check_parseval(d.energy, abft.energy(yr, yi), self.n,
                            "f32", site=self.site, index=d.index)

    def encode(self, host, row0: int, d: Decoded) -> bytes:
        return block_of_segments(*host)


class _Pass1Transform(_PanelTransform):
    """Streamed pass 1: (t2, n1) panels, twiddled in the same streamed job
    and encoded for the shuffle scatter."""

    site = "ooc.pass1"

    def __init__(self, f: OocPlan, impl: str, verify: str, device):
        super().__init__(f, f.t2, f.n1, impl, verify, device)

    def encode(self, host, row0: int, d: Decoded) -> bytes:
        # the global twiddle W_n^{j2*k1}, applied in the same streamed job
        # (no extra storage pass; j2 offset comes from the job index)
        yr, yi = host
        tr, ti = _apply_twiddle(yr, yi, d.index * self.f.t2, self.f.n)
        return block_of_segments(tr, ti)


# ---------------------------------------------------------------------------
# phase-2 plumbing: row-of-tiles gather + final offset-named output writes


class _Pass2Store:
    """Job r's "block" is its row of C shuffle tiles, CRC-verified against
    the journal and assembled into one (t1, n2) panel; the output side
    writes the final spectrum block at offset r * t1*n2*8 (offset-named,
    so the standard offset-ordered getmerge concatenation applies)."""

    def __init__(self, inter_dir: os.PathLike, f: OocPlan,
                 journal: TileJournal, io: _IoCounter, injector=None,
                 verify: str = "off"):
        self.inter = Path(inter_dir)
        self.f = f
        self.journal = journal
        self.io = io
        self.injector = injector
        self.verify = abft.check_mode(verify)

    def read_block(self, index: int) -> bytes:
        f = self.f
        tiles = []
        for c in range(f.pass1_jobs):
            maybe_fire(self.injector, "ooc.pass2",
                       index * f.pass1_jobs + c)
            name = _tile_name(index, c)
            blob = (self.inter / name).read_bytes()
            want = self.journal.crc(name)
            if want is not None and _crc(blob) != want:
                raise IOError(
                    f"shuffle tile {name} failed its journaled CRC "
                    f"(pass-2 job {index})")
            self.io.add("shuffle_read", len(blob))
            tile = np.frombuffer(blob, np.float32).reshape(f.t1, f.t2, 2)
            if self.verify != "off":
                # re-measure the ABFT side-channel: the tile's energy must
                # match what pass 1 journaled (same values, same float64
                # reduction — summation-order noise only)
                want_e = self.journal.energy(name)
                if want_e is not None:
                    got_e = abft.energy(tile)
                    tol = 1e-9 * (want_e + 1e-30)
                    if abs(got_e - want_e) > tol:
                        raise abft.fail("ooc.pass2", index,
                                        check="tile_energy", tile=name,
                                        expected=want_e, got=got_e, tol=tol)
            tiles.append(tile)
        return np.concatenate(tiles, axis=1).tobytes()

    def write_output_block(self, out_dir: os.PathLike, index: int,
                           data: bytes) -> None:
        maybe_fire(self.injector, "blockstore.write", index)
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        offset = index * self.f.pass2_panel_bytes
        _atomic_write(out / f"block_{offset:016d}.bin", data)
        self.io.add("output_write", len(data))


# ---------------------------------------------------------------------------


@dataclass
class OocStats:
    """Per-run observability: phase stats + measured I/O vs the model."""

    pass1: JobStats | None = None
    pass2: JobStats | None = None
    pass1_attempts: int = 0  # attempts THIS run (0 on a post-pass-1 resume)
    pass2_attempts: int = 0
    wall_s: float = 0.0
    io: dict = field(default_factory=dict)

    def as_dict(self) -> dict:
        def job(s):
            return None if s is None else {
                "blocks_done": s.blocks_done, "attempts": s.attempts,
                "retries": s.retries, "batches": s.batches,
                "stage_s": dict(s.stage_s), "wall_s": s.wall_s}
        return {"pass1": job(self.pass1), "pass2": job(self.pass2),
                "pass1_attempts": self.pass1_attempts,
                "pass2_attempts": self.pass2_attempts,
                "wall_s": self.wall_s, "io": self.io}


class OutOfCorePlan:
    """An executable out-of-core transform bound to a `BlockStore`.

    Build via ``repro_torch.fft.plan(kind="c2c", n=...,
    placement="out_of_core", store=..., work_dir=..., budget_bytes=...)``.
    Not process-cached (it carries live store/directory state); the
    per-pass FFT plans it launches ARE the cached `ExecutablePlan`s, so
    repeat jobs rebuild nothing.

    ``device`` is where the passes' FFTs run: "cuda" (default; raises at
    construction when no card is present) or "cpu" (plain versions).
    ``impl`` is the passes' leaf: "matfft" (default: K1/K2), "stockham"
    (K4) or "ref" (torch.fft).

    Layout under ``work_dir``:
      tiles/                 the shuffle tiles (intermediate, 1 operand)
      out/                   final offset-named spectrum blocks
      pass1_manifest.json    phase-1 job journal (crash-resume)
      pass2_manifest.json    phase-2 job journal
      tiles.jsonl            append-only tile CRC journal
    """

    def __init__(self, factors: OocPlan, store: BlockStore,
                 work_dir: os.PathLike, impl: str = "matfft",
                 config: JobConfig | None = None, verify: str = "off",
                 device="cuda"):
        from repro_torch.fft.spec import resolve_device
        self.device = resolve_device(device)  # no card: fail before work
        self.factors = factors
        self.store = store
        self.impl = impl
        # "abft" on the out-of-core path adds nothing over "parseval":
        # panels launch as single uniform jobs (no coalesced groups to
        # disambiguate), so both modes run the energy-invariant chain —
        # decode energy -> realize Parseval -> scatter conservation ->
        # journaled tile energies -> pass-2 re-checks
        self.verify = abft.check_mode(verify)
        self.work_dir = Path(work_dir)
        self.work_dir.mkdir(parents=True, exist_ok=True)
        self.tiles_dir = self.work_dir / "tiles"
        self.out_dir = self.work_dir / "out"
        cfg = config or JobConfig(
            readers=2, writers=2, coalesce=1, inflight=2, speculation=False)
        # coalesce is forced to 1: each job is already a full-panel batch,
        # and the working-set bound assumes one panel per pipeline slot
        self.cfg = replace(cfg, coalesce=1)
        self.injector = self.cfg.injector
        self.journal = TileJournal(self.work_dir / "tiles.jsonl")
        self.io = _IoCounter()

    # convenience mirrors of the factorization's cost model
    @property
    def n(self) -> int:
        return self.factors.n

    @property
    def passes(self) -> int:
        return self.factors.passes

    @property
    def io_bytes(self) -> int:
        return self.factors.io_bytes

    @property
    def shuffle_bytes(self) -> int:
        return self.factors.shuffle_bytes

    @property
    def working_set_bytes(self) -> int:
        return self.factors.working_set_bytes

    @property
    def operand_bytes(self) -> int:
        return self.factors.operand_bytes

    @property
    def flops(self) -> float:
        return self.factors.flops

    # ------------------------------------------------------------------
    def _run_phase(self, which: int) -> JobStats:
        f = self.factors
        if which == 1:
            store = _Pass1Store(self.store, f, self.journal, self.io,
                                self.injector, verify=self.verify)
            transform = _Pass1Transform(f, self.impl, self.verify,
                                        self.device)
            manifest = Manifest(self.work_dir / "pass1_manifest.json",
                                f.pass1_jobs)
            out_dir = self.tiles_dir
        else:
            store = _Pass2Store(self.tiles_dir, f, self.journal, self.io,
                                self.injector, verify=self.verify)
            transform = _PanelTransform(f, f.t1, f.n2, self.impl,
                                        self.verify, self.device)
            manifest = Manifest(self.work_dir / "pass2_manifest.json",
                                f.pass2_jobs)
            out_dir = self.out_dir
        # a resumed run is a NEW job invocation: blocks journaled FAILED
        # (retry budget exhausted in a previous run) get a fresh budget —
        # only DONE is durable across runs (RUNNING already demotes to
        # PENDING inside Manifest's crash replay)
        for i, t in manifest.tasks.items():
            if t.status == FAILED:
                manifest.update(i, status=PENDING, error=None)
        stats = JobStats()
        StreamExecutor(store, out_dir, transform, self.cfg, manifest,
                       stats).run()
        return stats

    def run_pass1(self) -> JobStats:
        """Phase 1 + shuffle only (checkpointable; resume re-runs nothing
        once every job is journaled DONE)."""
        return self._run_phase(1)

    def run_pass2(self) -> JobStats:
        """Phase 2 only; requires the shuffle to be complete."""
        m1 = Manifest(self.work_dir / "pass1_manifest.json",
                      self.factors.pass1_jobs)
        incomplete = self.factors.pass1_jobs - len(m1.done())
        m1.close()
        if incomplete:
            raise RuntimeError(
                f"pass 2 needs a complete shuffle: {incomplete} pass-1 "
                f"job(s) not DONE in {self.work_dir / 'pass1_manifest.json'}"
                f"; run run_pass1()/execute() first")
        return self._run_phase(2)

    def execute(self) -> OocStats:
        """Run (or resume) the full transform. Each phase's `Manifest`
        replays its journal first, so a crash mid-shuffle re-runs only the
        pass-1 jobs whose tiles never all landed, and a crash mid-pass-2
        re-runs only unfinished pass-2 jobs — completed pass-1 work is
        never redone."""
        t0 = time.monotonic()
        s = OocStats()
        s.pass1 = self.run_pass1()
        s.pass1_attempts = s.pass1.attempts
        s.pass2 = self.run_pass2()
        s.pass2_attempts = s.pass2.attempts
        s.wall_s = time.monotonic() - t0
        s.io = self.io.as_dict()
        return s

    def merge(self, dest: os.PathLike) -> int:
        """Offset-ordered concat of the final spectrum blocks (getmerge)."""
        f = self.factors
        expect = [f"block_{r * f.pass2_panel_bytes:016d}.bin"
                  for r in range(f.pass2_jobs)]
        missing = [n for n in expect if not (self.out_dir / n).exists()]
        if missing:
            raise IOError(f"merge: {len(missing)} output blocks missing "
                          f"(first: {missing[0]}); run execute() first")
        total = 0
        with open(dest, "wb") as out:
            for name in expect:
                data = (self.out_dir / name).read_bytes()
                out.write(data)
                total += len(data)
        return total


def plan_out_of_core(n: int, store: BlockStore, work_dir: os.PathLike,
                     budget_bytes: int, impl: str = "matfft",
                     config: JobConfig | None = None,
                     verify: str = "off",
                     device="cuda", panel_scale: int = 1) -> OutOfCorePlan:
    """Factor + bind: the `placement="out_of_core"` entry point.
    ``panel_scale`` is `factor_out_of_core`'s panel-height knob, which the
    autotuner sets (`repro_torch.fft.tuner.tune_out_of_core`)."""
    factors = factor_out_of_core(n, budget_bytes,
                                 block_bytes=store.block_bytes,
                                 panel_scale=panel_scale)
    return OutOfCorePlan(factors, store, work_dir, impl=impl, config=config,
                         verify=verify, device=device)


# ---------------------------------------------------------------------------
# layout helpers + the in-memory oracle


def corner_turn(v: np.ndarray, factors: OocPlan) -> np.ndarray:
    """The layout operator T: decimated storage order <-> natural order.

    T maps the stored operand to the natural-order signal AND the
    natural-order spectrum to the emitted (transposed-order) output —
    ``out == T(np.fft.fft(T(s)))``. In-memory only (tests and checks at
    verifiable sizes); ``v`` is (n,) complex-like or (n, k) with trailing
    component axes carried along.
    """
    f = factors
    return np.ascontiguousarray(
        v.reshape(f.n2, f.n1, *v.shape[1:]).swapaxes(0, 1)).reshape(v.shape)


def reference_out_of_core(sig: np.ndarray, factors: OocPlan,
                          impl: str = "matfft", device="cuda") -> bytes:
    """In-memory oracle: the SAME decomposition as the streamed path —
    same panel-shaped cached plans on the same device, same host twiddle
    helper, same encode — on interleaved (n, 2) float32, without the
    storage round-trips. Returns merged output bytes in the transposed
    spectral order out[k1*n2 + k2]; the streamed result must match it
    BITWISE."""
    import repro_torch.fft as fft_api
    from repro_torch.fft.spec import resolve_device
    device = resolve_device(device)
    f = factors
    m = sig.reshape(f.n2, f.n1, 2)

    def run(p, xr, xi):
        yr, yi = p.execute(torch.from_numpy(np.ascontiguousarray(xr)),
                           torch.from_numpy(np.ascontiguousarray(xi)))
        return yr.cpu().numpy(), yi.cpu().numpy()

    p1 = fft_api.plan(kind="c2c", n=f.n1, batch_shape=(f.t2,), impl=impl,
                      device=device)
    tr = np.empty((f.n2, f.n1), np.float32)
    ti = np.empty((f.n2, f.n1), np.float32)
    for c in range(f.pass1_jobs):
        rows = slice(c * f.t2, (c + 1) * f.t2)
        yr, yi = run(p1, m[rows, :, 0], m[rows, :, 1])
        tr[rows], ti[rows] = _apply_twiddle(yr, yi, c * f.t2, f.n)
    tr = np.ascontiguousarray(tr.T)  # the shuffle: (n1, n2), k1-major
    ti = np.ascontiguousarray(ti.T)
    p2 = fft_api.plan(kind="c2c", n=f.n2, batch_shape=(f.t1,), impl=impl,
                      device=device)
    parts = []
    for r in range(f.pass2_jobs):
        rows = slice(r * f.t1, (r + 1) * f.t1)
        parts.append(block_of_segments(*run(p2, tr[rows], ti[rows])))
    return b"".join(parts)
