"""Measuring autotuner and persistent wisdom for
`repro_torch.fft.plan(tune=True)`.

The planner's analytic cost model ranks strategies by roofline numerators;
FFTW's wisdom is the classic case for choosing a plan by measuring it. This
module is the JAX package's `repro.fft.tuner` on PyTorch:

  * `tune(...)` enumerates the candidate knobs of a spec, those that
    change a launch: the overlap chunk count of the distributed placements
    (which picks the exchange engine: "off" is one `all_to_all_single` a
    plane, an int that many slabs of `batch_isend_irecv` rounds) and the
    layout (zero_copy against copy, where a pass reads it:
    `_layout_changes_a_launch`); builds each candidate at a representative
    shape, times it (the least of ``repeats`` wall-clock runs of the
    plan's own execute, the device synchronized), and returns the winner's
    knobs.
  * The decision persists as wisdom: a JSON file keyed on the resolved
    spec with the knobs normalized out, the mesh's fingerprint and the
    backend (the card's name and driver, or "cpu"). A wisdom hit is a
    lookup: zero measurements.
  * Every candidate is also ranked by the analytic model (`modeled_wall`);
    when the measured and modeled winners differ the report says so and a
    `tune_disagreement` event records it.
  * `tune_out_of_core(...)` picks the out-of-core panel height
    (`panel_scale`) on the disk model, or with an injected measurer.

The JAX package also tunes its batch tile, the rows of a Pallas grid
step. The port has none: a CUDA block stages one fixed tile of MAX_LEAF
points. A level-0 1-D transform runs the same kernel at either layout, so
there the tuner offers zero_copy alone, and stores no winner that is the
noise between two timings of one launch.

The representative shape. On the CPU, the JAX package's `_shrink`: at most
16 rows (segmented: 2 a rank), the trailing axis cut to 1024 and earlier
ones to 64, distributed signals to max(D^2, 4096) points and pencils to
max(64, 2 * the largest grid factor) an axis. On CUDA the transform shape
is kept (the passes the layout changes depend on the lengths) and only
the batch is cut, to the fewest rows, a power of two, that hold
MEASURE_WAVES full waves of blocks (MAX_LEAF points each,
KERNEL_BLOCKS_PER_SM to an SM), or every row: on an H100, 8 x 132 x 4 x
4096 = 17.3 M points. Fewer rows would time a card that is mostly idle.

SPMD. On a mesh every rank runs `tune` with the same arguments. Rank 0 of
the mesh's group looks the wisdom up and broadcasts what it found; on a
miss every rank measures every candidate in the same order, the times are
gathered and each candidate's time is its slowest rank's, so every rank
picks the same knobs; only rank 0 writes the file. A candidate that fails
to build or run on any rank is dropped on all of them. A failure inside a
collective on one rank is not caught: the others wait until the group's
timeout.

Measurement is injectable for tests: a `TuneConfig` carries the seed, the
repeat count, a ``timer`` and a ``measurer`` ("analytic" ranks on the
model alone; a callable gets ``(plan, config)`` and returns seconds).
Candidates that fail are dropped and logged (`tune_candidate_failed`); a
corrupt or truncated wisdom file degrades to measuring with a logged
`wisdom_corrupt` event; a spec that cannot resolve returns no knobs, so
`plan()` raises its own error.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from dataclasses import dataclass, field, replace
from pathlib import Path

import torch

from repro_torch.core.resilience.events import record_event
from repro_torch.fft import spec as spec_mod
from repro_torch.kernels.fft import plan as kplan

WISDOM_VERSION = 1
DEFAULT_WISDOM_PATH = "~/.cache/repro_torch_fft/wisdom.json"

# The analytic model's rates, by device type. Absolute values cancel in
# the ranking; their ratios matter.
#   cpu: the JAX package's constants (repro/fft/tuner.py:57-63), fitted to
#     its CPU container; the port keeps them for device="cpu".
#   cuda: measured by chip_smoke.py (its "model rates" line) on an NVIDIA
#     H100 80GB HBM3 at a 700.00 W power limit (PERF.md §6, PR 20, chip
#     run 1): hbm_bps and peak_flops are the bytes and flops over the time
#     of K1b's main-path case (32768 x 1024 rows), ici_bps an
#     `all_to_all_single` of 256 MiB on a one-rank NCCL group (a copy on
#     the card: the only exchange one card has), disk_bps and
#     job_overhead_s the 2^28-point out-of-core run's storage traffic over
#     its read and write thread-seconds, and its other stage
#     thread-seconds over its jobs.
MODEL_RATES = {
    "cpu": {"peak_flops": 5e10, "hbm_bps": 2e10, "ici_bps": 5e9,
            "disk_bps": 250e6, "job_overhead_s": 5e-3},
    "cuda": {"peak_flops": 6078067215939.35,
             "hbm_bps": 1945011187163.1697,
             "ici_bps": 685978966219.8177,
             "disk_bps": 152175019.76990408,
             "job_overhead_s": 0.03611544492187768},
}
COPY_PENALTY = 0.5  # layout="copy" adds this fraction of the hbm time (its
#                     materialized transposes); a share, not a rate
OOC_PANEL_SCALES = (1, 2, 4)
# the knobs a wisdom entry holds; an entry with any other set is stale
KNOBS = ("overlap", "layout")
# CUDA measurement shape: full waves of blocks
MEASURE_WAVES = 8
KERNEL_BLOCKS_PER_SM = 4  # csrc/matfft.cu MIN_BLOCKS
# a timed CUDA batch: back-to-back executes filling at least this long
MIN_BATCH_S = 5e-3
MAX_BATCH_CALLS = 1000


@dataclass
class TuneConfig:
    """The measurement protocol's knobs (all injectable). A rate left None
    takes `MODEL_RATES` of the plan's device type."""

    seed: int = 0                 # operand generator seed
    repeats: int = 3              # least of N wall-clock runs
    timer: object = None          # monotonic clock; None = perf_counter
    measurer: object = None       # None = the wall clock around execute;
    #                               "analytic" = rank on modeled_wall;
    #                               callable(plan, cfg) -> seconds
    peak_flops: float | None = None
    hbm_bps: float | None = None
    ici_bps: float | None = None
    disk_bps: float | None = None
    job_overhead_s: float | None = None

    def rates(self, device_type: str) -> dict:
        """The model's rates for ``device_type``, this config's overrides
        first."""
        base = MODEL_RATES["cuda" if device_type == "cuda" else "cpu"]
        return {k: (getattr(self, k) if getattr(self, k) is not None
                    else v) for k, v in base.items()}


@dataclass
class TuneReport:
    """What one tune() call did (a wisdom hit or a measurement sweep)."""

    key: str                      # the wisdom key consulted
    wisdom_hit: bool              # True: zero measurements
    winner: dict                  # the chosen knobs
    candidates: list = field(default_factory=list)  # per-candidate rows
    measurements: int = 0         # candidate timings made (0 on a hit)
    disagreement: bool = False    # measured argmin != modeled argmin
    degraded: bool = False        # tuning failed; the defaults kept
    meas_shape: tuple | None = None   # the representative shape measured
    meas_batch: tuple | None = None


_STATS_LOCK = threading.Lock()
# one tuning at a time in a process: worker threads that plan the same spec
# together (the map-only job's) wait, and then hit the first one's wisdom
# instead of timing candidates against each other
_TUNE_LOCK = threading.Lock()
_STATS = {"tuned": 0, "wisdom_hits": 0, "measurements": 0,
          "disagreements": 0, "degraded": 0}


def tune_stats() -> dict:
    """Process-level tuner counters (reported by launch/fft_job.py)."""
    with _STATS_LOCK:
        return dict(_STATS)


def reset_tune_stats() -> None:
    with _STATS_LOCK:
        for k in _STATS:
            _STATS[k] = 0


def _bump(key: str, by: int = 1) -> None:
    with _STATS_LOCK:
        _STATS[key] += by


# ---------------------------------------------------------------------------
# wisdom persistence


class WisdomStore:
    """One wisdom file: tolerant load, atomic writes, one object a path in
    the process.

    A corrupt or truncated file never raises: it logs a `wisdom_corrupt`
    event and loads as empty (the caller measures, and the next record
    replaces the bad file). Writes go through a temporary file and
    `os.replace`, so a crash mid-write leaves the old wisdom whole.
    """

    _REGISTRY: dict = {}
    _REGISTRY_LOCK = threading.Lock()

    def __init__(self, path):
        self.path = Path(path).expanduser()
        self._lock = threading.Lock()
        self._entries: dict = {}
        self._load()

    @classmethod
    def get(cls, path=None) -> "WisdomStore":
        p = str(Path(path or DEFAULT_WISDOM_PATH).expanduser())
        with cls._REGISTRY_LOCK:
            store = cls._REGISTRY.get(p)
            if store is None:
                store = cls._REGISTRY[p] = cls(p)
            return store

    def _load(self) -> None:
        try:
            raw = self.path.read_text()
        except FileNotFoundError:
            return
        except OSError as e:
            record_event("wisdom_corrupt", path=str(self.path),
                         error=repr(e))
            return
        try:
            doc = json.loads(raw)
            if not isinstance(doc, dict):
                raise ValueError("wisdom document is not an object")
            if doc.get("version") != WISDOM_VERSION:
                raise ValueError(
                    f"wisdom version {doc.get('version')!r} != "
                    f"{WISDOM_VERSION}")
            entries = doc.get("entries")
            if not isinstance(entries, dict):
                raise ValueError("wisdom entries missing or not an object")
            self._entries = entries
        except (ValueError, KeyError, TypeError) as e:
            record_event("wisdom_corrupt", path=str(self.path),
                         error=repr(e))
            self._entries = {}

    def lookup(self, key: str):
        with self._lock:
            entry = self._entries.get(key)
            return dict(entry) if isinstance(entry, dict) else None

    def record(self, key: str, entry: dict) -> None:
        with self._lock:
            self._entries[key] = entry
            try:
                self.path.parent.mkdir(parents=True, exist_ok=True)
                tmp = self.path.with_name(self.path.name + ".tmp")
                tmp.write_text(json.dumps(
                    {"version": WISDOM_VERSION, "entries": self._entries},
                    indent=1, sort_keys=True))
                os.replace(tmp, self.path)
            except OSError as e:
                # wisdom saves measurements, it holds no result: an
                # unwritable directory leaves tuning per process
                record_event("wisdom_write_failed", path=str(self.path),
                             error=repr(e))

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


def backend_name(device) -> str:
    """The hardware half of a wisdom key: "cpu", or the CUDA card's name
    with the CUDA runtime and driver versions."""
    dev = spec_mod.resolve_device(device)
    if dev.type != "cuda":
        return "cpu"
    get_driver = getattr(torch._C, "_cuda_getDriverVersion", None)
    driver = get_driver() if get_driver is not None else "?"
    return (f"cuda:{torch.cuda.get_device_name(dev)}:runtime "
            f"{torch.version.cuda}:driver {driver}")


def mesh_fingerprint(mesh) -> str:
    """Identity of the mesh a decision was measured on: its rank count,
    dim names and sizes, the world size and the process group's backend.
    Wisdom from a mesh of another shape keys differently and is never
    consulted."""
    if mesh is None:
        return "mesh=none"
    import torch.distributed as dist
    names = mesh.mesh_dim_names or tuple(
        f"dim{i}" for i in range(mesh.mesh.dim()))
    axes = ",".join(f"{a}={mesh.size(i)}" for i, a in enumerate(names))
    return (f"devices={mesh.mesh.numel()};axes={axes};"
            f"world={dist.get_world_size()};backend={dist.get_backend()};"
            f"type={mesh.device_type}")


def wisdom_key(base_spec, mesh) -> str:
    """version | backend | mesh fingerprint | the knob-neutral spec. The
    knobs (layout, overlap) are normalized out: they are the wisdom's
    value, not its identity."""
    neutral = replace(base_spec, layout="zero_copy", overlap="off")
    return (f"v{WISDOM_VERSION}|backend={backend_name(base_spec.device)}|"
            f"{mesh_fingerprint(mesh)}|{neutral!r}")


# ---------------------------------------------------------------------------
# the analytic side of the comparison


def modeled_wall(plan, cfg: TuneConfig) -> float:
    """The model's wall for one execute of ``plan``: flops and device
    bytes over the device's rates, plus the collective bytes the engine
    cannot hide and the copy layout's transpose share. It ranks the same
    candidates the measurements rank; where the two disagree the report
    says so."""
    r = cfg.rates(plan.device.type)
    hbm_t = plan.hbm_bytes / r["hbm_bps"]
    wall = (plan.flops / r["peak_flops"] + hbm_t
            + plan.exposed_collective_bytes / r["ici_bps"])
    if plan.spec.layout == "copy":
        wall += COPY_PENALTY * hbm_t
    return wall


def modeled_ooc_wall(factors, cfg: TuneConfig,
                     device_type: str = "cpu") -> float:
    """The disk model's wall for an out-of-core factorization: the
    streamed I/O at the disk rate, a fixed overhead a job and the
    transform's flops."""
    r = cfg.rates(device_type)
    jobs = factors.pass1_jobs + factors.pass2_jobs
    flops = 5.0 * factors.n * math.log2(max(factors.n, 2))
    return (factors.io_bytes / r["disk_bps"]
            + jobs * r["job_overhead_s"] + flops / r["peak_flops"])


# ---------------------------------------------------------------------------
# candidate space and the representative shape


def _layout_changes_a_launch(base) -> bool:
    """Whether ``layout`` changes a launch of ``base``. Only
    `executors.axis_pass` and `executors._four_step` read it, and for
    every impl but "matfft" both take the copy path at either layout. A
    matfft pass runs through one of them in a level-1 four-step of the
    contiguous axis (at half length on the packed r2c path), in an earlier
    N-D axis, and in the distributed placements; a level-0 1-D transform
    launches the same kernel at either layout."""
    if base.impl != "matfft":
        return False
    if base.placement == "distributed" or any(d > 1
                                              for d in base.shape[:-1]):
        return True
    last = base.shape[-1]
    if base.kind == "r2c" and last >= 4:
        last //= 2
    return kplan.make_plan(last).levels > 1


def _cuda_shape(base, num_devices, sms: int):
    """The CUDA measurement's (shape, batch_shape): the full transform
    shape, and the fewest rows, a power of two a rank, that hold
    MEASURE_WAVES full waves of blocks on each card of ``sms`` SMs
    (segmented: on each of its ``num_devices`` ranks), or every row."""
    if not base.batch_shape:
        return base.shape, ()
    ranks = num_devices if base.placement == "segmented" else 1
    points = MEASURE_WAVES * sms * KERNEL_BLOCKS_PER_SM * kplan.MAX_LEAF
    need = max(1, -(-points // max(base.n, 1)))
    return base.shape, (min(base.rows, ranks << (need - 1).bit_length()),)


def _shrink(base, num_devices, grid, device):
    """The representative (shape, batch_shape) of a base spec, in the same
    class as the full spec (placement, divisibility, powers of two): the
    module docstring's rule, on the CPU the JAX package's."""
    dev = spec_mod.resolve_device(device)
    if dev.type == "cuda":
        return _cuda_shape(base, num_devices, torch.cuda.get_device_properties(
            dev).multi_processor_count)
    if base.placement == "distributed":
        if base.ndim == 1:
            d = num_devices
            return (min(base.shape[0], max(d * d, 1 << 12)),), ()
        gmax = max(grid)
        return tuple(min(dim, max(64, 2 * gmax)) for dim in base.shape), ()
    dims = tuple(min(dim, 1024 if i == base.ndim - 1 else 64)
                 for i, dim in enumerate(base.shape))
    rows = base.rows
    if base.placement == "segmented":
        b = min(rows, 2 * (num_devices or 1))
    else:
        b = min(rows, 16)
    return dims, ((b,) if base.batch_shape else ())


def _spec_ok(kwargs) -> bool:
    try:
        spec_mod.resolve(**kwargs)
        return True
    except (ValueError, NotImplementedError):
        return False


def _candidates(base) -> list:
    """The knob combinations, in one order on every rank. The base spec's
    own (resolved) knobs are candidate 0, so under one measurer the
    winner never ranks behind the default; "copy" only where it changes a
    launch (`_layout_changes_a_launch`)."""
    layouts = (["zero_copy", "copy"] if _layout_changes_a_launch(base)
               else ["zero_copy"])
    overlaps: list = ["off"]
    if base.placement == "distributed":
        overlaps += [2, 4, 8]
    combos = [{"overlap": base.overlap, "layout": base.layout}]
    for ov in overlaps:
        for ly in layouts:
            combos.append({"overlap": ov, "layout": ly})
    seen, out = set(), []
    for c in combos:
        k = (c["overlap"], c["layout"])
        if k not in seen:
            seen.add(k)
            out.append(c)
    return out


def _measure_exec(plan, cfg: TuneConfig) -> float:
    """The default measurer: seeded operands made on the plan's device, one
    warm execute (it builds the kernels and tables), then the least of
    ``repeats`` wall-clock runs, each ending in a device synchronize (CUDA
    returns before the work is done). On CUDA a run is a batch of
    back-to-back executes, as many as fill MIN_BATCH_S by the warm call's
    time, and the time is the batch's over its executes: at 50 us an
    execute, one synchronize and the host's jitter a run would swamp the
    kernels' difference."""
    timer = cfg.timer or time.perf_counter
    dev = plan.device
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    ops = tuple(torch.randn(plan.operand_shape, generator=gen, device=dev)
                for _ in range(1 if plan.kind == "r2c" else 2))
    run = plan.execute_real if plan.kind == "r2c" else plan.execute

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    run(*ops)
    sync()
    calls = 1
    if dev.type == "cuda":
        t0 = timer()
        run(*ops)
        sync()
        one = max(timer() - t0, 1e-7)
        calls = max(1, min(MAX_BATCH_CALLS, math.ceil(MIN_BATCH_S / one)))
    best = math.inf
    for _ in range(max(cfg.repeats, 1)):
        t0 = timer()
        for _ in range(calls):
            out = run(*ops)
        sync()
        best = min(best, (timer() - t0) / calls)
        del out
    return best


def _measure(plan, cfg: TuneConfig) -> float:
    if cfg.measurer == "analytic":
        return modeled_wall(plan, cfg)
    if callable(cfg.measurer):
        return float(cfg.measurer(plan, cfg))
    return _measure_exec(plan, cfg)


# ---------------------------------------------------------------------------
# one decision for the whole mesh

_MESH_GROUPS: dict = {}
_MESH_GROUPS_LOCK = threading.Lock()


def _mesh_group(mesh):
    """(group, size) of every rank of ``mesh``; (None, 1) without a mesh
    or on one rank. Built once a mesh (a collective call)."""
    if mesh is None or mesh.mesh.numel() == 1:
        return None, 1
    from repro_torch.core.fft import distributed
    with _MESH_GROUPS_LOCK:
        ex = _MESH_GROUPS.get(mesh)
        if ex is None:
            ex = _MESH_GROUPS[mesh] = distributed._Exchange(
                mesh, distributed.mesh_axes(mesh))
    return ex.group, ex.d


def _leader(group) -> bool:
    import torch.distributed as dist
    return group is None or dist.get_group_rank(group, dist.get_rank()) == 0


def _broadcast(obj, group):
    """Group rank 0's ``obj`` on every rank of ``group``."""
    if group is None:
        return obj
    import torch.distributed as dist
    box = [obj]
    dist.broadcast_object_list(box, src=dist.get_global_rank(group, 0),
                               group=group)
    return box[0]


def _slowest(times: list, group, size: int) -> list:
    """Each candidate's time on the slowest rank (None where any rank
    failed it), the same list on every rank."""
    if group is None:
        return times
    import torch.distributed as dist
    every = [None] * size
    dist.all_gather_object(every, times, group=group)
    return [None if any(t[i] is None for t in every)
            else max(t[i] for t in every) for i in range(len(times))]


# ---------------------------------------------------------------------------
# the entry points


def tune(*, kind, n=None, shape=None, batch_shape=(), mesh=None, axes=None,
         num_devices=None, axis_sizes=None, placement="auto",
         layout="zero_copy", impl="matfft", precision="f32", device="cuda",
         natural_order=True, fuse_twiddle=False,
         overlap="auto", r2c_axis=-1, verify="off", wisdom_path=None,
         config: TuneConfig | None = None):
    """Pick (layout, overlap) for a spec by measurement.

    Returns ``(knobs, TuneReport)``. On a wisdom hit the knobs come from
    the file (zero measurements). On a miss every valid candidate is built
    at the representative shape and measured, and the winner is recorded.
    Returns ``({}, report)`` with ``degraded`` set when the base spec does
    not resolve or no candidate measures; the caller's `plan()` then
    raises the real error or keeps its defaults. On a mesh, every rank
    calls it with the same arguments and gets the same knobs (module
    docstring).
    """
    with _TUNE_LOCK:
        return _tune(config or TuneConfig(), wisdom_path, mesh, dict(
            kind=kind, n=n, shape=shape, batch_shape=batch_shape,
            placement=placement, layout=layout, impl=impl,
            precision=precision, device=device, num_devices=num_devices,
            axes=axes, natural_order=natural_order, fuse_twiddle=fuse_twiddle, overlap=overlap, r2c_axis=r2c_axis,
            verify=verify, axis_sizes=axis_sizes))


def _tune(cfg: TuneConfig, wisdom_path, mesh, base_kwargs: dict):
    """`tune`'s body, under the process's tuning lock."""
    num_devices = base_kwargs["num_devices"]
    _bump("tuned")
    try:
        base = spec_mod.resolve(**base_kwargs)
    except (ValueError, NotImplementedError) as e:
        _bump("degraded")
        record_event("tune_degraded", reason="resolve_failed",
                     error=repr(e))
        return {}, TuneReport(key="", wisdom_hit=False, winner={},
                              degraded=True)
    key = wisdom_key(base, mesh)
    store = WisdomStore.get(wisdom_path)
    group, size = _mesh_group(mesh)
    leader = _leader(group)

    entry = _broadcast(store.lookup(key) if leader else None, group)
    if entry is not None:
        knobs = dict(entry.get("knobs") or {})
        # stale knobs under a colliding key (another set of knobs, or
        # knobs that no longer resolve) are measured afresh
        if set(knobs) == set(KNOBS) and _spec_ok({**base_kwargs, **knobs}):
            _bump("wisdom_hits")
            return knobs, TuneReport(
                key=key, wisdom_hit=True, winner=knobs,
                candidates=entry.get("candidates", []), measurements=0,
                disagreement=bool(entry.get("disagreement", False)))
        record_event("wisdom_stale", key=key, knobs=knobs)

    # ---- the measurement sweep -------------------------------------------
    grid = None
    if base.placement == "distributed" and base.ndim > 1:
        from repro_torch.core.fft.distributed import pencil_grid
        grid = pencil_grid(base.shape, num_devices,
                           base_kwargs["axis_sizes"])
    meas_shape, meas_batch = _shrink(base, num_devices, grid, base.device)
    meas_kwargs = {**base_kwargs, "n": None, "shape": meas_shape,
                   "batch_shape": meas_batch, "placement": base.placement}

    from repro_torch.fft import planner
    tried, times, modeled = [], [], []
    for knobs in _candidates(base):
        if not (_spec_ok({**base_kwargs, **knobs})
                and _spec_ok({**meas_kwargs, **knobs})):
            continue
        try:
            p = planner.plan(
                **{k: base_kwargs[k] for k in (
                    "kind", "impl", "precision", "axes", "natural_order",
                    "fuse_twiddle", "r2c_axis", "verify")},
                shape=meas_shape, batch_shape=meas_batch, mesh=mesh,
                placement=base.placement, device=base.device, **knobs)
            measured = float(_measure(p, cfg))
            model = float(modeled_wall(p, cfg))
        except Exception as e:  # noqa: BLE001 — a candidate, not the plan
            record_event("tune_candidate_failed", key=key, knobs=knobs,
                         error=repr(e))
            measured = model = None
        tried.append(knobs)
        times.append(measured)
        modeled.append(model)
    times = _slowest(times, group, size)
    results = [{"knobs": k, "measured_s": t, "modeled_s": m}
               for k, t, m in zip(tried, times, modeled) if t is not None]
    _bump("measurements", len(results))

    if not results:
        _bump("degraded")
        record_event("tune_degraded", reason="no_candidate_measured",
                     key=key)
        return {}, TuneReport(key=key, wisdom_hit=False, winner={},
                              degraded=True, meas_shape=meas_shape,
                              meas_batch=meas_batch)

    meas_i = min(range(len(results)),
                 key=lambda i: (results[i]["measured_s"], i))
    model_i = min(range(len(results)),
                  key=lambda i: (results[i]["modeled_s"], i))
    disagreement = results[meas_i]["knobs"] != results[model_i]["knobs"]
    if disagreement:
        _bump("disagreements")
        record_event(
            "tune_disagreement", key=key,
            measured_winner=results[meas_i]["knobs"],
            modeled_winner=results[model_i]["knobs"],
            measured_s=results[meas_i]["measured_s"],
            modeled_s=results[model_i]["modeled_s"])
    winner = dict(results[meas_i]["knobs"])
    if leader:
        store.record(key, {"knobs": winner,
                           "measured_s": results[meas_i]["measured_s"],
                           "modeled_s": results[meas_i]["modeled_s"],
                           "candidates": results,
                           "disagreement": disagreement,
                           "meas_shape": list(meas_shape),
                           "meas_batch": list(meas_batch)})
    return winner, TuneReport(
        key=key, wisdom_hit=False, winner=winner, candidates=results,
        measurements=len(results), disagreement=disagreement,
        meas_shape=meas_shape, meas_batch=meas_batch)


def tune_out_of_core(n: int, budget_bytes: int, *, impl: str = "ref",
                     block_bytes: int | None = None, wisdom_path=None,
                     config: TuneConfig | None = None, device="cuda"):
    """Tune the out-of-core panel height: try each valid ``panel_scale``
    on the disk model of ``device``'s rates (or an injected measurer,
    which gets the `OocPlan` factorization) and record the winner as
    wisdom.

    Returns ``(panel_scale, TuneReport)``; ``(1, report)`` with
    ``degraded`` set when no scale factors.
    """
    from repro_torch.core.fft.outofcore import factor_out_of_core
    cfg = config or TuneConfig()
    dev_type = spec_mod.resolve_device(device).type
    key = (f"v{WISDOM_VERSION}|ooc|backend={backend_name(device)}|"
           f"n={int(n)}|budget={int(budget_bytes)}|impl={impl}|"
           f"block={block_bytes}")
    store = WisdomStore.get(wisdom_path)
    _bump("tuned")
    entry = store.lookup(key)
    if entry is not None:
        knobs = dict(entry.get("knobs") or {})
        scale = int(knobs.get("panel_scale", 1))
        _bump("wisdom_hits")
        return scale, TuneReport(
            key=key, wisdom_hit=True, winner=knobs,
            candidates=entry.get("candidates", []), measurements=0,
            disagreement=bool(entry.get("disagreement", False)))

    results = []
    for scale in OOC_PANEL_SCALES:
        try:
            factors = factor_out_of_core(n, budget_bytes,
                                         block_bytes=block_bytes,
                                         panel_scale=scale)
        except ValueError:
            continue
        modeled = modeled_ooc_wall(factors, cfg, dev_type)
        measured = (float(cfg.measurer(factors, cfg))
                    if callable(cfg.measurer) else modeled)
        _bump("measurements")
        results.append({"knobs": {"panel_scale": scale},
                        "measured_s": measured, "modeled_s": modeled})
    if not results:
        _bump("degraded")
        record_event("tune_degraded", reason="no_ooc_candidate", key=key)
        return 1, TuneReport(key=key, wisdom_hit=False, winner={},
                             degraded=True)
    meas_i = min(range(len(results)),
                 key=lambda i: (results[i]["measured_s"], i))
    model_i = min(range(len(results)),
                  key=lambda i: (results[i]["modeled_s"], i))
    disagreement = meas_i != model_i
    if disagreement:
        _bump("disagreements")
        record_event("tune_disagreement", key=key,
                     measured_winner=results[meas_i]["knobs"],
                     modeled_winner=results[model_i]["knobs"])
    winner = dict(results[meas_i]["knobs"])
    store.record(key, {"knobs": winner,
                       "measured_s": results[meas_i]["measured_s"],
                       "modeled_s": results[meas_i]["modeled_s"],
                       "candidates": results,
                       "disagreement": disagreement})
    return int(winner["panel_scale"]), TuneReport(
        key=key, wisdom_hit=False, winner=winner, candidates=results,
        measurements=len(results), disagreement=disagreement)
