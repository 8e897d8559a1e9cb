"""Deterministic, seeded fault injection across every failure domain.

A chaos run that cannot be replayed is a flake generator, not a test. The
design here makes the *schedule* — which (site, block, call-number)
triples fault — a pure function of the `FaultPlan`, never of thread
timing: the plan is fully materialized up front (explicit rules, or rules
drawn once from a seeded RNG), and the injector counts calls per
``(site, block)`` so "block 3's first pass through realize faults" means
the same thing no matter how readers, the dispatcher, and writeback
workers interleave.

Injection sites (each threaded through its owning layer):

  ==================  =====================================================
  site                fires at
  ==================  =====================================================
  blockstore.read     `BlockStore.read_block` entry (I/O error -> the
                      job-level retry budget)
  blockstore.replica  the PRIMARY replica read inside the fallback loop
                      (exercises replica fallback + opportunistic repair)
  blockstore.write    `BlockStore.write_output_block` entry
  stream.decode       reader thread, before `transform.decode`
  stream.launch       dispatcher, before gather/launch (fires per group
                      member; one hit fails the whole coalesced batch)
  stream.realize      writeback worker, at the realization boundary —
                      AFTER the device sync, so pooled staging is already
                      safely released (simulates D2H/result corruption)
  stream.writeback    writeback worker, before per-block encode + write
  maponly.attempt     serial map-task attempt entry
  mesh.device         not raised: rule ``index`` names a mesh device
                      ordinal to mark lost in `meshstate` (consumed by
                      `FaultInjector.apply_device_loss`; the planner's
                      ``fallback="degrade"`` re-plans around it)
  ooc.shuffle         out-of-core pass-1 transposed-shuffle tile write
                      (core/fft/outofcore.py; index = r*C + c tile id)
  ooc.pass2           out-of-core pass-2 tile read/assemble (index =
                      r*C + c tile id)
  serve.admit         `FftService.submit` admission (index = request seq;
                      the request is rejected with a structured error, it
                      never enters the queue)
  serve.batch         batcher group formation, fired per member BEFORE
                      gather/launch — one hit fails the whole coalesced
                      batch pre-launch, members re-enter the retry path
  serve.execute       writeback realization, fired per member AFTER the
                      device sync (simulates D2H/result corruption; the
                      batch's results are discarded and members retried)
  ==================  =====================================================

All raising sites throw `InjectedFault` (an ``IOError`` subclass, so the
replica loop and every retry policy classify it as retryable I/O).

Rules come in two *kinds*. ``kind="raise"`` (the default, everything
above) throws at the site. ``kind="corrupt"`` never raises: the layer
calls the separate ``corrupt_scale``/``maybe_corrupt`` checkpoint AFTER
its integrity checks have passed (post-CRC realized outputs, journaled
tile payloads, service results) and the injector deterministically
perturbs one element of the data flowing through — a silent wrong answer
that only an algorithmic invariant (core/resilience/verify.py) can
catch. Corrupt checkpoints count calls in their own namespace, so adding
corruption points at a site never shifts the call numbering of existing
raise rules (same append-only stability contract as `SITES`).
"""

from __future__ import annotations

import json
import random
import threading
import zlib
from dataclasses import dataclass, field

import numpy as np

SITES = (
    "blockstore.read",
    "blockstore.replica",
    "blockstore.write",
    "stream.decode",
    "stream.launch",
    "stream.realize",
    "stream.writeback",
    "maponly.attempt",
    "mesh.device",
    # appended AFTER the original nine so seeded FaultPlan.random draws
    # for the pre-existing sites replay identically (same seed, same
    # schedule — the chaos gate's fixed-seed runs stay byte-stable)
    "ooc.shuffle",
    "ooc.pass2",
    # appended after the ooc pair, same append-only contract (asserted by
    # tests/test_resilience.py::test_seeded_schedule_stable_under_append)
    "serve.admit",
    "serve.batch",
    "serve.execute",
)

# sites a seeded random plan draws from by default: the raising, per-block
# sites (mesh.device loss is a state change, scheduled explicitly)
RANDOM_SITES = tuple(s for s in SITES if s != "mesh.device")


class InjectedFault(IOError):
    """A deterministic injected failure (retryable I/O by construction)."""


def _check_site(site: str) -> str:
    if site not in SITES:
        raise ValueError(
            f"unknown fault site {site!r}; expected one of {SITES}")
    return site


KINDS = ("raise", "corrupt")


@dataclass(frozen=True)
class FaultRule:
    """One scheduled fault: fire at ``site`` for block ``index`` on the
    given per-(site, index) ``calls`` (1-based; ``index=None`` matches
    every block, still counted per block).

    ``kind="raise"`` throws `InjectedFault` at the site's ``fire`` call;
    ``kind="corrupt"`` silently perturbs data at the site's
    ``corrupt_scale`` checkpoint instead, by ``scale`` (relative to the
    payload's L2 norm, so the perturbation is above any derived Parseval
    tolerance regardless of transform size)."""

    site: str
    index: int | None = None
    calls: tuple = (1,)
    kind: str = "raise"
    scale: float = 1.0

    def __post_init__(self):
        _check_site(self.site)
        calls = tuple(int(c) for c in self.calls)
        if not calls or min(calls) < 1:
            raise ValueError(f"calls must be 1-based call numbers, "
                             f"got {self.calls}")
        object.__setattr__(self, "calls", calls)
        if self.kind not in KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; expected one of {KINDS}")
        scale = float(self.scale)
        if not scale > 0.0 or not np.isfinite(scale):
            raise ValueError(f"scale must be finite and > 0, got {self.scale}")
        object.__setattr__(self, "scale", scale)


@dataclass(frozen=True)
class FaultPlan:
    """A fully-materialized fault schedule (a tuple of `FaultRule`s).

    Build explicitly, from a seed (`FaultPlan.random` — same seed, same
    schedule, forever), or from a CLI/launcher spec (`FaultPlan.parse`).
    """

    rules: tuple = ()
    meta: dict = field(default_factory=dict, compare=False)

    def __post_init__(self):
        object.__setattr__(self, "rules", tuple(self.rules))
        for r in self.rules:
            if not isinstance(r, FaultRule):
                raise TypeError(f"rules must be FaultRule, got {type(r)}")

    @classmethod
    def random(cls, seed: int, num_blocks: int, sites=None,
               rate: float = 0.1, times: int = 1,
               device_loss: tuple = (), kind: str = "raise") -> "FaultPlan":
        """Draw a schedule once from ``seed``: each (site, block) faults
        with probability ``rate`` on its first ``times`` calls.

        Pre-drawing (instead of consulting an RNG at fire time) is what
        makes chaos runs reproducible under free thread interleaving.
        ``device_loss`` ordinals become ``mesh.device`` rules.

        ``kind="corrupt"`` draws the SAME (site, block) hit pattern as a
        raise plan at the same seed (the hit draws share one stream;
        perturbation scales come from a second seeded stream), so a storm
        can be re-run as silent corruption without reshuffling which
        blocks are targeted.
        """
        sites = tuple(_check_site(s) for s in (sites or RANDOM_SITES))
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {rate}")
        if kind not in KINDS:
            raise ValueError(
                f"unknown fault kind {kind!r}; expected one of {KINDS}")
        rng = random.Random(seed)
        scale_rng = random.Random(seed ^ 0x5CA1E)
        rules = []
        for site in sites:
            for idx in range(num_blocks):
                if rng.random() < rate:
                    calls = tuple(range(1, times + 1))
                    if kind == "corrupt":
                        rules.append(FaultRule(
                            site, idx, calls, kind="corrupt",
                            scale=scale_rng.uniform(0.25, 4.0)))
                    else:
                        rules.append(FaultRule(site, idx, calls))
        for dev in device_loss:
            rules.append(FaultRule("mesh.device", int(dev)))
        return cls(tuple(rules), meta={
            "seed": seed, "rate": rate, "sites": sites, "times": times,
            "num_blocks": num_blocks, "device_loss": tuple(device_loss),
            "kind": kind})

    @classmethod
    def parse(cls, spec: str, num_blocks: int) -> "FaultPlan":
        """Build a plan from a launcher spec string.

        Two forms:
          * ``"seed=7,rate=0.15,times=1,sites=blockstore.read+stream.decode,
            lose=6+7,kind=corrupt"`` — a seeded random schedule (``sites``
            are ``+``-separated; ``lose`` lists device ordinals to drop;
            ``kind`` defaults to ``raise``);
          * a JSON object (starts with ``{``) or ``@path`` to a JSON file:
            ``{"rules": [{"site": ..., "index": ..., "calls": [1],
            "kind": "corrupt", "scale": 1.5}]}`` and/or the random-plan
            keys ``{"seed", "rate", "sites", "times", "kind"}``.
        """
        spec = spec.strip()
        if spec.startswith("@"):
            spec = open(spec[1:]).read().strip()
        if spec.startswith("{"):
            doc = json.loads(spec)
            rules = tuple(FaultRule(r["site"], r.get("index"),
                                    tuple(r.get("calls", (1,))),
                                    kind=r.get("kind", "raise"),
                                    scale=float(r.get("scale", 1.0)))
                          for r in doc.get("rules", ()))
            if "seed" in doc:
                rnd = cls.random(int(doc["seed"]), num_blocks,
                                 sites=doc.get("sites"),
                                 rate=float(doc.get("rate", 0.1)),
                                 times=int(doc.get("times", 1)),
                                 device_loss=doc.get("device_loss", ()),
                                 kind=doc.get("kind", "raise"))
                rules += rnd.rules
            return cls(rules, meta={"spec": "json"})
        kv = {}
        for part in filter(None, (p.strip() for p in spec.split(","))):
            if "=" not in part:
                raise ValueError(
                    f"bad --faults fragment {part!r}: expected key=value "
                    f"pairs (seed=, rate=, times=, sites=a+b, lose=i+j, "
                    f"kind=raise|corrupt)")
            k, v = part.split("=", 1)
            kv[k.strip()] = v.strip()
        unknown = set(kv) - {"seed", "rate", "times", "sites", "lose", "kind"}
        if unknown:
            raise ValueError(f"unknown --faults keys {sorted(unknown)}")
        return cls.random(
            int(kv.get("seed", 0)), num_blocks,
            sites=tuple(kv["sites"].split("+")) if "sites" in kv else None,
            rate=float(kv.get("rate", 0.1)),
            times=int(kv.get("times", 1)),
            device_loss=tuple(int(d) for d in kv["lose"].split("+"))
            if "lose" in kv else (),
            kind=kv.get("kind", "raise"))

    def to_spec(self) -> str:
        """Serialize to a JSON spec string that `parse` round-trips.

        Explicit rules (not the seed) are emitted, so the exact schedule —
        including per-rule corrupt scales — replays bit-identically via
        ``--faults @file.json`` regardless of `parse`'s ``num_blocks``.
        """
        return json.dumps({"rules": [
            {"site": r.site, "index": r.index, "calls": list(r.calls),
             "kind": r.kind, "scale": r.scale}
            for r in self.rules]})

    def device_loss(self) -> tuple:
        """Mesh device ordinals this plan marks lost."""
        return tuple(r.index for r in self.rules
                     if r.site == "mesh.device" and r.index is not None)


class FaultInjector:
    """Thread-safe executor of a `FaultPlan`.

    Layers call ``fire(site, index)`` at their named site; the injector
    counts the call per ``(site, index)`` and raises `InjectedFault` when
    a rule schedules that call number. ``fired``/``calls`` expose exact
    per-site telemetry for the chaos gate's budget assertions.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._lock = threading.Lock()
        self._calls: dict = {}     # (site, index) -> raise-checkpoint calls
        self._fired: dict = {}     # site -> faults raised
        # corrupt checkpoints count in their own namespace so adding
        # corruption points at a site never shifts raise-rule numbering
        self._corrupt_calls: dict = {}   # (site, index) -> corrupt calls
        self._corrupted: dict = {}       # site -> perturbations applied
        # index rules by site and kind for O(rules-at-site) matching
        self._by_site: dict = {}
        self._corrupt_by_site: dict = {}
        for r in plan.rules:
            if r.kind == "corrupt":
                self._corrupt_by_site.setdefault(r.site, []).append(r)
            else:
                self._by_site.setdefault(r.site, []).append(r)

    def fire(self, site: str, index: int | None = None) -> None:
        """Count one pass of ``index`` through ``site``; raise if scheduled.

        Only ``kind="raise"`` rules match here — corrupt rules are
        consumed by the separate `corrupt_scale` checkpoint.
        """
        _check_site(site)
        with self._lock:
            call_no = self._calls.get((site, index), 0) + 1
            self._calls[(site, index)] = call_no
            hit = any(
                (r.index is None or r.index == index) and call_no in r.calls
                for r in self._by_site.get(site, ()))
            if hit:
                self._fired[site] = self._fired.get(site, 0) + 1
        if hit:
            raise InjectedFault(
                f"injected fault at {site} (block={index}, call={call_no})")

    def corrupt_scale(self, site: str, index: int | None = None):
        """Count one pass of ``index`` through ``site``'s corruption
        checkpoint; return the scheduled perturbation scale (or None).

        Never raises — a hit means the caller must silently perturb the
        payload (see `maybe_corrupt`). Counted separately from `fire`.
        """
        _check_site(site)
        with self._lock:
            call_no = self._corrupt_calls.get((site, index), 0) + 1
            self._corrupt_calls[(site, index)] = call_no
            for r in self._corrupt_by_site.get(site, ()):
                if ((r.index is None or r.index == index)
                        and call_no in r.calls):
                    self._corrupted[site] = self._corrupted.get(site, 0) + 1
                    return r.scale
        return None

    def fire_group(self, site: str, indices) -> None:
        """Fire for every member of a coalesced batch: any scheduled member
        fails the whole group (counted per member, so the schedule stays
        deterministic however blocks happen to be grouped)."""
        for i in indices:
            self.fire(site, i)

    def apply_device_loss(self, mesh) -> tuple:
        """Mark this plan's ``mesh.device`` ordinals lost in `meshstate`:
        ordinal o is the o-th global rank of ``mesh.mesh`` in row-major
        order.

        Returns the ranks marked. Call once before (or mid-) job; the
        planner's ``fallback="degrade"`` consults the registry.
        """
        ordinals = self.plan.device_loss()
        if not ordinals:
            return ()
        from repro_torch.core.resilience import meshstate
        ranks = mesh.mesh.reshape(-1).tolist()
        ids = tuple(ranks[o] for o in ordinals if o < len(ranks))
        meshstate.lose_devices(ids)
        return ids

    # ------------------------------------------------------------ telemetry
    @property
    def fired(self) -> dict:
        with self._lock:
            return dict(self._fired)

    @property
    def total_fired(self) -> int:
        with self._lock:
            return sum(self._fired.values())

    @property
    def corrupted(self) -> dict:
        with self._lock:
            return dict(self._corrupted)

    @property
    def total_corrupted(self) -> int:
        with self._lock:
            return sum(self._corrupted.values())

    def summary(self) -> dict:
        with self._lock:
            return {"rules": len(self.plan.rules),
                    "fired_by_site": dict(self._fired),
                    "total_fired": sum(self._fired.values()),
                    "corrupted_by_site": dict(self._corrupted),
                    "total_corrupted": sum(self._corrupted.values())}


def maybe_fire(injector, site: str, index: int | None = None) -> None:
    """``injector.fire`` when an injector is wired, no-op otherwise — the
    one-liner every instrumented layer calls so production paths stay
    branch-cheap and injector-free by default."""
    if injector is not None:
        injector.fire(site, index)


def maybe_corrupt_bytes(injector, site: str, index, data: bytes) -> bytes:
    """Byte-payload corruption checkpoint (block codecs are headerless
    interleaved float32, so the flip reinterprets in place). Counts the
    checkpoint whenever an injector is wired; payloads that are not
    f32-aligned pass through untouched."""
    if injector is None:
        return data
    scale = injector.corrupt_scale(site, index)
    if scale is None or not data or len(data) % 4:
        return data
    arr = np.frombuffer(data, dtype=np.float32).copy()
    perturb_array(arr, scale, corrupt_salt(site, index))
    return arr.tobytes()


def perturb_array(a: np.ndarray, scale: float, salt: int) -> np.ndarray:
    """Deterministically spike one element of ``a`` by ``scale`` times its
    L2 norm (plus 1, so zero arrays still move).

    Pure function of (array content, scale, salt) — a corrupt storm
    replays bit-identically. Norm-relative magnitude keeps the energy
    perturbation at O(scale²) of the signal energy independent of length,
    i.e. provably above any n-scaled Parseval tolerance. Copies when the
    input is read-only (realized device outputs often are).
    """
    if a.size == 0:
        return a
    if not a.flags.writeable:
        a = np.array(a, copy=True)
    flat = a.reshape(-1)
    pos = salt % flat.size
    norm = float(np.sqrt(np.sum(np.square(flat, dtype=np.float64))))
    flat[pos] += np.asarray(scale * (1.0 + norm), dtype=a.dtype)
    return a


def corrupt_salt(site: str, index, k: int = 0) -> int:
    """Deterministic element-position salt for `perturb_array` — a pure
    function of (site, block, plane) so replayed storms hit the same
    element every time."""
    return (zlib.crc32(site.encode())
            + 1000003 * (0 if index is None else int(index)) + k)


def maybe_corrupt(injector, site: str, index, arrays):
    """Corruption checkpoint: when a ``kind="corrupt"`` rule is scheduled
    for ``(site, index)``, silently perturb one element of each array and
    return the (possibly copied) arrays plus a hit flag.

    ``arrays`` is a sequence of ndarrays; returns ``(list, corrupted)``.
    Call AFTER the layer's own integrity checks (CRC verify, journal
    record) so the corruption is invisible to everything but the
    algorithmic invariants in core/resilience/verify.py.
    """
    arrays = list(arrays)
    if injector is None:
        return arrays, False
    scale = injector.corrupt_scale(site, index)
    if scale is None:
        return arrays, False
    for k, a in enumerate(arrays):
        arrays[k] = perturb_array(a, scale, corrupt_salt(site, index, k))
    return arrays, True
