"""`repro_torch.core.resilience` — the cross-cutting resilience layer.

The source paper's entire case for Hadoop over a dedicated supercomputer
is commodity-server fault tolerance: disks corrupt, datanodes die,
stragglers appear, and the job still finishes. The reproduction grew that
behaviour piecemeal (per-block retry and speculation in
`core/pipeline/maponly.py`, replica fallback in `blockstore.py`, the
crash-replayable journal from the stream pipeline); this package makes it
one subsystem that can be *proven* under systematic failure
(DESIGN.md §10):

  * `retry`     — ONE `RetryPolicy` (bounded attempts, exponential backoff
                  with decorrelated jitter, per-op deadline, retryable
                  exception classes, injectable clock/sleep) shared by the
                  map-only job, the stream executor, and the BlockStore
                  replica loop.
  * `faults`    — a deterministic, seeded `FaultPlan`/`FaultInjector` with
                  named injection sites threaded through every failure
                  domain, so chaos runs are exactly reproducible.
  * `events`    — the in-process event log (downgrades, device loss,
                  repairs) that tests and the chaos gate assert on.
  * `verify`    — ABFT invariants (Parseval energy, linearity checksum
                  row) with derived per-precision tolerances; a failed
                  check raises `SilentCorruption` (retryable) and the
                  quarantined unit recomputes through the ONE RetryPolicy.
                  Paired with the silent ``kind="corrupt"`` fault rules
                  in `faults` (post-CRC perturbation the byte-integrity
                  layers provably cannot see).

Exercised end to end by `benchmarks/bench_chaos.py` (BENCH_chaos.json,
gated in test.sh/CI) and `tests/test_chaos.py` (`pytest -m chaos`).
"""

from repro_torch.core.resilience.events import clear_events, events, record_event
from repro_torch.core.resilience.events import set_capacity as set_event_capacity
from repro_torch.core.resilience.events import stats as event_stats
from repro_torch.core.resilience.faults import (KINDS, SITES, FaultInjector,
                                          FaultPlan, FaultRule,
                                          InjectedFault, maybe_corrupt,
                                          maybe_fire, perturb_array)
from repro_torch.core.resilience.retry import RetryPolicy, RetryState
from repro_torch.core.resilience.verify import (VERIFY_MODES, SilentCorruption,
                                          check_checksum, check_parseval)

__all__ = [
    "KINDS",
    "SITES",
    "VERIFY_MODES",
    "FaultInjector",
    "FaultPlan",
    "FaultRule",
    "InjectedFault",
    "RetryPolicy",
    "RetryState",
    "SilentCorruption",
    "check_checksum",
    "check_parseval",
    "clear_events",
    "event_stats",
    "events",
    "maybe_corrupt",
    "maybe_fire",
    "perturb_array",
    "record_event",
    "set_event_capacity",
]
