"""Synthetic open-loop load generation for `FftService`.

Shared by the service tests, the service phase of chip_smoke.py and the
`python -m repro_torch.launch.fft_serve` CLI so all drive the service the
same way: N client threads submit a deterministic mixed-spec request stream
(request seq -> seeded RNG -> operands, so a fault-free oracle can
recompute any request's expected output bit-for-bit), open-loop — clients
never wait for results before submitting the next request, which is what
makes offered load exceed capacity and actually exercises admission
control instead of self-throttling around it.

Outcome classification is the contract the gate asserts: every submitted
request ends in exactly one bucket — ``ok`` (with a bitwise-checkable
result), a named rejection (``queue_full``/``rate_limit``/
``inflight_cap``/``admit_fault``/``closed``), ``shed``, ``deadline``, or
``failed`` — anything else (timeout waiting on a ticket) is a silent
drop and fails the gate.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

import numpy as np

from repro_torch.serve.fft_service import (DeadlineExceeded, FftService,
                                           RequestFailed, ServiceClosed,
                                           ServiceOverload)


@dataclass(frozen=True)
class RequestShape:
    """One entry of the workload mix: a transform kind/shape/batch rows."""

    kind: str     # "c2c" | "r2c"
    n: int        # 1-D transform length (pow2)
    rows: int     # batch rows per request

    @property
    def label(self) -> str:
        return f"{self.kind}-n{self.n}-r{self.rows}"


# mixed n, c2c + r2c — three spec keys so the batcher has real grouping
# work but enough same-key traffic to coalesce
DEFAULT_MIX = (
    RequestShape("c2c", 256, 2),
    RequestShape("c2c", 512, 4),
    RequestShape("r2c", 512, 2),
)


def request_operands(seed: int, rid: int, shape: RequestShape) -> tuple:
    """Deterministic operands for request ``rid`` — the oracle recomputes
    these independently, so results can be checked bit-for-bit."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, rid]))
    dims = (shape.rows, shape.n)
    if shape.kind == "c2c":
        return (rng.standard_normal(dims, dtype=np.float32),
                rng.standard_normal(dims, dtype=np.float32))
    return (rng.standard_normal(dims, dtype=np.float32),)


def pick_shape(seed: int, rid: int, mix) -> RequestShape:
    rng = np.random.default_rng(np.random.SeedSequence([seed, rid, 7]))
    return mix[int(rng.integers(len(mix)))]


@dataclass
class SubmittedRequest:
    rid: int
    shape: RequestShape
    ticket: object
    t_submit: float


def drive(service: FftService, *, num_requests: int, clients: int = 3,
          seed: int = 0, mix=DEFAULT_MIX, qps: float | None = None,
          deadline_s: float | None = None,
          duration_s: float | None = None) -> list:
    """Open-loop drive: ``clients`` threads split the request ids and
    submit flat-out (or paced to ``qps`` aggregate when given) without
    waiting on results. Returns every `SubmittedRequest` in rid order.

    ``duration_s`` caps wall time: pacing stops issuing new requests once
    exceeded (the request count is the primary knob; the cap guards CI).
    """
    records: list = [None] * num_requests
    interval = (clients / qps) if qps else 0.0
    t_start = time.monotonic()

    def client(cid: int) -> None:
        for rid in range(cid, num_requests, clients):
            if duration_s and time.monotonic() - t_start > duration_s:
                break
            shape = pick_shape(seed, rid, mix)
            ops = request_operands(seed, rid, shape)
            ticket = service.submit(shape.kind, *ops,
                                    deadline_s=deadline_s)
            records[rid] = SubmittedRequest(rid, shape, ticket,
                                            time.monotonic())
            if interval:
                time.sleep(interval)

    threads = [threading.Thread(target=client, args=(cid,), daemon=True)
               for cid in range(max(clients, 1))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return [r for r in records if r is not None]


def classify(rec: SubmittedRequest, timeout: float = 60.0) -> str:
    """Wait for the outcome and name its bucket (see module docstring)."""
    if not rec.ticket.wait(timeout):
        return "silent_drop"   # a pending ticket after drain = a lost request
    err = rec.ticket.error
    if err is None:
        return "ok"
    if isinstance(err, ServiceOverload):
        return "shed" if err.reason == "shed" else err.reason
    if isinstance(err, DeadlineExceeded):
        return "deadline"
    if isinstance(err, ServiceClosed):
        return "closed"
    if isinstance(err, RequestFailed):
        return "admit_fault" if err.stage == "admit" else "failed"
    return f"unclassified:{type(err).__name__}"


def oracle(shape: RequestShape, ops: tuple, impl: str = "ref",
           batch_rows: int | None = None, device="cuda") -> tuple:
    """Fault-free reference: the request executed ALONE, zero-padded to
    ``batch_rows`` (the launch size the service used — see
    `FftTicket.batch_rows`), on ``device``; host numpy planes.

    Row position and co-batched content don't change a row's result.
    The replay at the launch size is the JAX package's (whose CPU
    backend picks summation strategies by total batch size); the port's
    kernels give a row the same bits at any batch size
    (tests/test_torch_service.py holds that), and the replay is kept as
    it is. Shares the service's plan cache by design (same resolved spec
    -> same cached plan)."""
    import repro_torch.fft as fft_api
    total = batch_rows or shape.rows
    padded = []
    for op in ops:
        buf = np.zeros((total, shape.n), np.float32)
        buf[:shape.rows] = op
        padded.append(buf)
    plan = fft_api.plan(kind=shape.kind, n=shape.n,
                        batch_shape=(total,), impl=impl, device=device)
    if shape.kind == "c2c":
        out = plan.execute(*padded)
    else:
        out = plan.execute_real(*padded)
    return tuple(a[:shape.rows].cpu().numpy() for a in out)


def bitwise_equal(got: tuple, want: tuple) -> bool:
    return (len(got) == len(want)
            and all(np.array_equal(np.asarray(g), w)
                    for g, w in zip(got, want)))
