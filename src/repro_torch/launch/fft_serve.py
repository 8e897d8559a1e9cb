"""FFT-as-a-service launcher: open-loop load against `FftService`.

  PYTHONPATH=src python -m repro_torch.launch.fft_serve --qps 500 \
      --clients 4 --duration 5 --deadline-ms 50 --impl matfft \
      --faults 'seed=7,rate=0.25,sites=serve.admit+serve.batch+serve.execute'

Drives the dynamic-batching front-end (repro_torch/serve/fft_service.py)
with the shared synthetic workload generator (repro_torch/serve/loadgen.py)
and
emits one JSON report: admitted/rejected/shed/failed counts, latency
percentiles, coalescing, plan-cache `cache_info()`, and fault/retry
stats. ``--faults`` takes the same `FaultPlan.parse` spec grammar as
fft_job (kv string, inline JSON, or @file.json) restricted here to the
serve.* sites by default — replaying a service fault storm is one flag.

``--impl`` keeps the JAX package's choices and default: "ref" runs
torch.fft; "matfft" or "stockham" runs the hand-written kernels.
``--device cuda`` (the default) needs a card; ``--device cpu`` runs the
plain PyTorch versions.
"""

from __future__ import annotations

import argparse
import json
import time

from repro_torch.core.resilience import (FaultInjector, FaultPlan,
                                         RetryPolicy, event_stats, events)
import repro_torch.fft as fft_api
from repro_torch.serve import FftService
from repro_torch.serve import loadgen
from repro_torch.serve.fft_service import SHED_POLICIES


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--qps", type=float, default=None,
                    help="aggregate offered request rate (default: flood — "
                         "clients submit flat-out, open loop)")
    ap.add_argument("--clients", type=int, default=3,
                    help="concurrent open-loop client threads")
    ap.add_argument("--duration", type=float, default=None,
                    help="wall-clock cap in seconds; with --qps it also "
                         "sizes the request count")
    ap.add_argument("--requests", type=int, default=200,
                    help="request count when --qps/--duration don't size it")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request deadline (enforced end-to-end on the "
                         "retry-policy clock; late work is shed pre-launch)")
    ap.add_argument("--faults", default=None,
                    help="deterministic fault schedule to replay "
                         "(FaultPlan.parse spec: 'seed=N,rate=R,"
                         "sites=serve.admit+serve.batch+serve.execute', "
                         "inline JSON, or @file.json)")
    ap.add_argument("--impl", default="ref",
                    choices=["matfft", "stockham", "ref"],
                    help="leaf kernels: matfft/stockham are the hand-written "
                         "CUDA kernels, ref is torch.fft")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda runs the kernels on the card; cpu runs their "
                         "plain PyTorch versions")
    ap.add_argument("--coalesce", type=int, default=4,
                    help="requests per full dynamic batch")
    ap.add_argument("--queue-depth", type=int, default=256,
                    help="admission bound (outstanding requests)")
    ap.add_argument("--max-inflight", type=int, default=4,
                    help="launched-but-unrealized batch window")
    ap.add_argument("--max-attempts", type=int, default=3,
                    help="per-request retry budget")
    ap.add_argument("--per-spec-qps", type=float, default=None,
                    help="token-bucket admission rate per spec key")
    ap.add_argument("--per-spec-inflight", type=int, default=None,
                    help="admitted-incomplete cap per spec key")
    ap.add_argument("--shed-policy", default="oldest_deadline",
                    choices=list(SHED_POLICIES))
    ap.add_argument("--verify", default="off",
                    choices=["off", "parseval", "abft"],
                    help="ABFT silent-corruption defense: "
                         "parseval checks each result's energy, abft adds "
                         "a checksum row per launch; detections quarantine "
                         "and recompute through the retry path "
                         "(corruption_detected / corruption_recomputed in "
                         "the service stats)")
    ap.add_argument("--seed", type=int, default=0,
                    help="workload seed (request mix + operand content)")
    args = ap.parse_args(argv)

    num_requests = args.requests
    if args.qps and args.duration:
        num_requests = max(1, int(args.qps * args.duration))

    injector = None
    if args.faults:
        injector = FaultInjector(
            FaultPlan.parse(args.faults, num_blocks=num_requests))

    service = FftService(
        impl=args.impl, device=args.device, coalesce=args.coalesce,
        queue_depth=args.queue_depth, max_inflight=args.max_inflight,
        per_spec_qps=args.per_spec_qps,
        per_spec_inflight=args.per_spec_inflight,
        shed_policy=args.shed_policy,
        default_deadline_s=(args.deadline_ms / 1e3
                            if args.deadline_ms else None),
        retry=RetryPolicy(max_attempts=args.max_attempts),
        injector=injector, verify=args.verify)

    t0 = time.monotonic()
    records = loadgen.drive(service, num_requests=num_requests,
                            clients=args.clients, seed=args.seed,
                            qps=args.qps, duration_s=args.duration)
    outcomes = [loadgen.classify(rec) for rec in records]
    service.close(drain=True)
    wall = time.monotonic() - t0

    buckets: dict = {}
    for o in outcomes:
        buckets[o] = buckets.get(o, 0) + 1
    stats = service.stats.snapshot()
    report = {
        "requests": len(records),
        "wall_s": round(wall, 3),
        "qps_completed": round(buckets.get("ok", 0) / wall, 1) if wall
        else None,
        "outcomes": dict(sorted(buckets.items())),
        "drained_idle": service.idle(),
        "verify": args.verify,
        "verify_failed_events": len(events("verify_failed")),
        "service": stats,
        "degrade_events": events("service_degrade"),
        "event_log": event_stats(),
        "faults": injector.summary() if injector is not None else None,
        "plan_cache": fft_api.cache_info(),
    }
    print(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    main()
