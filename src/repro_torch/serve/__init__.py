"""`repro_torch.serve` — FFT as a service: `FftService`, the bounded,
deadline-aware dynamic-batching front end over the plan cache, and
`loadgen`, its synthetic open-loop workload and fault-free oracle; and LM
serving: `ServeEngine` and `greedy_generate` (prefill + greedy decode
over `repro_torch.models.transformer.TransformerLM`)."""

from repro_torch.serve.engine import ServeEngine, greedy_generate
from repro_torch.serve.fft_service import (
    DeadlineExceeded,
    FftService,
    FftTicket,
    RequestFailed,
    ServiceClosed,
    ServiceError,
    ServiceOverload,
    ServiceStats,
)

__all__ = [
    "DeadlineExceeded",
    "FftService",
    "FftTicket",
    "RequestFailed",
    "ServeEngine",
    "ServiceClosed",
    "ServiceError",
    "ServiceOverload",
    "ServiceStats",
    "greedy_generate",
]
