"""The paper's analytical performance models (§I, §IV).

Two models appear in the paper:
  1. Amdahl's Argument: S(N) = 1 / ((1-P) + P/N), with P fit from the
     measured I/O vs compute split (their Figures 4/5 put the serial
     fraction — single-node disk I/O — at 70-75% CPU / 92-95% GPU).
  2. The headline runtime estimate O(n log n / (0.8 * S * C)): work divided
     over S servers x C cores with a 0.8 per-server Hadoop efficiency factor.

Both are implemented exactly as stated so benchmarks/fig6_scaling.py can
overlay model vs measured scaling.
"""

from __future__ import annotations

import math
from dataclasses import dataclass


def amdahl_speedup(parallel_fraction: float, n_workers: int) -> float:
    """S(N) = 1 / ((1-P) + P/N)."""
    if not 0.0 <= parallel_fraction <= 1.0:
        raise ValueError("P must be in [0, 1]")
    if n_workers < 1:
        raise ValueError("N must be >= 1")
    return 1.0 / ((1.0 - parallel_fraction) + parallel_fraction / n_workers)


def fit_parallel_fraction(t_serial: float, t_parallel: float) -> float:
    """P from a single-machine decomposition t = t_serial + t_parallel."""
    total = t_serial + t_parallel
    if total <= 0:
        raise ValueError("total time must be positive")
    return t_parallel / total


def paper_runtime_model(n: int, servers: int, cores: int, *,
                        efficiency: float = 0.8,
                        unit_time_s: float = 1.0) -> float:
    """The paper's O(n log n / (0.8*S*C)) with an explicit time constant.

    ``unit_time_s`` is the per-(n log n)-unit time of one core, calibrated
    from a single-machine run; the paper leaves it implicit in big-O.
    """
    if n < 2:
        return 0.0
    work = n * math.log2(n)
    return unit_time_s * work / (efficiency * servers * cores)


def calibrate_unit_time(n: int, measured_s: float, servers: int = 1,
                        cores: int = 1, efficiency: float = 1.0) -> float:
    """Solve the model for unit_time_s given one measured run."""
    work = n * math.log2(n)
    return measured_s * efficiency * servers * cores / work


@dataclass(frozen=True)
class ClusterModel:
    """Convenience bundle: calibrate once, predict many."""
    unit_time_s: float
    efficiency: float = 0.8

    def predict(self, n: int, servers: int, cores: int) -> float:
        return paper_runtime_model(n, servers, cores,
                                   efficiency=self.efficiency,
                                   unit_time_s=self.unit_time_s)

    def speedup(self, n: int, servers: int, cores: int) -> float:
        return self.predict(n, 1, 1) / self.predict(n, servers, cores)
