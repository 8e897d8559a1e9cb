"""Algorithm-based fault tolerance (ABFT) invariants for FFT execution.

CRC/SHA layers catch corruption *at rest*; a bit flip after decode-verify,
inside a launch, or in a realized result produces a bitwise-consistent
wrong answer that no byte check can see. The FFT is uniquely cheap to
defend against this: two O(n) mathematical invariants gate an O(n log n)
transform (DESIGN.md §13):

  * **Parseval** — the unnormalized forward DFT scales energy by exactly
    n: ``sum_k |X[k]|^2 == n * sum_j |x[j]|^2``. Checked in float64 with
    a tolerance derived from the dtype eps and the transform's rounding
    depth (O(log2 n) butterfly stages).
  * **Linearity checksum row** — the DFT is linear, so appending one row
    equal to a seeded random combination of a batch's rows means its
    transform must equal the same combination of the rows' transforms.
    One extra row rides an existing batched launch (the serve/stream
    zero-padded full-plan trick keeps <= 2 plans per key) and localizes
    corruption anywhere in the batch, including rows whose own energy
    check would pass (e.g. an injected permutation).

A failed check raises `SilentCorruption` — an ``IOError`` subclass, so
every existing `RetryPolicy` classifies it retryable and the quarantined
unit re-enters the ONE retry path (recompute); a ``verify_failed`` event
records site/block/detail for the gates in benchmarks/bench_verify.py.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.resilience.events import record_event

VERIFY_MODES = ("off", "parseval", "abft")

# tolerance safety constant: worst-case relative error of a length-n f32
# FFT grows like O(eps * log2 n) through the butterfly stages; 64x covers
# accumulation across batched rows and the float64 energy reduction
# without ever admitting a norm-relative perturbation (which changes
# energy by O(scale^2), many orders above any eps-scaled bound).
TOLERANCE_SAFETY = 64.0

_EPS = {
    "f32": float(np.finfo(np.float32).eps),
    "f64": float(np.finfo(np.float64).eps),
    "bf16": 2.0 ** -8,
}


class SilentCorruption(IOError):
    """An algorithmic invariant failed on otherwise byte-consistent data.

    ``IOError`` subclass by design: every `RetryPolicy` in the tree
    classifies it retryable, so detection quarantines the unit and the
    existing retry machinery recomputes it.
    """

    def __init__(self, message: str, site: str = "", index=None):
        super().__init__(message)
        self.site = site
        self.index = index


def fail(site: str, index=None, **fields) -> SilentCorruption:
    """Record a ``verify_failed`` event and build the structured error.

    Callers ``raise fail(...)`` so detection telemetry and the exception
    can never disagree.
    """
    record_event("verify_failed", site=site, index=index, **fields)
    detail = ", ".join(f"{k}={v}" for k, v in fields.items())
    return SilentCorruption(
        f"silent corruption detected at {site} (block={index}): {detail}",
        site=site, index=index)


def check_mode(mode: str) -> str:
    if mode not in VERIFY_MODES:
        raise ValueError(
            f"unknown verify mode {mode!r}; expected one of {VERIFY_MODES}")
    return mode


def parseval_rtol(n: int, precision: str = "f32") -> float:
    """Relative tolerance for the energy invariant at transform size n."""
    eps = _EPS.get(precision, _EPS["f32"])
    return TOLERANCE_SAFETY * eps * max(1.0, float(np.log2(max(n, 2))))


def energy(*arrays) -> float:
    """Sum of squares across planar components, accumulated in float64.

    Squares are formed in the operand's own dtype (exact re-computation:
    two energy() calls over the same float32 values produce identical
    squares, so rearrangement checks can use tight tolerances) and only
    the reduction runs in float64 — this avoids materializing a float64
    copy of every operand, which dominated verification wall time.
    """
    total = 0.0
    for a in arrays:
        a = np.asarray(a)
        total += float(np.sum(np.square(a), dtype=np.float64))
    return total


def energy_onesided(re, im, n: int) -> float:
    """Full-spectrum energy from a one-sided r2c result.

    The stored n/2+1 bins imply the conjugate half: DC and Nyquist count
    once, interior bins twice.
    """
    re = np.asarray(re, dtype=np.float64)
    im = np.asarray(im, dtype=np.float64)
    full = np.square(re) + np.square(im)
    e = np.sum(full[..., 1:-1]) * 2.0 + np.sum(full[..., 0]) \
        + np.sum(full[..., -1])
    return float(e)


def check_parseval(e_in: float, e_out: float, n: int,
                   precision: str = "f32", *, site: str, index=None,
                   **fields) -> None:
    """Assert ``e_out == n * e_in`` within the derived tolerance.

    ``e_in`` is input energy, ``e_out`` output (full-spectrum) energy of
    an unnormalized forward transform of length ``n``.
    """
    expect = float(n) * e_in
    tol = parseval_rtol(n, precision) * (abs(expect) + 1e-30)
    err = abs(e_out - expect)
    if err > tol:
        raise fail(site, index, invariant="parseval", n=n,
                   e_in=e_in, e_out=e_out, rel_err=err / (abs(expect) + 1e-30),
                   **fields)


def checksum_weights(rows: int, seed: int = 0) -> np.ndarray:
    """Seeded random combination weights for ``rows`` batch rows.

    Drawn in [0.5, 1.5] so no row is down-weighted to the tolerance
    floor; float32 to match operand dtype. Deterministic (PCG64).
    """
    rng = np.random.default_rng(seed)
    return rng.uniform(0.5, 1.5, size=rows).astype(np.float32)


def add_checksum_row(arrays, weights: np.ndarray):
    """Append ``weights @ a`` as one extra row to each (rows, n) array."""
    out = []
    for a in arrays:
        row = (weights @ a.reshape(len(weights), -1)).reshape(
            (1,) + a.shape[1:]).astype(a.dtype)
        out.append(np.concatenate([a, row], axis=0))
    return out


def abft_rtol(n: int, rows: int, precision: str = "f32") -> float:
    """Relative tolerance for the linearity residual.

    Parseval's per-transform bound, widened by sqrt(rows) for the
    host-side weighted reduction across the batch.
    """
    return parseval_rtol(n, precision) * float(np.sqrt(max(rows, 1) + 1))


def check_checksum(out_arrays, weights: np.ndarray, n: int,
                   precision: str = "f32", *, site: str, index=None,
                   **fields) -> None:
    """Assert each array's last row equals the weighted combination of the
    preceding rows (linearity of the transform), within tolerance."""
    rows = len(weights)
    rtol = abft_rtol(n, rows, precision)
    for a in out_arrays:
        a = np.asarray(a)
        # GEMV in the operand dtype (the checksum row itself was formed by
        # the same-precision combination at gather, so matching precision
        # here adds no detection error); norms accumulate in float64. The
        # float64-everything variant cost a full-batch copy per plane.
        w = weights.astype(a.dtype, copy=False)
        combo = w @ a[:rows].reshape(rows, -1)
        resid = a[rows].reshape(-1) - combo
        ref = float(np.sqrt(np.sum(np.square(combo), dtype=np.float64)))
        err = float(np.sqrt(np.sum(np.square(resid), dtype=np.float64)))
        if err > rtol * (ref + 1e-30):
            raise fail(site, index, invariant="checksum_row", n=n,
                       rows=rows, rel_err=err / (ref + 1e-30), **fields)


# ------------------------------------------------------------- cost model
def verify_flops(mode: str, n: int, rows: int) -> int:
    """Analytic flop count of the verification work itself.

    parseval: square+accumulate over input and output planes (2 planes x
    2 ops x rows x n, both sides). abft replaces the per-member energy
    checks with the checksum row: the input-side combination at gather,
    the output-side combination and residual norms at realize (MAC + norm
    passes over 2 planes each), plus the extra row's own transform —
    which the main cost model already counts because the plan's batch
    really is rows+1.
    """
    check_mode(mode)
    if mode == "off" or rows <= 0:
        return 0
    if mode == "parseval":
        return 8 * rows * n
    return 16 * rows * n


def verify_hbm_bytes(mode: str, n: int, rows: int,
                     bytes_per_el: int = 4) -> int:
    """Extra HBM/host traffic: parseval re-reads input (at decode) and
    output (at realize) planes for the energy reductions; abft re-reads
    input once for the gather-side combination and output once for the
    residual check — two passes either way, abft just spends them on the
    stronger invariant."""
    check_mode(mode)
    if mode == "off" or rows <= 0:
        return 0
    plane = 2 * rows * n * bytes_per_el
    return 2 * plane
