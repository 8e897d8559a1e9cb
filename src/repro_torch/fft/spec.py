"""Spec resolution for the plan-and-execute facade (`repro_torch.fft.plan`).

The pipeline is: user kwargs -> `resolve()` -> a frozen, hashable
`FftSpec`. Resolution does all the up-front validation — kind, layout,
impl and precision membership, power-of-two lengths, the placement and the
device — so strategy errors surface as one clear exception at plan time
instead of a failure inside a kernel.

This slice of the port runs the local placement of 1-D c2c transforms: the
contiguous axis takes the level-0/1/2 four-step up to MAX_LOCAL_N. Other
kinds, shapes and placements are recognised and raise
`NotImplementedError` naming the ROADMAP item that ports them.

The device replaces the JAX package's ``interpret`` switch: it defaults to
``"cuda"``, which must be present, and ``"cpu"`` runs the kernels' plain
PyTorch versions.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.core.resilience.verify import VERIFY_MODES
from repro_torch.kernels.fft import plan as kplan

KINDS = ("c2c", "r2c")
PLACEMENTS = ("auto", "local", "segmented", "distributed", "out_of_core")
LAYOUTS = ("zero_copy", "copy")
IMPLS = ("matfft", "stockham", "ref")
PRECISIONS = ("f32",)  # reserved: bf16/f64 variants are future work

# largest single-device transform, the JAX package's (its MAX_LEAF**2 with
# a 16384-point leaf); the port's smaller leaf reaches it in three levels
MAX_LOCAL_N = 1 << 28

_NOT_YET = {
    "segmented": "ROADMAP Queue 1 item 7",
    "distributed": "ROADMAP Queue 1 item 7",
    "out_of_core": "ROADMAP Queue 1 item 8",
}


@dataclass(frozen=True)
class FftSpec:
    """Fully-resolved transform spec; hashable plan-cache key."""

    kind: str                     # "c2c"
    shape: tuple                  # transform-axis lengths (trailing axes)
    batch_shape: tuple            # leading batch dims
    placement: str                # resolved: "local"
    layout: str                   # "zero_copy" | "copy"
    impl: str                     # "matfft" | "stockham" | "ref"
    precision: str                # "f32"
    device: str                   # resolved torch device, e.g. "cuda:0"
    verify: str = "off"           # ABFT mode: "off"|"parseval"|"abft"

    @property
    def rows(self) -> int:
        return math.prod(self.batch_shape)

    @property
    def ndim(self) -> int:
        """Number of transform axes."""
        return len(self.shape)

    @property
    def n(self) -> int:
        """Total transform points (== the length for 1-D specs)."""
        return math.prod(self.shape)

    @property
    def operand_shape(self) -> tuple:
        return (*self.batch_shape, *self.shape)


def resolve_device(device) -> torch.device:
    """Normalize ``device``; a CUDA device must exist (no CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={device!r} but no CUDA device is available; pass "
                f"device='cpu' to run the plain PyTorch versions")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or "
                         f"'cpu'")
    return dev


def _fits_local(shape: tuple) -> bool:
    """Can one device run this shape? The contiguous axis gets the nested
    four-step (MAX_LOCAL_N); each earlier axis is a single column-kernel
    pass (MAX_LEAF)."""
    return (shape[-1] <= MAX_LOCAL_N
            and all(d <= kplan.MAX_LEAF for d in shape[:-1]))


def resolve_placement(shape) -> str:
    """The `placement="auto"` heuristic without a mesh: local, or an error
    when the shape exceeds one device."""
    shape = (int(shape),) if isinstance(shape, int) else tuple(shape)
    if not _fits_local(shape):
        raise ValueError(
            f"shape={shape} exceeds the single-device maximum (contiguous "
            f"axis <= MAX_LOCAL_N={MAX_LOCAL_N}, earlier axes <= "
            f"MAX_LEAF={kplan.MAX_LEAF}); the distributed placement is "
            f"{_NOT_YET['distributed']}")
    return "local"


def _normalize_shape(n, shape) -> tuple:
    if (n is None) == (shape is None):
        raise ValueError(
            "pass exactly one of n= (1-D sugar) or shape= (N-D tuple)")
    if shape is None:
        shape = (int(n),)
    elif isinstance(shape, int):
        shape = (int(shape),)
    else:
        shape = tuple(int(d) for d in shape)
    if not shape or len(shape) > 3:
        raise ValueError(
            f"shape must have 1-3 transform axes, got {shape}")
    for ax_i, d in enumerate(shape):
        if not kplan.is_pow2(d):
            raise ValueError(
                f"every transform axis must be a power of two; axis "
                f"{ax_i} of shape {shape} is {d}")
    return shape


def resolve(kind: str, n=None, batch_shape=(), placement: str = "auto",
            layout: str = "zero_copy", impl: str = "matfft",
            precision: str = "f32", device="cuda", shape=None,
            verify: str = "off") -> FftSpec:
    """Validate + normalize everything into a frozen FftSpec."""
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}; expected one of {KINDS}")
    if verify not in VERIFY_MODES:
        raise ValueError(
            f"unknown verify mode {verify!r}; expected one of {VERIFY_MODES}")
    if placement not in PLACEMENTS:
        raise ValueError(
            f"unknown placement {placement!r}; expected one of {PLACEMENTS}")
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}; expected one of {LAYOUTS}")
    if impl not in IMPLS:
        raise ValueError(f"unknown fft impl {impl!r}; expected one of {IMPLS}")
    if precision not in PRECISIONS:
        raise ValueError(
            f"unsupported precision {precision!r}; supported: {PRECISIONS}")
    if placement in _NOT_YET:
        raise NotImplementedError(
            f"placement={placement!r} is not ported yet "
            f"({_NOT_YET[placement]})")
    if kind == "r2c":
        raise NotImplementedError(
            "kind='r2c' runs kernel K3, not ported yet "
            "(ROADMAP Queue 1 item 5)")
    shape = _normalize_shape(n, shape)
    if len(shape) > 1:
        raise NotImplementedError(
            "N-D transforms are not ported yet (ROADMAP Queue 1 item 6)")
    batch_shape = tuple(int(d) for d in batch_shape)
    if any(d < 1 for d in batch_shape):
        raise ValueError(f"batch_shape dims must be >= 1, got {batch_shape}")
    if placement == "auto":
        placement = resolve_placement(shape)
    elif not _fits_local(shape):
        raise ValueError(
            f"placement='local' caps the contiguous axis at "
            f"MAX_LOCAL_N={MAX_LOCAL_N}, got shape={shape}")
    return FftSpec(kind=kind, shape=shape, batch_shape=batch_shape,
                   placement=placement, layout=layout, impl=impl,
                   precision=precision, device=str(resolve_device(device)),
                   verify=verify)
