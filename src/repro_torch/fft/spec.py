"""Spec resolution for the plan-and-execute facade (`repro_torch.fft.plan`).

The pipeline is: user kwargs -> `resolve()` -> a frozen, hashable
`FftSpec`. Resolution does all the up-front validation — kind, layout,
impl and precision membership, power-of-two lengths, the placement and the
device — so strategy errors surface as one clear exception at plan time
instead of a failure inside a kernel.

The port runs the local placement of 1-D to 3-D transforms, c2c and r2c:
``shape`` is the tuple of transform-axis lengths over the TRAILING axes of
the operand (scalar ``n`` is 1-D sugar and normalizes to ``shape=(n,)``,
the same cache key). The contiguous (last) axis takes the level-0/1/2
four-step up to MAX_LOCAL_N; every earlier axis caps at MAX_EARLIER_AXIS.
r2c rides the packed-real fast path on the contiguous axis only
(``r2c_axis`` must normalize to -1). The out-of-core placement is bound to
a `BlockStore`, so `repro_torch.fft.plan` builds it directly and
`resolve()` refuses it. The segmented and distributed placements are
recognised and raise `NotImplementedError` naming the ROADMAP item that
ports them.

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
# longest earlier (non-contiguous) axis, the JAX package's MAX_LEAF: one
# column-kernel pass up to the port's MAX_LEAF, a level-1 transform
# between two transposes above it
MAX_EARLIER_AXIS = 1 << 14

_NOT_YET = {
    "segmented": "ROADMAP Queue 1 item 7",
    "distributed": "ROADMAP Queue 1 item 7",
}


@dataclass(frozen=True)
class FftSpec:
    """Fully-resolved transform spec; hashable plan-cache key."""

    kind: str                     # "c2c" | "r2c"
    shape: tuple                  # transform-axis lengths (trailing axes;
    #                               real length for r2c)
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
    four-step (MAX_LOCAL_N); each earlier axis caps at MAX_EARLIER_AXIS."""
    return (shape[-1] <= MAX_LOCAL_N
            and all(d <= MAX_EARLIER_AXIS for d in shape[:-1]))


def resolve_placement(shape) -> str:
    """The `placement="auto"` heuristic without a mesh: local, or an error
    when the shape exceeds one device."""
    shape = (int(shape),) if isinstance(shape, int) else tuple(shape)
    if not _fits_local(shape):
        raise ValueError(
            f"shape={shape} exceeds the single-device maximum (contiguous "
            f"axis <= MAX_LOCAL_N={MAX_LOCAL_N}, earlier axes <= "
            f"MAX_EARLIER_AXIS={MAX_EARLIER_AXIS}); the distributed "
            f"placement is {_NOT_YET['distributed']}")
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
    if len(shape) > 1 and min(shape) < 2:
        raise ValueError(
            f"N-D transform axes must be >= 2, got shape {shape}")
    return shape


def resolve(kind: str, n=None, batch_shape=(), placement: str = "auto",
            layout: str = "zero_copy", impl: str = "matfft",
            precision: str = "f32", device="cuda", shape=None,
            r2c_axis: int = -1, verify: str = "off") -> FftSpec:
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
    if placement == "out_of_core":
        # out-of-core plans bind to live store/directory state, so they
        # are built (and NOT process-cached) by `repro_torch.fft.plan`
        # itself — there is no frozen spec to resolve here
        raise ValueError(
            "placement='out_of_core' is constructed by repro_torch.fft.plan("
            "store=..., work_dir=..., budget_bytes=...) and has no "
            "resolvable FftSpec (the plan is bound to a BlockStore)")
    if placement in _NOT_YET:
        raise NotImplementedError(
            f"placement={placement!r} is not ported yet "
            f"({_NOT_YET[placement]})")
    shape = _normalize_shape(n, shape)
    ndim = len(shape)
    if kind == "r2c":
        if shape[-1] < 2:
            raise ValueError(f"r2c needs n >= 2, got n={shape[-1]}")
        ax = r2c_axis if r2c_axis >= 0 else ndim + r2c_axis
        if ax != ndim - 1:
            raise ValueError(
                f"r2c_axis={r2c_axis} is not the contiguous axis: the "
                f"packed-real fast path reads n reals as n/2 complex via a "
                f"free reshape, which only the LAST transform axis "
                f"(r2c_axis=-1) supports; transpose the operand or use "
                f"kind='c2c'")
    batch_shape = tuple(int(d) for d in batch_shape)
    if any(d < 1 for d in batch_shape):
        raise ValueError(f"batch_shape dims must be >= 1, got {batch_shape}")
    if placement == "auto":
        placement = resolve_placement(shape)
    elif not _fits_local(shape):
        raise ValueError(
            f"placement='local' caps the contiguous axis at "
            f"MAX_LOCAL_N={MAX_LOCAL_N} and earlier axes at "
            f"MAX_EARLIER_AXIS={MAX_EARLIER_AXIS}, got shape={shape}")
    return FftSpec(kind=kind, shape=shape, batch_shape=batch_shape,
                   placement=placement, layout=layout, impl=impl,
                   precision=precision, device=str(resolve_device(device)),
                   verify=verify)
