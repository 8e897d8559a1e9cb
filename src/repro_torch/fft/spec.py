"""Spec resolution for the plan-and-execute facade (`repro_torch.fft.plan`).

The pipeline is: user kwargs -> `resolve()` -> a frozen, hashable
`FftSpec`. Resolution does all the up-front validation — kind, layout,
impl and precision membership, power-of-two lengths, the placement and the
device — so strategy errors surface as one clear exception at plan time
instead of a failure inside a kernel.

Transforms have 1 to 3 axes, c2c and r2c: ``shape`` is the tuple of
transform-axis lengths over the TRAILING axes of the operand (scalar ``n``
is 1-D sugar and normalizes to ``shape=(n,)``, the same cache key). The
contiguous (last) axis takes the level-0/1/2 four-step up to MAX_LOCAL_N;
every earlier axis caps at MAX_EARLIER_AXIS. r2c rides the packed-real
fast path on the contiguous axis only (``r2c_axis`` must normalize to -1).
The out-of-core placement is bound to a `BlockStore`, so
`repro_torch.fft.plan` builds it directly and `resolve()` refuses it.

Placement resolution (`placement="auto"`), given the number of ranks D
over the mesh axes:

  no mesh                      -> "local"   (error if the shape can't fit)
  mesh + 1-D batch of >1 rows,
      D | rows                 -> "segmented"   (the paper's map-only regime)
  mesh + single 1-D signal, D > 1,
      n >= D^2                 -> "distributed" (cross-rank four-step)
  mesh + single 2-D image, D > 1,
      D | n0 and D | n1        -> "distributed" (the pencil: shard rows,
                                  ONE exchange)
  mesh + anything that still
      fits one device          -> "local"
  otherwise                    -> ValueError

(3-D pencil volumes are explicit only: `placement="distributed"` with a
mesh whose dims form the rank grid; the heuristic does not see the
mesh's structure, so 3-D shapes that fit one device auto-place "local".)

The spec is the plan-cache key (with the mesh), so fields a placement
ignores are normalized here: ``axes`` only for mesh placements,
``overlap`` only for the distributed one (overlap "auto" is resolved to a
chunk count or "off"), ``natural_order``/``fuse_twiddle`` only for the
1-D distributed one (the pencil has no outer twiddle and is always in
natural order).

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


@dataclass(frozen=True)
class FftSpec:
    """Fully-resolved transform spec; hashable plan-cache key."""

    kind: str                     # "c2c" | "r2c"
    shape: tuple                  # transform-axis lengths (trailing axes;
    #                               real length for r2c)
    batch_shape: tuple            # leading batch dims
    placement: str                # resolved: "local"|"segmented"|
    #                               "distributed"
    layout: str                   # "zero_copy" | "copy"
    impl: str                     # "matfft" | "stockham" | "ref"
    precision: str                # "f32"
    device: str                   # resolved torch device, e.g. "cuda:0"
    verify: str = "off"           # ABFT mode: "off"|"parseval"|"abft"
    axes: tuple | None = None     # mesh axes (segmented / distributed)
    natural_order: bool = True    # 1-D distributed only: exchange #3
    fuse_twiddle: bool = False    # 1-D distributed only: twiddle in leaf
    overlap: object = "off"       # distributed only: "off" | int chunks

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


def resolve_placement(shape, rows: int = 1, batch_ndim: int = 0,
                      num_devices: int | None = None) -> str:
    """The `placement="auto"` heuristic (module docstring).

    Args:
      shape: transform shape tuple (an int is 1-D sugar).
      rows: total batch rows (prod of batch_shape).
      batch_ndim: len(batch_shape).
      num_devices: ranks over the mesh axes, or None without a mesh.
    """
    shape = (int(shape),) if isinstance(shape, int) else tuple(shape)
    fits = _fits_local(shape)
    if num_devices is None:
        if not fits:
            raise ValueError(
                f"shape={shape} exceeds the single-device maximum "
                f"(contiguous axis <= MAX_LOCAL_N={MAX_LOCAL_N}, earlier "
                f"axes <= MAX_EARLIER_AXIS={MAX_EARLIER_AXIS}); pass mesh= "
                f"so the planner can pick placement='distributed'")
        return "local"
    if (rows > 1 and batch_ndim == 1 and fits
            and rows % num_devices == 0):
        # an indivisible batch cannot shard evenly; falls through to local
        return "segmented"
    if rows == 1 and batch_ndim == 0 and num_devices > 1:
        if len(shape) == 1 and shape[0] >= num_devices ** 2:
            return "distributed"
        if (len(shape) == 2 and kplan.is_pow2(num_devices)
                and all(d % num_devices == 0 for d in shape)):
            return "distributed"  # pencil: shard rows, one exchange
    if fits:
        return "local"
    raise ValueError(
        f"cannot auto-place shape={shape}: larger than the single-device "
        f"maximum but not distributable — the cross-rank engine needs a "
        f"scalar batch_shape and a 1-D signal with n >= D^2="
        f"{num_devices ** 2}")


def _validate_distributed(n: int, num_devices: int, axes) -> None:
    """The transpose-based 1-D distributed FFT constraint, surfaced early.

    The four-step split n = n1 * n2 must satisfy D | n1 and D | n2 so each
    exchange moves equal shards — i.e. n >= D^2 for pow2 D.
    """
    p = kplan.log2i(n)
    if not kplan.is_pow2(num_devices):
        raise ValueError(
            f"distributed placement needs a power-of-two device count "
            f"along {axes}, got D={num_devices}")
    pd = kplan.log2i(num_devices)
    if p < 2 * pd:
        raise ValueError(
            f"distributed four-step requires D | n1 and D | n2 for the "
            f"split n = n1*n2, i.e. n >= D^2: got n=2^{p}, D=2^{pd} over "
            f"axes {axes}; use placement='segmented' for batches of "
            f"block-sized transforms")


def _validate_pencil(shape: tuple, num_devices: int, axes,
                     grid=None) -> None:
    """The N-D pencil constraints, surfaced early.

    Each exchange leg k shards axis k on input and splits axis k+1, so
    grid[k] must divide both (for the flattened 2-D grid, both axes must
    be divisible by D). Every earlier axis runs as one axis pass a rank,
    so it caps at MAX_EARLIER_AXIS (the JAX package's MAX_LEAF; the
    port's axes past its own 4096 leaf run `axis_pass`'s transpose
    fallback); the contiguous axis runs the local path (MAX_LOCAL_N).
    """
    if not kplan.is_pow2(num_devices):
        raise ValueError(
            f"distributed placement needs a power-of-two device count "
            f"along {axes}, got D={num_devices}")
    if grid is None:
        grid = (num_devices,) * (len(shape) - 1)
    for ax_i, d in enumerate(shape):
        # the grid factors touching axis i: leg i-1 splits it, leg i
        # shards it; both must divide (2-D: the one flattened factor D)
        for g in {grid[k] for k in (ax_i - 1, ax_i) if 0 <= k < len(grid)}:
            if not kplan.is_pow2(g):
                raise ValueError(
                    f"pencil rank-grid factors must be powers of two, got "
                    f"grid={grid} (axes {axes})")
            if d % g:
                raise ValueError(
                    f"distributed pencil shapes need every sharded axis "
                    f"divisible by D: axis {ax_i} of shape {shape} is {d}, "
                    f"not divisible by D={g} (grid={grid}, axes {axes})")
    for ax_i, d in enumerate(shape[:-1]):
        if d > MAX_EARLIER_AXIS:
            raise ValueError(
                f"pencil axis {ax_i} runs as one axis pass a rank, so it "
                f"caps at MAX_EARLIER_AXIS={MAX_EARLIER_AXIS}; got {d}")
    if shape[-1] > MAX_LOCAL_N:
        raise ValueError(
            f"pencil axis {len(shape) - 1} runs the local path, so it caps "
            f"at MAX_LOCAL_N={MAX_LOCAL_N}; got {shape[-1]}")


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
            r2c_axis: int = -1, verify: str = "off",
            num_devices: int | None = None, axes=None,
            natural_order: bool = True, fuse_twiddle: bool = False,
            overlap="auto", axis_sizes=None) -> FftSpec:
    """Validate + normalize everything into a frozen FftSpec.

    ``num_devices`` is the number of ranks over the mesh ``axes`` (None
    without a mesh); ``axis_sizes``, the ranks along each of ``axes``,
    shapes the 3-D pencil's rank grid (1-D and 2-D placements ignore it)
    and is checked against ``num_devices`` here.
    """
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
    if axis_sizes is not None and math.prod(axis_sizes) != num_devices:
        raise ValueError(f"axis_sizes {tuple(axis_sizes)} do not multiply "
                         f"to num_devices={num_devices}")

    rows = math.prod(batch_shape)
    if placement == "auto":
        placement = resolve_placement(shape, rows, len(batch_shape),
                                      num_devices)
    if placement == "local":
        if not _fits_local(shape):
            raise ValueError(
                f"placement='local' caps the contiguous axis at "
                f"MAX_LOCAL_N={MAX_LOCAL_N} and earlier axes at "
                f"MAX_EARLIER_AXIS={MAX_EARLIER_AXIS}, got shape={shape}")
        axes = None
    elif placement == "segmented":
        if num_devices is None:
            raise ValueError("placement='segmented' requires mesh=")
        if len(batch_shape) != 1:
            raise ValueError(
                f"placement='segmented' shards a 1-D batch of segments; "
                f"reshape to (batch, *shape), got batch_shape={batch_shape}")
        if not _fits_local(shape):
            raise ValueError(
                f"segmented segments run device-locally, so the contiguous "
                f"axis caps at MAX_LOCAL_N={MAX_LOCAL_N} and earlier axes "
                f"at MAX_EARLIER_AXIS={MAX_EARLIER_AXIS}, got shape={shape}")
        if rows % num_devices:
            raise ValueError(
                f"segmented batch of {rows} rows does not shard evenly "
                f"over {num_devices} devices (axes {axes}); pad the batch "
                f"or use placement='local'")
    else:  # distributed
        if num_devices is None:
            raise ValueError("placement='distributed' requires mesh=")
        if batch_shape != ():
            raise ValueError(
                f"placement='distributed' transforms ONE global signal of "
                f"shape {shape}; got batch_shape={batch_shape} — use "
                f"placement='segmented' for batches")
        if ndim == 1:
            if kind != "c2c":
                raise ValueError(
                    "kind='r2c' is not supported for 1-D "
                    "placement='distributed'; run a c2c transform of the "
                    "packed signal or use placement='segmented' for "
                    "batches of real segments")
            _validate_distributed(shape[0], num_devices, axes)
        else:
            # the N-D pencil (2-D: one flattened ring; 3-D: one mesh dim
            # per sharded leading axis, which pencil_grid checks)
            from repro_torch.core.fft.distributed import pencil_grid
            grid = pencil_grid(shape, num_devices, axis_sizes)
            _validate_pencil(shape, num_devices, axes, grid)

    if placement == "distributed":
        # resolve "auto" and validate explicit chunk counts now, so the
        # resolved spec (the cache key) never carries "auto"
        from repro_torch.core.fft import distributed as dist_mod
        if ndim == 1:
            chunks = dist_mod.resolve_overlap(shape[0], num_devices, overlap)
        else:
            # the flop-halved r2c pencil exchanges the HALF width, so its
            # chunks resolve against the half shape
            eff_shape = shape
            if kind == "r2c":
                eff_shape = (dist_mod.pencil_r2c_half(shape, grid, impl)
                             or shape)
            chunks = dist_mod.resolve_overlap_pencil(
                eff_shape, num_devices, overlap, grid=grid)
        overlap = "off" if chunks is None else int(chunks)
    else:
        overlap = "off"
    if placement != "distributed" or ndim > 1:
        # the knobs of the 1-D distributed engine alone key no other plan
        # (the pencil has no outer twiddle and is always natural-order)
        natural_order, fuse_twiddle = True, False
    return FftSpec(kind=kind, shape=shape, batch_shape=batch_shape,
                   placement=placement, layout=layout, impl=impl,
                   precision=precision, device=str(resolve_device(device)),
                   verify=verify,
                   axes=tuple(axes) if axes is not None else None,
                   natural_order=bool(natural_order),
                   fuse_twiddle=bool(fuse_twiddle), overlap=overlap)
