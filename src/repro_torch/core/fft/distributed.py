"""Cross-device (level 2) transforms on `torch.distributed`: the four-step
FFT of one 1-D signal, and the pencil decomposition of one 2-D/3-D volume
(`build_pencil`, `build_pencil_r2c`, after the four-step's engines).

The paper's §VI future work ("paralleling an FFT across a server cluster")
on a process group: the Hadoop cluster becomes the flattened axes of a
`DeviceMesh`, the block exchange a collective, and each rank's "map task"
runs the level-0/1 kernels of `repro_torch.fft.executors` on its shard.

The program is SPMD: every rank of the mesh calls the same plan with the
same global spec, hands `build_distributed`'s function its own shard and
gets its own output shard back. Rank f of the flattened ``axes`` (the
row-major mesh coordinate over ``axes``, the JAX package's
``lax.axis_index(axes)``) owns points [f*n/D, (f+1)*n/D): `local_shard`
cuts that shard from a global tensor.

Data layout (N = N1 * N2 global points, D ranks, planar re/im):

  input   x[i], i = i1*N2 + i2, rank f owns rows i1 in [f*N1/D, ...) of
          the (N1, N2) matrix
  xchg #1 split i2, concat i1   -> (N1, N2/D)   full columns on the rank
  pass 1  FFT over i1 (length N1, batched N2/D) + the W_N^{i2*o1} twiddle
  xchg #2 split o1, concat i2   -> (N2, N1/D)   full rows on the rank
  pass 2  FFT over i2 (length N2, batched N1/D), stored o2-major
  xchg #3 (natural_order only) split o2, concat o1 -> the contiguous output
          shard, already o2-major: no transpose epilogue

Two exchange engines implement each transpose:

  overlap "off"   one `dist.all_to_all_single` per plane and exchange. It
                  splits along dim 0 only, so exchanges #1 and #2 pack
                  (rows, D, cols) -> (D, rows, cols) before the call, and
                  #3 unpacks after it.
  overlap=k       the exchange is split into k column slabs; each slab's
                  D-1 rounds (round r sends to rank f+r and receives from
                  f-r) go out as one `dist.batch_isend_irecv` list. Slab
                  c+1's list is issued before slab c's FFT, and slab c's
                  handles are waited on before its data is used: a double
                  buffer, so that the transfers can hide behind the local
                  FFTs (`exposed_collective_bytes`).

Both engines give the same bits: the exchange moves data, and every
column is transformed by the same kernel arithmetic whatever the slab
(K2 is batch invariant; pass 2's slabs are read in place through the
kernel's ``col_offset``/``ncols``). Pass 1 fuses the twiddle into K1/K2's
store (the global-twiddle epilogue) when ``fuse_twiddle`` is set, the
impl is "matfft" and N1 is one leaf; otherwise it runs as torch ops from
the same tables (`kernels/fft/matfft.apply_global_twiddle`).

Constraints: N, N1, N2 powers of two with D | N1 and D | N2 (N >= D^2),
validated at plan time by `repro_torch.fft.spec`; overlap chunks divide
N1/D and N2/D.

The pencil (2-D: the leading axis over the flattened ranks, ONE
exchange; 3-D: axis 0 over the first mesh dim and axis 1 over the
second, two exchanges, each over its own sub-ring) reuses `_Exchange`:
a leg's `all_to_all_single` packs the split axis to dim 0 and unpacks
into the assembled axis (`_repencil`); its overlapped slabs read the
assembled volume in place through K2's column slab. Each rank holds its
`pencil_shard` of the input and gets its block of the output, the grid
rotated one axis right; the r2c pencil returns the global one-sided
spectrum on every rank (its untangle pairs bins across ranks).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.distributed as dist

from repro_torch.kernels.fft import matfft as kmatfft
from repro_torch.kernels.fft import plan as fft_plan

# overlap="auto" bounds: below AUTO_MIN_N a round's latency exceeds the
# compute it could hide behind; above RING_MAX_D the D-1 rounds a slab
# become a ladder of tiny pieces
OVERLAP_AUTO_MIN_N = 1 << 26
OVERLAP_RING_MAX_D = 64
OVERLAP_AUTO_CHUNKS = 4


@dataclass(frozen=True)
class DistPlan:
    n: int
    d: int           # number of ranks along the FFT axes
    n1: int          # pass-1 transform length (columns)
    n2: int          # pass-2 transform length (rows)
    natural_order: bool = True  # False skips exchange #3 (TRANSPOSED_OUT)
    chunks: int | None = None   # overlapped slabs; None = all_to_all

    @property
    def n_exchanges(self) -> int:
        """Cross-rank transposes executed: transposed-out skips #3."""
        return 3 if self.natural_order else 2

    @property
    def bytes_per_exchange_per_device(self) -> int:
        """Planar f32 payload each rank moves in ONE exchange."""
        return 2 * 4 * self.n // self.d

    @property
    def per_leg_bytes_per_device(self) -> tuple:
        """Per-exchange-leg payload (uniform legs)."""
        return (self.bytes_per_exchange_per_device,) * self.n_exchanges

    @property
    def per_leg_exposed_bytes_per_device(self) -> tuple:
        """Structurally exposed (fill/drain) payload per leg."""
        return tuple(b // (self.chunks or 1)
                     for b in self.per_leg_bytes_per_device)

    @property
    def collective_bytes_per_device(self) -> int:
        """Planar f32 payload each rank exchanges across the transform."""
        return self.n_exchanges * self.bytes_per_exchange_per_device

    @property
    def exposed_collective_bytes_per_device(self) -> int:
        """Bytes a rank cannot overlap with compute: the pipeline's
        fill/drain slab per exchange (every byte without chunks)."""
        return self.collective_bytes_per_device // (self.chunks or 1)


def plan_distributed(n: int, num_devices: int, *, natural_order: bool = True,
                     chunks: int | None = None) -> DistPlan:
    p = fft_plan.log2i(n)
    pd = fft_plan.log2i(num_devices)
    if p < 2 * pd:
        raise ValueError(
            f"distributed FFT needs n >= D^2 (n=2^{p}, D=2^{pd}); "
            f"use the segmented placement for batches of smaller transforms")
    a = min(max(p // 2, pd), p - pd)  # log2(n1), clamped so D | n1, D | n2
    return DistPlan(n=n, d=num_devices, n1=1 << a, n2=1 << (p - a),
                    natural_order=bool(natural_order), chunks=chunks)


def _resolve_overlap_knob(n_total: int, num_devices: int, slab_widths,
                          overlap, widths_desc: str) -> int | None:
    """The ``overlap`` knob of both exchange engines.

    "off"/None -> None. "auto" -> OVERLAP_AUTO_CHUNKS where the slab
    pipeline can pay for itself (n_total >= OVERLAP_AUTO_MIN_N, ring size
    <= OVERLAP_RING_MAX_D, slabs at least 2 wide), else None. An int is
    validated (it must divide every per-rank slab width, so each round
    moves equal pieces) and honoured even where "auto" would decline.
    """
    if overlap is None or overlap == "off":
        return None
    min_w = min(slab_widths)
    if overlap == "auto":
        if (n_total < OVERLAP_AUTO_MIN_N
                or num_devices > OVERLAP_RING_MAX_D or min_w < 2):
            return None
        return min(OVERLAP_AUTO_CHUNKS, min_w)
    if isinstance(overlap, bool) or not isinstance(overlap, int):
        raise ValueError(
            f"overlap must be 'auto', 'off', or a chunk count (int); "
            f"got {overlap!r}")
    if overlap < 1 or any(w % overlap for w in slab_widths):
        raise ValueError(
            f"overlap={overlap} chunks must divide {widths_desc} so every "
            f"round moves equal slabs")
    return overlap


def resolve_overlap(n: int, num_devices: int, overlap) -> int | None:
    """Resolve the ``overlap`` knob for the 1-D engine: chunks must divide
    both per-rank slab widths n1/D and n2/D."""
    if overlap is None or overlap == "off":
        return None
    plan = plan_distributed(n, num_devices)
    n1l, n2l = plan.n1 // plan.d, plan.n2 // plan.d
    return _resolve_overlap_knob(
        n, num_devices, (n1l, n2l), overlap,
        f"both per-device slab widths n1/D={n1l} and n2/D={n2l} "
        f"(n={n}, D={num_devices})")


# ---------------------------------------------------------------------------
# the mesh: flattened axes, this rank's flat index, its shard


def mesh_axes(mesh, axes=None) -> tuple:
    """The mesh dims to flatten: every dim for None, else ``axes`` (a name
    or a tuple) without names the mesh does not have, in the given order."""
    names = tuple(mesh.mesh_dim_names or ())
    if axes is None:
        axes = names
    elif isinstance(axes, str):
        axes = (axes,)
    axes = tuple(a for a in axes if a in names)
    if not axes:
        raise ValueError(f"none of the requested axes exist in mesh axes "
                         f"{names}")
    return axes


def axis_sizes(mesh, axes) -> tuple:
    names = mesh.mesh_dim_names
    return tuple(mesh.size(names.index(a)) for a in axes)


def flat_ranks(mesh, axes) -> list:
    """Global ranks of this rank's group over ``axes``, at each flat index:
    the row-major coordinate over ``axes`` in the order given, the JAX
    package's ``lax.axis_index(axes)``."""
    names = mesh.mesh_dim_names
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not part of the mesh")
    ranks = mesh.mesh[tuple(slice(None) if a in axes else coord[i]
                            for i, a in enumerate(names))]
    kept = [a for a in names if a in axes]
    return ranks.permute([kept.index(a) for a in axes]).reshape(-1).tolist()


def axis_index(mesh, axes, rank: int) -> int:
    """The flat index of global ``rank`` over ``axes`` (row-major over the
    axes in the order given): ``lax.axis_index(axes)`` on that rank."""
    names = mesh.mesh_dim_names
    coord = (mesh.mesh == rank).nonzero()[0].tolist()
    f = 0
    for a in axes:
        i = names.index(a)
        f = f * mesh.size(i) + coord[i]
    return f


def local_shard(x, mesh, axes=None):
    """This rank's contiguous shard of a global array along dim 0: the
    counterpart of ``NamedSharding(mesh, P(axes))``. Rank f of D (flat
    index over ``axes``, default every mesh dim) gets rows [f*s, (f+1)*s),
    s = len(x) / D."""
    ranks = flat_ranks(mesh, mesh_axes(mesh, axes))
    d, f = len(ranks), ranks.index(dist.get_rank())
    if x.shape[0] % d:
        raise ValueError(f"{x.shape[0]} rows do not shard over {d} ranks")
    s = x.shape[0] // d
    return x[f * s:(f + 1) * s]


class _Exchange:
    """Collectives over the process group of a mesh's flattened ``axes``.

    Chunk f of a send goes to flat index f, chunk f of a receive comes
    from it. `all_to_all_single` addresses group ranks, which follow the
    sorted global ranks; where the flat order differs (axes given against
    the mesh's order) the chunks are permuted around the call.
    """

    def __init__(self, mesh, axes):
        self.ranks = flat_ranks(mesh, axes)
        self.d = len(self.ranks)
        self.me = self.ranks.index(dist.get_rank())
        kept = tuple(a for a in mesh.mesh_dim_names if a in axes)
        self.group = (mesh.get_group(kept[0]) if len(kept) == 1
                      else mesh[kept]._flatten().get_group())
        order = [dist.get_group_rank(self.group, r) for r in self.ranks]
        self.order = self.inverse = None
        if order != list(range(self.d)):
            self.order = torch.tensor(order)
            self.inverse = torch.argsort(self.order)

    def all_to_all(self, send: torch.Tensor) -> torch.Tensor:
        """(D, ...) contiguous chunks out, (D, ...) chunks in."""
        if self.order is not None:
            send = send[self.inverse.to(send.device)]
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=self.group)
        if self.order is not None:
            recv = recv[self.order.to(recv.device)]
        return recv

    def start(self, take, place) -> list:
        """Issue one slab's D-1 rounds as one `batch_isend_irecv` list:
        round r sends ``take(f + r)`` (planar, contiguous) to flat index f
        + r and receives from f - r into ``place(f - r)`` (planar,
        contiguous buffers). Returns the handle for `finish`, which keeps
        every tensor alive until its transfer is done."""
        ops, keep = [], []
        for r in range(1, self.d):
            dest, src = (self.me + r) % self.d, (self.me - r) % self.d
            sends, recvs = take(dest), place(src)
            keep += [*sends, *recvs]
            ops += [dist.P2POp(dist.isend, t, self.ranks[dest], self.group)
                    for t in sends]
            ops += [dist.P2POp(dist.irecv, t, self.ranks[src], self.group)
                    for t in recvs]
        works = dist.batch_isend_irecv(ops) if ops else []
        return [works, keep]

    @staticmethod
    def finish(handle) -> None:
        for w in handle[0]:
            w.wait()
        handle.clear()


def build_distributed(n: int, mesh, axes=("data", "model"), *,
                      impl: str = "matfft", natural_order: bool = True,
                      fuse_twiddle: bool = False, layout: str = "zero_copy",
                      overlap: int | None = None):
    """The four-step over the process group of ``mesh``'s flattened
    ``axes`` for a length-n signal: returns ``forward(xr, xi)``, which
    takes this rank's planar (n/D,) shard and returns its output shard.
    ``overlap`` is the resolved chunk count (`resolve_overlap`) or None.
    """
    # imported here: repro_torch.fft, the package, imports this module
    from repro_torch.fft import executors as fft_ex

    ex = _Exchange(mesh, mesh_axes(mesh, axes))
    d, me = ex.d, ex.me
    plan = plan_distributed(n, d, natural_order=natural_order, chunks=overlap)
    n1, n2 = plan.n1, plan.n2
    n1l, n2l = n1 // d, n2 // d
    fuse = (fuse_twiddle and impl == "matfft" and n <= 1 << 32
            and fft_plan.make_plan(n1).levels == 1)

    def pass1(ar, ai, row0: int):
        """FFT the columns of an assembled (n1, cols) slab whose first
        column is global i2 = ``row0``, times W_n^{i2*o1}: out (cols, n1),
        row j = global i2 row0 + j."""
        if fuse:
            return fft_ex.fft_cols(ar, ai, impl=impl, layout=layout,
                                   global_twiddle=(n, row0))
        br, bi = fft_ex.fft_cols(ar, ai, impl=impl, layout=layout)
        return kmatfft.apply_global_twiddle(br, bi, n, row0)

    def pass2(br, bi, out_major, col_offset=0, ncols=None):
        """FFT each length-n2 column of (n2, n1l); the o2-major ("col")
        store is the layout exchange #3 sends, with no transpose."""
        return fft_ex.fft_cols(br, bi, impl=impl, layout=layout,
                               out_major=out_major, col_offset=col_offset,
                               ncols=ncols)

    def local_monolithic(xr, xi):
        def a2a_cols(a, rows, cols):  # (rows, D*cols) -> (D*rows, cols)
            send = a.reshape(rows, d, cols).permute(1, 0, 2).contiguous()
            return ex.all_to_all(send).reshape(d * rows, cols)

        # xchg #1: (n1l, n2) -> (n1, n2l); pass 1 -> (n2l, n1)
        ar, ai = (a2a_cols(a, n1l, n2l) for a in (xr, xi))
        br, bi = pass1(ar, ai, me * n2l)
        # xchg #2: (n2l, n1) -> (n2, n1l)
        br, bi = (a2a_cols(a, n2l, n1l) for a in (br, bi))
        if not natural_order:
            cr, ci = pass2(br, bi, "row")  # (n1l, n2) = [o1 local, o2]
            return cr.reshape(-1), ci.reshape(-1)
        cr, ci = pass2(br, bi, "col")  # (n2, n1l) = [o2, o1 local]

        # xchg #3: split o2 rows (free), concat o1 columns (the unpack)
        def a2a_rows(a):
            recv = ex.all_to_all(a.reshape(d, n2l, n1l))
            return recv.permute(1, 0, 2).reshape(-1)

        return a2a_rows(cr), a2a_rows(ci)

    def local_overlapped(xr, xi):
        k = overlap
        n2c, n1c = n2l // k, n1l // k
        x2 = (xr.reshape(n1l, n2), xi.reshape(n1l, n2))
        dev = xr.device

        def planes(*shape):
            return tuple(torch.empty(shape, dtype=torch.float32, device=dev)
                         for _ in range(2))

        # xchg #1 slab c: global columns f*n2l + c*n2c of every rank f,
        # assembled as (n1, n2c), source s's rows at s*n1l
        def start1(c):
            buf = planes(n1, n2c)

            def take(dest):
                at = dest * n2l + c * n2c
                return tuple(a[:, at:at + n2c].contiguous() for a in x2)

            def place(s):
                return tuple(b[s * n1l:(s + 1) * n1l] for b in buf)

            for b, t in zip(place(me), take(me)):
                b.copy_(t)
            return buf, ex.start(take, place)

        # xchg #2 slab c: pass-1 rows (n2c, n1) -> the (n2, n1l)
        # accumulator, source s's rows at s*n2l + c*n2c
        acc2 = planes(n2, n1l)

        def start2(c, br, bi):
            def take(dest):
                return tuple(a[:, dest * n1l:(dest + 1) * n1l].contiguous()
                             for a in (br, bi))

            def place(s):
                at = s * n2l + c * n2c
                return tuple(b[at:at + n2c] for b in acc2)

            for b, t in zip(place(me), take(me)):
                b.copy_(t)
            return ex.start(take, place)

        pending2 = []
        arrived = start1(0)
        for c in range(k):
            nxt = start1(c + 1) if c + 1 < k else None
            buf, handle = arrived
            ex.finish(handle)
            br, bi = pass1(*buf, me * n2l + c * n2c)
            pending2.append(start2(c, br, bi))
            arrived = nxt
        for handle in pending2:
            ex.finish(handle)
        if not natural_order:
            cr, ci = pass2(*acc2, "row")
            return cr.reshape(-1), ci.reshape(-1)

        # pass 2 slab j (columns j*n1c of (n2, n1l), read in place) +
        # xchg #3 slab j: rows o2 in [f*n2l, ...) to rank f, received into
        # (n2l, n1c) pieces, placed at columns s*n1l + j*n1c once all are in
        out = planes(n2l, n1)

        def place3(j, s, piece):
            at = s * n1l + j * n1c
            for o, t in zip(out, piece):
                o[:, at:at + n1c] = t

        def start3(j):
            slab = pass2(*acc2, "col", col_offset=j * n1c, ncols=n1c)

            def take(dest):  # contiguous rows: sent as they are
                return tuple(a[dest * n2l:(dest + 1) * n2l] for a in slab)

            recv = {s: planes(n2l, n1c) for s in range(d) if s != me}
            place3(j, me, take(me))
            return recv, ex.start(take, recv.__getitem__)

        pending3 = [start3(j) for j in range(k)]
        for j, (recv, handle) in enumerate(pending3):
            ex.finish(handle)
            for s, piece in recv.items():
                place3(j, s, piece)
        return out[0].reshape(-1), out[1].reshape(-1)

    return local_monolithic if overlap is None else local_overlapped


# ---------------------------------------------------------------------------
# N-D pencils: the leading axes sharded over a rank grid, ndim-1 exchanges


@dataclass(frozen=True)
class PencilPlan:
    """Cross-rank plan for an N-D pencil-decomposed transform.

    The (n0, ..., n_{nd-1}) volume shards its leading nd-1 axes over a
    rank grid (2-D: the flattened mesh, grid=(D,); 3-D: one mesh dim per
    sharded axis, grid=(d0, d1)); each rank FFTs its local rows of the
    contiguous last axis, then ``ndim-1`` re-pencil exchange legs each
    re-shard one transformed axis and un-shard the next axis to transform.
    2-D runs ONE exchange against the 1-D engine's three; 3-D runs two.
    """

    shape: tuple      # (n0, ..., n_{nd-1}) global volume
    d: int            # total ranks along the FFT axes
    grid: tuple = None  # ranks per exchange leg k (shards axis k)
    chunks: int | None = None  # overlapped slabs; None = all_to_all

    def __post_init__(self):
        if self.grid is None:  # 2-D: one flattened ring
            object.__setattr__(self, "grid", (self.d,))

    @property
    def n(self) -> int:
        return math.prod(self.shape)

    @property
    def n_exchanges(self) -> int:
        return len(self.shape) - 1

    @property
    def bytes_per_exchange_per_device(self) -> int:
        """Planar f32 payload each rank moves in ONE exchange leg (every
        leg re-pencils the whole local volume, so legs are equal)."""
        return 2 * 4 * self.n // self.d

    @property
    def per_leg_bytes_per_device(self) -> tuple:
        """Per-leg payload in leg order (axis nd-2 first, axis 0 last)."""
        return (self.bytes_per_exchange_per_device,) * self.n_exchanges

    @property
    def collective_bytes_per_device(self) -> int:
        return self.n_exchanges * self.bytes_per_exchange_per_device

    @property
    def per_leg_exposed_bytes_per_device(self) -> tuple:
        """Structurally exposed (fill/drain) payload per leg."""
        return tuple(b // (self.chunks or 1)
                     for b in self.per_leg_bytes_per_device)

    @property
    def exposed_collective_bytes_per_device(self) -> int:
        """The fill/drain slab an exchange (see `DistPlan`'s twin)."""
        return self.collective_bytes_per_device // (self.chunks or 1)


def pencil_grid(shape, num_devices: int, axis_sizes=None) -> tuple:
    """Rank-grid factors of the pencil legs of an N-D ``shape``.

    2-D pencils flatten every mesh dim into one exchange ring (grid=(D,)).
    3-D volumes shard BOTH leading axes, one mesh dim each: the caller
    supplies the ranks along each mesh dim (in ``axes`` order), so the
    grid matches the mesh's structure.
    """
    nd = len(shape)
    if nd == 2:
        return (int(num_devices),)
    if axis_sizes is None:
        raise ValueError(
            f"{nd}-D pencil volumes shard the {nd - 1} leading axes over a "
            f"rank grid: plan with a mesh (its dims become the grid, e.g. "
            f"a (4, 2) mesh for shape={shape})")
    grid = tuple(int(g) for g in axis_sizes)
    if len(grid) != nd - 1:
        raise ValueError(
            f"{nd}-D pencil needs exactly {nd - 1} mesh axes (one rank-grid "
            f"factor per sharded leading axis of shape={shape}); got "
            f"{len(grid)} axes of sizes {grid}")
    return grid


def pencil_r2c_half(shape, grid, impl: str):
    """The packed half-width pencil shape of a real-input transform, or
    None where the flop-halved path does not apply (a last axis under 4,
    an impl other than "matfft", or a leg that cannot split the half
    width).

    The r2c pencil rides the rfftn packing: the contiguous pass transforms
    n_last/2 packed complex points, every exchange leg moves the half
    width, and ONE N-D untangle on the global result recovers the real
    spectrum.
    """
    shape = tuple(int(d) for d in shape)
    if impl != "matfft" or shape[-1] < 4:
        return None
    half = (*shape[:-1], shape[-1] // 2)
    for k, g in enumerate(int(g) for g in grid):
        if half[k] % g or half[k + 1] % g:
            return None
    return half


def plan_pencil(shape, num_devices: int, *, grid=None,
                chunks: int | None = None) -> PencilPlan:
    shape = tuple(int(d) for d in shape)
    if len(shape) < 2:
        raise ValueError(f"pencil decomposition needs >= 2 axes, "
                         f"got shape={shape}")
    fft_plan.log2i(num_devices)
    if grid is None:
        grid = pencil_grid(shape, num_devices)
    grid = tuple(int(g) for g in grid)
    if math.prod(grid) != num_devices:
        raise ValueError(
            f"pencil rank grid {grid} must multiply to the rank count "
            f"D={num_devices}")
    for g in grid:
        fft_plan.log2i(g)
    for k, g in enumerate(grid):
        # leg k shards axis k on input and splits axis k+1 on exchange
        if shape[k] % g or shape[k + 1] % g:
            raise ValueError(
                f"pencil decomposition needs grid[{k}]={g} to divide both "
                f"axis {k} (the input shard) and axis {k + 1} (the "
                f"exchange split) of shape={shape}")
    return PencilPlan(shape=shape, d=num_devices, grid=grid, chunks=chunks)


def resolve_overlap_pencil(shape, num_devices: int, overlap, *,
                           grid=None) -> int | None:
    """Resolve the ``overlap`` knob for the pencil exchanges: chunks must
    divide every per-leg per-rank slab width shape[k+1]/grid[k] (for 2-D
    the n1/D of the ONE exchange)."""
    shape = tuple(int(d) for d in shape)
    plan = plan_pencil(shape, num_devices, grid=grid)
    widths = tuple(shape[k + 1] // g for k, g in enumerate(plan.grid))
    return _resolve_overlap_knob(
        plan.n, max(plan.grid), widths, overlap,
        f"every per-leg exchange slab width "
        f"{'n1/D=%d' % widths[0] if len(widths) == 1 else widths} "
        f"(shape={shape}, grid={plan.grid})")


def pencil_groups(shape, mesh, axes=None) -> tuple[tuple, tuple]:
    """The mesh dims each exchange leg runs over, and the rank grid.

    2-D: every dim of ``axes`` flattens into ONE ring. 3-D: exactly one
    mesh dim per sharded leading axis; leg k exchanges over its own
    sub-ring (`DeviceMesh.get_group(dim)`) while the other grid axis stays
    put.
    """
    names = mesh_axes(mesh, axes)
    nd = len(shape)
    if nd == 2:
        groups = (names,)
    else:
        if len(names) != nd - 1:
            raise ValueError(
                f"{nd}-D pencil needs exactly {nd - 1} mesh axes (one "
                f"rank-grid axis per sharded leading axis of "
                f"shape={tuple(shape)}); got axes {names}")
        groups = tuple((a,) for a in names)
    grid = tuple(math.prod(axis_sizes(mesh, g)) for g in groups)
    return groups, grid


def pencil_shard(x, mesh, axes=None, *, out: bool = False):
    """This rank's block of a global pencil volume ``x`` (its dims are
    the transform shape).

    ``out=False``: the input layout, the counterpart of ``P(*groups,
    None)``: axis 0 over the flat index of the first group and, for 3-D,
    axis 1 over the second. ``out=True``: the output layout, ``P(None,
    *groups)``, the grid rotated one axis right. A rank outside the mesh
    holds no block (ValueError).
    """
    groups, grid = pencil_groups(x.shape, mesh, axes)
    first = 1 if out else 0
    me = dist.get_rank()
    for k, g in enumerate(groups):
        ranks = flat_ranks(mesh, g)
        size = x.shape[first + k] // grid[k]
        x = x.narrow(first + k, ranks.index(me) * size, size)
    return x


def build_gather(mesh, axes, shape):
    """``gather(yr, yi)``: the global (``shape``) planes from every rank's
    output block (`pencil_shard(..., out=True)` layout), on every rank of
    the mesh; one `all_gather` a plane."""
    groups, grid = pencil_groups(shape, mesh, axes)
    ex = _Exchange(mesh, mesh_axes(mesh, axes))
    coords = []  # each group rank's grid coordinate
    for i in range(ex.d):
        rank = dist.get_global_rank(ex.group, i)
        coords.append(tuple(axis_index(mesh, g, rank) for g in groups))

    def gather(yr, yi):
        out = []
        for y in (yr, yi):
            got = [torch.empty_like(y) for _ in range(ex.d)]
            dist.all_gather(got, y.contiguous(), group=ex.group)
            full = torch.empty(shape, dtype=y.dtype, device=y.device)
            for c, block in zip(coords, got):
                view = full
                for k, f in enumerate(c):
                    size = shape[1 + k] // grid[k]
                    view = view.narrow(1 + k, f * size, size)
                view.copy_(block)
            out.append(full)
        return out[0], out[1]

    return gather


def _repencil(ex, a, shape: tuple, split: int, concat: int):
    """One monolithic exchange over ``ex``'s ring: axis ``split`` of the
    local volume (``shape``) cut into D pieces, piece j to flat index j,
    and the pieces received concatenated along axis ``concat`` in source
    order. `all_to_all_single` splits dim 0 only, so the split axis is
    packed to dim 0 before the call and the concat axis unpacked after.
    Returns the new volume and its shape."""
    d = ex.d
    cut = (*shape[:split], d, shape[split] // d, *shape[split + 1:])
    send = a.reshape(cut).movedim(split, 0).contiguous()
    recv = ex.all_to_all(send)  # (d, *piece): recv[j] from flat index j
    new = list(shape)
    new[split] //= d
    new[concat] *= d
    return recv.movedim(0, concat).reshape(new), tuple(new)


def _pencil_legs(shape, grid, exchanges, *, impl, layout, overlap):
    """The exchange legs shared by the c2c and r2c pencils: a function of
    the local planar volume ``loc0`` (leading axes sharded, the last
    already transformed) that runs legs k = nd-2 .. 0 (local `fftn`'s
    axis order, so the composition is bitwise equal to it): leg k
    re-shards the transformed axis k+1 over grid[k] and assembles axis k,
    whose pass then runs through `axis_pass` with a column-major store.
    Monolithic (`_repencil`) or, with ``overlap`` chunks, the overlapped
    slabs; both give the same bits, since every slab pass reads the
    assembled volume in place through K2's ``col_offset``/``ncols``.
    """
    from repro_torch.fft import executors as fft_ex

    shape = tuple(int(x) for x in shape)
    nd = len(shape)
    loc0 = tuple(shape[i] // grid[i] for i in range(nd - 1)) + (shape[-1],)

    def axis_k_pass(ar, ai, S, k, col_offset=0, ncols=None):
        """Axis k of the local volume S through `axis_pass`'s (B, L, C)
        view, back in volume form (a slab narrows axis k+1)."""
        B, L, C = math.prod(S[:k]), S[k], math.prod(S[k + 1:])
        nc = C - col_offset if ncols is None else ncols
        yr, yi = fft_ex.axis_pass(ar, ai, (B, L, C), out_major="col",
                                  impl=impl, layout=layout,
                                  col_offset=col_offset, ncols=nc)
        rest = math.prod(S[k + 2:])
        out = (*S[:k], L, nc // rest, *S[k + 2:])
        return yr.reshape(out), yi.reshape(out)

    def monolithic_leg(ar, ai, S, k):
        ex = exchanges[k]
        ar, S2 = _repencil(ex, ar, S, k + 1, k)
        ai, _ = _repencil(ex, ai, S, k + 1, k)
        ar, ai = axis_k_pass(ar, ai, S2, k)
        return ar, ai, S2

    def overlapped_leg(ar, ai, S, k):
        ex = exchanges[k]
        dk, me, kc = ex.d, ex.me, overlap
        w = S[k + 1] // dk  # per-destination width on axis k+1
        wc = w // kc
        acc_shape = list(S)
        acc_shape[k] *= dk  # the whole axis k assembles
        acc_shape[k + 1] = w
        acc_shape = tuple(acc_shape)
        piece = list(S)
        piece[k + 1] = wc
        rest = math.prod(acc_shape[k + 2:])
        dev = ar.device

        def planes(shape_):
            return tuple(torch.empty(shape_, dtype=torch.float32, device=dev)
                         for _ in range(2))

        acc, out = planes(acc_shape), planes(acc_shape)

        def region(t, s, c):  # source s's piece of slab c in the volume
            return t.narrow(k, s * S[k], S[k]).narrow(k + 1, c * wc, wc)

        # slab c: the axis-(k+1) columns [dest*w + c*wc, ... + wc) of this
        # leg's input go to ring member ``dest``; pieces arrive in their
        # own contiguous buffers and are copied into the volume once in
        def start(c):
            def take(dest):
                return tuple(a.narrow(k + 1, dest * w + c * wc, wc)
                             .contiguous() for a in (ar, ai))

            recv = {s: planes(tuple(piece)) for s in range(dk) if s != me}
            for b, t in zip(acc, take(me)):
                region(b, me, c).copy_(t)
            return c, recv, ex.start(take, recv.__getitem__)

        def finish(c, recv, handle):
            ex.finish(handle)
            for s, got in recv.items():
                for b, t in zip(acc, got):
                    region(b, s, c).copy_(t)

        # double buffer: slab c+1's rounds go out before slab c's pass
        pending = start(0)
        for c in range(kc):
            nxt = start(c + 1) if c + 1 < kc else None
            finish(*pending)
            cr, ci = axis_k_pass(acc[0], acc[1], acc_shape, k,
                                 col_offset=c * wc * rest, ncols=wc * rest)
            for o, t in zip(out, (cr, ci)):
                o.narrow(k + 1, c * wc, wc).copy_(t)
            pending = nxt
        return out[0], out[1], acc_shape

    leg = monolithic_leg if overlap is None else overlapped_leg

    def legs(ar, ai):
        S = loc0
        for k in range(nd - 2, -1, -1):
            ar, ai, S = leg(ar, ai, S, k)
        return ar, ai

    return legs, loc0


def build_pencil(shape, mesh, axes=("data", "model"), *,
                 impl: str = "matfft", layout: str = "zero_copy",
                 overlap: int | None = None):
    """The N-D pencil transform of an (n0, .., nk) volume over ``mesh``:
    returns ``forward(xr, xi)``, which takes this rank's planar input
    block and returns its output block.

    Data layout (rank grid per `pencil_groups`, planar re/im):

      input   leading axes sharded over the grid (2-D: rows over D; 3-D:
              axis 0 over d0, axis 1 over d1), last axis whole
              (`pencil_shard`)
      pass    the local FFT of each row (contiguous axis, level 0/1/2)
      legs    ndim-1 re-pencil exchanges, axis nd-2 down to axis 0
              (`_pencil_legs`)
      output  the natural-order N-D spectrum, the grid rotated one axis
              right (`pencil_shard(..., out=True)`)

    Both exchange engines give the same bits, and the leg order is local
    `fftn`'s, so the result is bitwise equal to the local plan.
    ``overlap`` is the resolved chunk count (`resolve_overlap_pencil`).
    """
    from repro_torch.fft import executors as fft_ex

    shape = tuple(int(x) for x in shape)
    groups, grid = pencil_groups(shape, mesh, axes)
    plan_pencil(shape, math.prod(grid), grid=grid, chunks=overlap)
    exchanges = [_Exchange(mesh, g) for g in groups]
    legs, _ = _pencil_legs(shape, grid, exchanges, impl=impl, layout=layout,
                           overlap=overlap)

    def forward(xr, xi):
        ar, ai = fft_ex.fft(xr, xi, impl=impl, layout=layout)
        return legs(ar, ai)

    return forward


def build_pencil_r2c(shape, mesh, axes=("data", "model"), *,
                     impl: str = "matfft", layout: str = "zero_copy",
                     overlap: int | None = None):
    """The flop-halved real-input pencil: the rfftn packing, distributed.

    The local contiguous pass reads each real row as n_last/2 packed
    complex points (`executors.rfft_pack_pass`, the kernels of the local
    rfftn), then the exchange legs of `build_pencil` run on the half-width
    volume, halving every leg's bytes and every axis pass. Returns
    ``forward(x)``: this rank's real input block -> its block of the RAW
    packed half spectrum (output layout). The caller applies the ONE N-D
    untangle on the global half spectrum (`build_gather`), as local
    rfftn does, so the composition is bitwise equal to it. Only valid
    where `pencil_r2c_half` is not None; ``overlap`` is resolved against
    the half shape.
    """
    from repro_torch.fft import executors as fft_ex

    shape = tuple(int(x) for x in shape)
    groups, grid = pencil_groups(shape, mesh, axes)
    half = pencil_r2c_half(shape, grid, impl)
    if half is None:
        raise ValueError(
            f"no flop-halved r2c pencil for shape={shape}, grid={grid}, "
            f"impl={impl!r} (see pencil_r2c_half)")
    plan_pencil(half, math.prod(grid), grid=grid, chunks=overlap)
    exchanges = [_Exchange(mesh, g) for g in groups]
    legs, loc0 = _pencil_legs(half, grid, exchanges, impl=impl,
                              layout=layout, overlap=overlap)
    n_last = shape[-1]

    def forward(x):
        rows = math.prod(loc0[:-1])
        zr, zi = fft_ex.rfft_pack_pass(x.reshape(rows, n_last), n_last,
                                       impl=impl, layout=layout)
        return legs(zr.reshape(loc0), zi.reshape(loc0))

    return forward


def build_pencil_reverse(shape, mesh, axes=("data", "model"), *,
                         impl: str = "matfft", layout: str = "zero_copy"):
    """The pencil run backwards, for the inverse through the conjugation
    identity: ``forward(yr, yi)`` takes this rank's block in the OUTPUT
    layout and returns the forward DFT in the INPUT layout. Axis 0 (whole
    there) is transformed first; leg k then exchanges over groups[k]
    (split axis k, concat axis k+1) and axis k+1 is transformed, the last
    axis as rows. Monolithic exchanges only."""
    from repro_torch.fft import executors as fft_ex

    shape = tuple(int(x) for x in shape)
    nd = len(shape)
    groups, grid = pencil_groups(shape, mesh, axes)
    exchanges = [_Exchange(mesh, g) for g in groups]
    out0 = (shape[0], *(shape[k + 1] // grid[k] for k in range(nd - 1)))

    def axis_pass(ar, ai, S, k):
        view = (math.prod(S[:k]), S[k], math.prod(S[k + 1:]))
        yr, yi = fft_ex.axis_pass(ar, ai, view, out_major="col", impl=impl,
                                  layout=layout)
        return yr.reshape(S), yi.reshape(S)

    def forward(yr, yi):
        S = out0
        ar, ai = axis_pass(yr, yi, S, 0)
        for k in range(nd - 1):
            ar, S2 = _repencil(exchanges[k], ar, S, k, k + 1)
            ai, _ = _repencil(exchanges[k], ai, S, k, k + 1)
            S = S2
            if k + 1 == nd - 1:
                ar, ai = fft_ex.fft(ar, ai, impl=impl, layout=layout)
            else:
                ar, ai = axis_pass(ar, ai, S, k + 1)
        return ar, ai

    return forward


def distributed_fft(xr, xi, mesh, axes=("data", "model"), **kw):
    """Forward FFT of one length-n signal sharded over ``mesh``: ``xr``,
    ``xi`` are this rank's (n/D,) shard (`local_shard`), and so is the
    result, in natural order or, with ``natural_order=False``, the
    transposed (o1-major) block order, FFTW's TRANSPOSED_OUT. ``kw`` passes
    through to `repro_torch.fft.plan` (impl, natural_order, fuse_twiddle,
    layout, overlap, device); repeat calls hit the plan cache."""
    import repro_torch.fft as fft_api
    n = xr.shape[-1] * math.prod(axis_sizes(mesh, mesh_axes(mesh, axes)))
    p = fft_api.plan(kind="c2c", n=n, mesh=mesh, placement="distributed",
                     axes=axes, **kw)
    return p.execute(xr, xi)


def distributed_ifft(xr, xi, mesh, axes=("data", "model"), **kw):
    """Inverse FFT, sharded like `distributed_fft`, through the cached
    plan's `execute_inverse` (the conjugation identity; it needs
    ``natural_order=True``)."""
    import repro_torch.fft as fft_api
    n = xr.shape[-1] * math.prod(axis_sizes(mesh, mesh_axes(mesh, axes)))
    p = fft_api.plan(kind="c2c", n=n, mesh=mesh, placement="distributed",
                     axes=axes, **kw)
    return p.execute_inverse(xr, xi)
