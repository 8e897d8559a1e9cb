"""Cross-device (level 2) four-step FFT of one 1-D signal on
`torch.distributed`.

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


def resolve_overlap(n: int, num_devices: int, overlap) -> int | None:
    """Resolve the ``overlap`` knob for the 1-D engine: "off"/None ->
    None; "auto" -> OVERLAP_AUTO_CHUNKS where the slab pipeline can pay
    for itself, else None; an int is validated (it must divide both
    per-rank slab widths n1/D and n2/D) and honoured."""
    if overlap is None or overlap == "off":
        return None
    plan = plan_distributed(n, num_devices)
    n1l, n2l = plan.n1 // plan.d, plan.n2 // plan.d
    min_w = min(n1l, n2l)
    if overlap == "auto":
        if (n < OVERLAP_AUTO_MIN_N
                or num_devices > OVERLAP_RING_MAX_D or min_w < 2):
            return None
        return min(OVERLAP_AUTO_CHUNKS, min_w)
    if isinstance(overlap, bool) or not isinstance(overlap, int):
        raise ValueError(
            f"overlap must be 'auto', 'off', or a chunk count (int); "
            f"got {overlap!r}")
    if overlap < 1 or n1l % overlap or n2l % overlap:
        raise ValueError(
            f"overlap={overlap} chunks must divide both per-device slab "
            f"widths n1/D={n1l} and n2/D={n2l} (n={n}, D={num_devices}) "
            f"so every round moves equal slabs")
    return overlap


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
