"""Segmented (map-only) batched FFT: the paper's own regime.

The paper never computes a transform longer than one block: a 1 TB file
is a batch of independent segments, and each block is transformed in
place by one map task with no communication between tasks
(numReducers=0).

On a process group that is a batch split: every rank of the mesh holds
(rows/D, *shape) rows of the segment batch (`distributed.local_shard`)
and runs the local executors on them. There is no collective call in
this path; the tests hold that by making every collective raise while
a segmented plan runs.
"""

from __future__ import annotations


def build_segmented(kind: str, shape: tuple, *, impl: str = "matfft",
                    layout: str = "zero_copy"):
    """The map task of a (rows/D, *shape) shard: kind="c2c" maps planar
    (xr, xi) -> (yr, yi), kind="r2c" real x -> the planar one-sided
    spectrum, over the trailing ``len(shape)`` axes (`executors`)."""
    from repro_torch.fft import executors as fft_ex

    kw = dict(impl=impl, layout=layout)
    if kind == "c2c":
        def forward(xr, xi):
            return fft_ex.fftn(xr, xi, shape, **kw)
    elif kind == "r2c":
        def forward(x):
            return fft_ex.rfftn(x, shape, **kw)
    else:
        raise ValueError(f"unknown kind {kind!r} for segmented placement")
    return forward
