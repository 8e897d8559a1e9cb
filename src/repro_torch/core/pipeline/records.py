"""Record layout: one block == one record == a batch of FFT segments.

The paper's custom InputFormat hands a whole HDFS block to a map task as a
single Record; inside the task the block is reinterpreted as a batch of
FFT-size segments ("the partitioning of FFT segments can be done inside
memory using CUFFT's batched FFT plan"). These helpers do exactly that
reinterpretation, for the paper's interleaved complex64 sample layout.
"""

from __future__ import annotations

import numpy as np


def segments_of_block(data: bytes, fft_len: int) -> tuple[np.ndarray, np.ndarray]:
    """bytes -> planar (nseg, fft_len) float32 re/im.

    Layout: interleaved single-precision complex (re0, im0, re1, im1, ...),
    the JCUFFT/CUFFT default the paper uses. The block must contain a whole
    number of segments (the splitter guarantees block_bytes % (8*fft_len)==0).
    """
    flat = np.frombuffer(data, dtype=np.float32)
    seg_floats = 2 * fft_len
    if flat.size % seg_floats:
        raise ValueError(
            f"block of {flat.size} floats is not a whole number of "
            f"{fft_len}-point complex segments")
    inter = flat.reshape(-1, fft_len, 2)
    return np.ascontiguousarray(inter[..., 0]), np.ascontiguousarray(inter[..., 1])


def block_of_segments(re: np.ndarray, im: np.ndarray) -> bytes:
    """planar (nseg, fft_len) -> interleaved complex64 bytes."""
    inter = np.stack([re, im], axis=-1).astype(np.float32)
    return inter.tobytes()


def segment_block_bytes(fft_len: int, segments_per_block: int) -> int:
    """Block size holding exactly ``segments_per_block`` complex64 segments."""
    return 8 * fft_len * segments_per_block
