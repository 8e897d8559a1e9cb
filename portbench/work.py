"""The work a transform's shape requires, and the least time an H100 needs
for it: the yardstick of every roofline share the benchmark reports.

The counts read only the shape, whatever implements the transform: each
input byte read once, each output byte written once, and benchFFT's flop
convention, 5 N log2 N for a complex transform of N points and 2.5 N log2 N
for a real one (N the points of one transform, all axes together). No
twiddle table, scratch buffer or pass of the program is counted, so a
change to the program never moves the bound.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM data sheet, dense rates at the full 700 W power limit
HBM_BYTES_S = 3.35e12   # device memory bandwidth
F32_FLOPS_S = 67e12     # float32 outside the tensor cores

POINT_BYTES = {"c2c": 8, "r2c": 4}   # planar float32: re and im, or real


def transform_points(config: dict) -> int:
    """Points of one transform: the product of the transform axes."""
    return math.prod(config["shape"])


def batch(config: dict) -> int:
    return math.prod(config["batch_shape"])


def output_shape(kind: str, config: dict) -> tuple:
    """The transform's output: c2c keeps the shape, r2c keeps the one-sided
    half of the last axis."""
    shape = list(config["shape"])
    if kind == "r2c":
        shape[-1] = shape[-1] // 2 + 1
    return (*config["batch_shape"], *shape)


def in_bytes(kind: str, config: dict) -> int:
    """Bytes of the signal one call transforms."""
    return batch(config) * transform_points(config) * POINT_BYTES[kind]


def out_bytes(kind: str, config: dict) -> int:
    """Bytes of the planar float32 spectrum one call writes."""
    return math.prod(output_shape(kind, config)) * 8


def flops(kind: str, config: dict) -> float:
    n = transform_points(config)
    per = 5.0 if kind == "c2c" else 2.5
    return batch(config) * per * n * math.log2(n)


def bound_s(kind: str, config: dict, chips: int = 1) -> float:
    """Least seconds one chip needs for its share of one call: the larger
    of its bytes over the bandwidth and its flops over the float32 peak."""
    nbytes = (in_bytes(kind, config) + out_bytes(kind, config)) / chips
    return max(nbytes / HBM_BYTES_S, flops(kind, config) / chips / F32_FLOPS_S)
