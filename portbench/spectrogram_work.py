"""The work the power spectrogram of a capture requires, and the least time
an H100 needs for it: the yardstick of ``spectrogram_roofline``.

A configuration that declares a ``hop`` is a spectrogram: ``samples`` real
float32 samples, frames of ``shape`` [frame] points every ``hop`` samples
(``batch_shape`` [frames]), and the power |X|^2 of each frame's frame // 2 + 1
one-sided bins in float32. The counts read only that shape: the capture read
once and the power written once, whatever the program reads again (the
overlapping frames, a windowed copy, a planar spectrum), and benchFFT's
2.5 N log2 N flops a real transform of N points. The window and the power
add a few flops a point and are not counted.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

from portbench import work

SAMPLE_BYTES = 4   # a real float32 sample, and a float32 power bin


def frames(config: dict) -> int:
    return math.prod(config["batch_shape"])


def in_bytes(config: dict) -> int:
    """Bytes of the capture one call analyses."""
    return config["samples"] * SAMPLE_BYTES


def out_bytes(config: dict) -> int:
    """Bytes of the power spectrogram one call writes."""
    (frame,) = config["shape"]
    return frames(config) * (frame // 2 + 1) * SAMPLE_BYTES


def flops(config: dict) -> float:
    (frame,) = config["shape"]
    return frames(config) * 2.5 * frame * math.log2(frame)


def bound_s(config: dict) -> float:
    """Least seconds one chip needs for one call: the larger of its bytes
    over the bandwidth and its flops over the float32 peak."""
    return max((in_bytes(config) + out_bytes(config)) / work.HBM_BYTES_S,
               flops(config) / work.F32_FLOPS_S)


def config_of(capture_bytes, configs: Path) -> dict | None:
    """The spectrogram configuration under ``configs`` (a directory of
    configuration files) whose capture is ``capture_bytes``; None where
    there is none."""
    for path in sorted(Path(configs).glob("*.json")):
        cfg = json.loads(path.read_text())
        if "hop" in cfg and in_bytes(cfg) == capture_bytes:
            return cfg
    return None
