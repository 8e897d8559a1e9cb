"""The port's `stft` and `power_spectrogram` (`repro_torch.core.spectral`)
against the plain reference, `tests/plain_spectrogram.py` (framing, the
periodic Hann window and the one-sided DFT by their definitions, in
float64); on the CPU through the kernels' plain versions. The same
reference with its inputs rounded to TF32 fails the tolerances, and the
spectral spans nest as `repro_torch.spans` says."""

import json
import math

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import plain_spectrogram as plain
from repro_torch.core import spectral

# the suite runs one process per core (xdist): keep torch to one thread
torch.set_num_threads(1)

# Each tolerance is over the root mean square of the reference's bins.
# float32 rounds each sample, window value and butterfly to 6e-8; over a
# frame's log2(frame) passes the port reads 1.1-1.3e-7 rms and under 6e-7 at
# its widest bin. The tolerances leave 50x room above that and lie 25x or
# more below what TF32 inputs (a 10-bit mantissa, 2.6-3.1e-4 rms) give.
SPECTRUM_TOL = {"rel_rms_err": 1e-5, "rel_max_err": 5e-5}
# |X|^2 doubles the spectrum's relative error where a bin is large, and the
# largest bins are several times the mean: the port reads 1.4-1.7e-7 rms and
# up to 2.4e-6 at its widest bin, TF32 inputs 2.6e-4 rms and 1.9e-3 and more.
POWER_TOL = {"rel_rms_err": 1e-5, "rel_max_err": 1e-4}

# (frame, hop, samples): the deployment's frame and hop at 2^16 samples, and
# two shorter frames at half overlap
CASES = [(1024, 512, 1 << 16), (256, 128, 1 << 14), (512, 256, 1 << 14)]
PARAMS = [(*c, w) for c in CASES for w in (True, False)]
IDS = [f"{f}-{h}-{'hann' if w else 'rect'}" for f, h, _, w in PARAMS]
SPANS = "repro_torch.spectral."


def _signal(samples: int, seed: int = 7) -> torch.Tensor:
    return torch.randn(samples, generator=torch.Generator().manual_seed(seed))


def _gap(yr, yi, rr, ri) -> dict:
    """rel_rms_err and rel_max_err of planes ``yr``/``yi`` against the
    reference's ``rr``/``ri`` (``yi``, ``ri`` None for a real output)."""
    d2 = (yr.double() - rr) ** 2
    ms = rr * rr
    if ri is not None:
        d2 = d2 + (yi.double() - ri) ** 2
        ms = ms + ri * ri
    ms = float(ms.mean())
    return {"rel_rms_err": math.sqrt(float(d2.mean()) / ms),
            "rel_max_err": math.sqrt(float(d2.max()) / ms)}


def _within(gap: dict, tol: dict) -> bool:
    return all(gap[k] <= tol[k] for k in tol)


@pytest.mark.parametrize("frame,hop,samples,window", PARAMS, ids=IDS)
def test_port_matches_the_plain_reference(frame, hop, samples, window):
    x = _signal(samples)
    rr, ri = plain.stft(x, frame, hop, window=window)
    assert rr.shape == ((samples - frame) // hop + 1, frame // 2 + 1)
    sr, si = spectral.stft(x, frame, hop, window=window, device="cpu")
    assert sr.shape == rr.shape and sr.dtype == torch.float32
    gap = _gap(sr, si, rr, ri)
    assert _within(gap, SPECTRUM_TOL), gap
    p = spectral.power_spectrogram(x, frame, hop, window=window,
                                   device="cpu")
    gap = _gap(p, None, plain.power_spectrogram(x, frame, hop, window=window),
               None)
    assert _within(gap, POWER_TOL), gap


@pytest.mark.parametrize("frame,hop,samples,window", PARAMS, ids=IDS)
def test_tf32_inputs_fail_the_tolerances(frame, hop, samples, window):
    x = _signal(samples)
    rr, ri = plain.stft(x, frame, hop, window=window)
    tr, ti = plain.stft(x, frame, hop, window=window, precision="tf32")
    gap = _gap(tr, ti, rr, ri)
    assert all(gap[k] > SPECTRUM_TOL[k] for k in SPECTRUM_TOL), gap
    gap = _gap(tr * tr + ti * ti, None, rr * rr + ri * ri, None)
    assert all(gap[k] > POWER_TOL[k] for k in POWER_TOL), gap


def test_plain_reference_is_the_definition():
    x = _signal(4096, seed=11)
    rr, ri = plain.stft(x, 1024, 512)
    frames = torch.stack([x[512 * f: 512 * f + 1024] for f in range(7)])
    k = torch.arange(1024, dtype=torch.float64)
    w = 0.5 - 0.5 * torch.cos(2 * math.pi * k / 1024)
    want = torch.fft.rfft(frames.double() * w, dim=-1)
    torch.testing.assert_close(rr, want.real, rtol=0, atol=1e-10)
    torch.testing.assert_close(ri, want.imag, rtol=0, atol=1e-10)


def _spans(tmp_path, fn) -> list:
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return sorted(((e["name"], float(e["ts"]), float(e["ts"]) + e["dur"])
                   for e in events if e.get("cat") == "user_annotation"),
                  key=lambda s: s[1])


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_spectral_spans_nest(tmp_path):
    x = _signal(1 << 13)
    got = _spans(tmp_path, lambda: spectral.power_spectrogram(
        x, 1024, 512, device="cpu"))
    by = {}
    for s in got:
        by.setdefault(s[0], []).append(s)
    names = ["power_spectrogram", "stft", "window", "power"]
    for name in names:
        assert len(by.get(SPANS + name, [])) == 1, got
    entry, stft, window, power = (by[SPANS + n][0] for n in names)
    (transform,) = by["repro_torch.fft.execute_real"]
    assert _inside(stft, entry) and _inside(power, entry)
    assert _inside(window, stft) and _inside(transform, stft)
    # framing before the transform, the power after the stft
    assert window[2] <= transform[1] and stft[2] <= power[1]
    # `stft` alone records its own entry span and no power
    got = _spans(tmp_path, lambda: spectral.stft(x, 1024, 512, device="cpu"))
    assert [s[0] for s in got if s[0].startswith(SPANS)] == [
        SPANS + "stft", SPANS + "window"]
