"""The copy path's rate: the bytes of the host-to-device copies in the
trace over their durations on the device."""


def read(run):
    h2d = [e for e in run.get("events") or ()
           if e.get("cat") == "gpu_memcpy" and "HtoD" in e["name"]]
    nbytes = sum(float(e.get("args", {}).get("bytes", 0)) for e in h2d)
    us = sum(float(e["dur"]) for e in h2d)
    if not nbytes or not us:
        return None
    return nbytes / (us * 1e-6) / 1e9
