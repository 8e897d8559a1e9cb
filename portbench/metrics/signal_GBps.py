"""Signal through the transform: the input bytes of every call completed
in the window (global: the whole signal where it is split over chips),
over the window's seconds on the host's clock."""


def read(run):
    if not run.get("window_s"):
        return None
    return run["calls"] * run["in_bytes"] / run["window_s"] / 1e9
