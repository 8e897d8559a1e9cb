"""Seconds from the harness's first statement to the first timed call:
imports, the kernels' build or load, inputs, plan and warm-up."""


def read(run):
    return run.get("setup_s")
