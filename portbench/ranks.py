"""Child processes for the ranks of a cell on more than one chip, for
run.py and control.py alike. Imports neither torch nor the program, so that
rank 0 starts the others before its own imports and the ranks' set-up
overlaps."""

from __future__ import annotations

import socket
import subprocess
import sys
from pathlib import Path


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(argv: list, world: int, port: int, logs: Path) -> list:
    """Ranks 1 .. world-1 as child processes running ``argv`` with
    ``--rank r --port <port>``, each writing to logs/rank<r>.log."""
    logs.mkdir(parents=True, exist_ok=True)
    children = []
    for r in range(1, world):
        log = open(logs / f"rank{r}.log", "w")
        children.append((subprocess.Popen(
            [*argv, "--rank", str(r), "--port", str(port)], stdout=log,
            stderr=subprocess.STDOUT), log))
    return children


def reap(children: list, logs: Path, timeout: float = 60) -> list:
    """Wait for every child rank, killing one that outlives ``timeout``;
    print the end of the log of each that failed, and return their ranks."""
    for proc, log in children:
        try:
            proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        log.close()
    bad = [r for r, (p, _) in enumerate(children, 1) if p.returncode]
    for r in bad:
        tail = (logs / f"rank{r}.log").read_text()[-2000:]
        print(f"rank {r} exited non-zero:\n{tail}", file=sys.stderr)
    return bad


def run_world(argv: list, rank: int, port: int, world: int, logs: Path,
              body) -> tuple:
    """``body(port) -> (rc, value)`` on this rank. Rank 0 of a world of
    more than one first starts ranks 1 .. world-1 running ``argv`` (`spawn`)
    and afterwards waits for them (`reap`); a rank that failed makes the
    exit code 4."""
    if world == 1 or rank:
        return body(port)
    port = free_port()
    children = spawn(argv, world, port, logs)
    rc, value = 1, None
    try:
        rc, value = body(port)
    finally:
        # a rank 0 that failed leaves the others waiting at a collective
        bad = reap(children, logs, timeout=60 if rc == 0 else 5)
    return (rc or (4 if bad else 0)), value
