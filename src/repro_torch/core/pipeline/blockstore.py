"""BlockStore: the HDFS analogue for the paper's block-granular pipeline.

A *store* is a directory of fixed-size binary blocks plus a JSON manifest.
The design choices mirror the paper directly:

  * fixed ``block_bytes`` (their ``dfs.block.size``; default here is scaled
    down from their 512 MB so tests stay fast, but it is the same knob —
    the paper sets it to the largest buffer the accelerator can take in one
    transfer);
  * one block == one record == one map task (their custom InputFormat);
  * blocks are named by byte offset so a final merge is a simple
    offset-ordered concatenation (their ``hdfs -getmerge``);
  * block writes are atomic (write-tmp, fsync, rename), which makes map
    attempts idempotent — the property Hadoop's speculative execution
    relies on, and ours does too (maponly.py);
  * optional replication: ``replication=r`` keeps r copies of each block;
    reads fall back to a replica when the primary is missing/corrupt
    (checksum mismatch), simulating HDFS datanode failure — and a
    successful deep-verified fallback opportunistically repairs the
    damaged copies (`repair_block`, HDFS's re-replication analogue).

Replica iteration runs under the shared `RetryPolicy`
(core/resilience/retry.py) and every read/write is a named fault-injection
site (core/resilience/faults.py), so chaos runs can prove the fallback +
repair behaviour deterministically (DESIGN.md §10).
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
import threading
import zlib
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from repro_torch.core.resilience.faults import maybe_fire
from repro_torch.core.resilience.retry import RetryPolicy

MANIFEST = "manifest.json"
MERGE_CHUNK = 4 << 20  # getmerge streams block files in bounded chunks


class BlockIntegrityError(IOError):
    """A block-granular integrity failure (checksum mismatch, missing or
    unreadable block), carrying WHICH block: ``index`` (store block index,
    when known) and ``block`` (the offending file name). Subclasses
    ``IOError`` so every retry policy and replica loop still classifies it
    as retryable I/O; raisers chain the underlying error (``from err``,
    the PR-6 convention) so the root cause stays on the traceback."""

    def __init__(self, msg: str, *, index: int | None = None,
                 block: str | None = None):
        super().__init__(msg)
        self.index = index
        self.block = block


def _sha(data) -> str:
    return hashlib.sha256(data).hexdigest()[:16]


def _crc(data) -> str:
    # the cheap per-read block check (HDFS's own choice); SHA-256 stays in
    # the manifest as the replica-repair ground truth. DESIGN.md §7 has
    # the honest micro-benchmark: the split is architectural — raw crc32
    # speed depends on the zlib build (SIMD crc vs SHA-NI sha256)
    return f"{zlib.crc32(data) & 0xffffffff:08x}"


def _atomic_write(path: Path, data) -> None:
    tmp_fd, tmp_name = tempfile.mkstemp(dir=path.parent, prefix=".tmp_")
    try:
        with os.fdopen(tmp_fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp_name, path)  # atomic; last writer wins, all identical
    except BaseException:
        if os.path.exists(tmp_name):
            os.unlink(tmp_name)
        raise


class StoreStats:
    """Thread-safe read-path counters (reader threads hit these
    concurrently): replica fallbacks served and replica copies repaired."""

    def __init__(self):
        self._lock = threading.Lock()
        self.fallback_reads = 0
        self.repairs = 0

    def bump(self, name: str, k: int = 1) -> None:
        with self._lock:
            setattr(self, name, getattr(self, name) + k)

    def as_dict(self) -> dict:
        with self._lock:
            return {"fallback_reads": self.fallback_reads,
                    "repairs": self.repairs}


@dataclass
class BlockInfo:
    index: int
    offset: int
    nbytes: int
    checksum: str  # SHA-256 (truncated): replica-repair ground truth
    crc32: str = ""  # cheap hot-path read check ("" on legacy manifests)

    def name(self, replica: int = 0) -> str:
        suffix = "" if replica == 0 else f".rep{replica}"
        return f"block_{self.offset:016d}.bin{suffix}"


@dataclass
class BlockStore:
    root: Path
    block_bytes: int = 1 << 20
    replication: int = 1
    blocks: list[BlockInfo] = field(default_factory=list)
    total_bytes: int = 0
    # resilience wiring (never serialized into the manifest): a
    # FaultInjector for chaos runs, an override RetryPolicy for the
    # replica loop, and the fallback/repair counters
    injector: object = field(default=None, repr=False, compare=False)
    retry: RetryPolicy | None = field(default=None, repr=False, compare=False)
    stats: StoreStats = field(default_factory=StoreStats, repr=False,
                              compare=False)

    def __post_init__(self):
        self.root = Path(self.root)
        self.root.mkdir(parents=True, exist_ok=True)

    # ---------------- ingest ----------------
    def _append_block(self, offset: int, chunk) -> None:
        info = BlockInfo(index=len(self.blocks), offset=offset,
                         nbytes=len(chunk), checksum=_sha(chunk),
                         crc32=_crc(chunk))
        for r in range(self.replication):
            _atomic_write(self.root / info.name(r), chunk)
        self.blocks.append(info)

    def put_bytes(self, data) -> None:
        """Split ``data`` into blocks (the HDFS copy-in step).

        Accepts any buffer (bytes, bytearray, numpy view); slicing goes
        through a ``memoryview`` so no chunk copy is ever materialized —
        the seed doubled peak ingest memory by slicing ``bytes`` directly.
        """
        self.blocks = []
        mv = memoryview(data).cast("B")
        self.total_bytes = mv.nbytes
        for off in range(0, mv.nbytes, self.block_bytes):
            self._append_block(off, mv[off:off + self.block_bytes])
        self._save_manifest()

    def put_file(self, path: os.PathLike) -> None:
        """Streaming ingest: split a file into blocks reading one block at
        a time, so copy-in never holds the whole input in memory. A
        mid-stream read or write failure surfaces as a structured
        `BlockIntegrityError` naming the block being ingested (chained
        ``from`` the underlying OS error)."""
        self.blocks = []
        self.total_bytes = 0
        with open(path, "rb") as f:
            while True:
                index = len(self.blocks)
                try:
                    chunk = f.read(self.block_bytes)
                    if not chunk:
                        break
                    self._append_block(self.total_bytes, chunk)
                except OSError as err:
                    raise BlockIntegrityError(
                        f"put_file: ingest of block {index} (offset "
                        f"{self.total_bytes}) from {path} failed",
                        index=index,
                        block=f"block_{self.total_bytes:016d}.bin",
                    ) from err
                self.total_bytes += len(chunk)
        self._save_manifest()

    def put_array(self, arr: np.ndarray) -> None:
        self.put_bytes(np.ascontiguousarray(arr).view(np.uint8).reshape(-1))

    def _save_manifest(self) -> None:
        doc = {
            "block_bytes": self.block_bytes,
            "total_bytes": self.total_bytes,
            "replication": self.replication,
            "blocks": [vars(b) for b in self.blocks],
        }
        _atomic_write(self.root / MANIFEST, json.dumps(doc, indent=1).encode())

    @classmethod
    def open(cls, root: os.PathLike) -> "BlockStore":
        root = Path(root)
        doc = json.loads((root / MANIFEST).read_text())
        store = cls(root=root, block_bytes=doc["block_bytes"],
                    replication=doc.get("replication", 1))
        store.total_bytes = doc["total_bytes"]
        store.blocks = [BlockInfo(**b) for b in doc["blocks"]]
        return store

    # ---------------- reads (with replica fallback) ----------------
    def _verify(self, data, info: BlockInfo, deep: bool) -> bool:
        """Hot path: crc32. ``deep`` (replica fallback / repair) or legacy
        manifests without a crc: full SHA-256 against the ground truth."""
        if deep or not info.crc32:
            return _sha(data) == info.checksum
        return _crc(data) == info.crc32

    def _replica_policy(self) -> RetryPolicy:
        """The replica loop as a retry policy: attempt r = replica r,
        immediate (no backoff — the next replica is a different disk)."""
        return self.retry or RetryPolicy(
            max_attempts=max(self.replication, 1),
            retryable=(IOError, OSError))

    def read_block(self, index: int, verify: bool = True) -> bytes:
        info = self.blocks[index]
        maybe_fire(self.injector, "blockstore.read", index)

        def attempt(r: int) -> tuple[int, bytes]:
            if r == 0:
                maybe_fire(self.injector, "blockstore.replica", index)
            path = self.root / info.name(r)
            data = path.read_bytes()
            # primary read pays only the cheap crc; a fallback replica
            # is about to become the new source of truth, so it must
            # match the cryptographic checksum before being served
            if verify and not self._verify(data, info, deep=r > 0):
                raise BlockIntegrityError(
                    f"checksum mismatch on {path.name}",
                    index=index, block=path.name)
            return r, data

        try:
            r, data = self._replica_policy().call(attempt)
        except (IOError, OSError) as e:  # every replica missing or corrupt
            raise BlockIntegrityError(
                f"block {index}: all replicas failed",
                index=index, block=info.name()) from e
        if r > 0:
            # served from a fallback replica: the primary (and any earlier
            # copy) is broken — repair it now from the verified data, or
            # it stays damaged until the LAST replica rots and the block
            # is gone for good
            self.stats.bump("fallback_reads")
            if verify:
                self.repair_block(index, data)
        return data

    def repair_block(self, index: int, data: bytes | None = None) -> int:
        """Opportunistic replica repair: atomically rewrite every damaged
        or missing copy of block ``index`` from a deep-verified good one.

        ``data`` (when given) must match the manifest's SHA-256 ground
        truth; otherwise the first replica that does is the source.
        Returns the number of copies rewritten (0 = all were healthy).
        Atomic per copy, so concurrent readers only ever see the old or
        the repaired bytes, and repeated repairs are idempotent.
        """
        info = self.blocks[index]
        if data is None:
            for r in range(max(self.replication, 1)):
                try:
                    cand = (self.root / info.name(r)).read_bytes()
                except OSError:
                    continue
                if _sha(cand) == info.checksum:
                    data = cand
                    break
            if data is None:
                raise IOError(
                    f"block {index}: no intact replica to repair from")
        elif _sha(data) != info.checksum:
            raise ValueError(
                f"block {index}: repair source fails the SHA-256 ground "
                f"truth; refusing to propagate corruption")
        repaired = 0
        for r in range(max(self.replication, 1)):
            path = self.root / info.name(r)
            try:
                if _sha(path.read_bytes()) == info.checksum:
                    continue  # this copy is healthy
            except OSError:
                pass  # missing: rewrite below
            _atomic_write(path, data)
            repaired += 1
        if repaired:
            self.stats.bump("repairs", repaired)
        return repaired

    def corrupt_block(self, index: int, replica: int = 0) -> None:
        """Test hook: damage one replica (simulated datanode failure)."""
        path = self.root / self.blocks[index].name(replica)
        path.write_bytes(b"\x00CORRUPT" * 4)

    # ---------------- output side ----------------
    def write_output_block(self, out_dir: os.PathLike, index: int,
                           data: bytes) -> None:
        """Map-task output write: atomic, named by offset (mergeable)."""
        maybe_fire(self.injector, "blockstore.write", index)
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        _atomic_write(out / self.blocks[index].name(), data)

    def getmerge(self, out_dir: os.PathLike, dest: os.PathLike) -> int:
        """The paper's ``hdfs -getmerge``: offset-ordered concat to one file."""
        out = Path(out_dir)
        names = sorted(p.name for p in out.glob("block_*.bin"))
        expect = [b.name() for b in self.blocks]
        if names != expect:
            missing = sorted(set(expect) - set(names))
            first = missing[0] if missing else names[0]
            raise BlockIntegrityError(
                f"getmerge: missing {len(missing)} output blocks "
                f"(first: {first})",
                index=expect.index(first) if first in expect else None,
                block=first)
        total = 0
        with open(dest, "wb") as f:
            for i, name in enumerate(names):  # lexicographic == offset order
                try:
                    with open(out / name, "rb") as src:  # bounded stream
                        while True:
                            chunk = src.read(MERGE_CHUNK)
                            if not chunk:
                                break
                            f.write(chunk)
                            total += len(chunk)
                except OSError as err:
                    # a block that listed but fails mid-stream (vanished,
                    # truncated device, I/O error): name it, chain it
                    raise BlockIntegrityError(
                        f"getmerge: output block {name} (index {i}) "
                        f"failed mid-stream", index=i, block=name) from err
        return total
