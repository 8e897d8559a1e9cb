"""Deterministic storage models for benchmarks and tests.

CI scratch space is effectively tmpfs, where a block "read" is a
page-cache memcpy — there is no latency for a pipeline to hide. The
paper's regime is the opposite: spinning-disk HDFS at ~100-250 MB/s per
spindle against a fast device. `ThrottledStore` restores that regime
deterministically: every block read/write sleeps bytes / disk_mb_s,
identically for every execution mode, so overlap gates measure exactly
what they claim (the stream executor hides I/O latency behind compute;
a serial loop cannot). The sleep releases the GIL, so it is hideable by
overlap — exactly like real disk waits — and deterministic across runs
and runners.

Shared here (instead of copy-pasted per benchmark) so bench_pipeline,
bench_outofcore, bench_chaos, and the test suite model the same disk.
"""

from __future__ import annotations

import time

from repro_torch.core.pipeline.blockstore import BlockStore

DISK_MB_S = 250  # modeled per-spindle disk bandwidth (paper-era HDFS)


class ThrottledStore(BlockStore):
    """Benchmark/test store modeling paper-era disk latency: every block
    read/write sleeps nbytes / (disk_mb_s MB/s) on top of the tmpfs
    access. Subclass or assign ``disk_mb_s`` to model other spindles."""

    disk_mb_s: float = DISK_MB_S

    def read_block(self, index: int, verify: bool = True) -> bytes:
        data = super().read_block(index, verify)
        time.sleep(len(data) / (self.disk_mb_s * (1 << 20)))
        return data

    def write_output_block(self, out_dir, index: int, data) -> None:
        time.sleep(len(data) / (self.disk_mb_s * (1 << 20)))
        super().write_output_block(out_dir, index, data)
