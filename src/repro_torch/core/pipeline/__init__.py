from repro_torch.core.pipeline.blockstore import (BlockIntegrityError, BlockStore,
                                            StoreStats)
from repro_torch.core.pipeline.maponly import MapOnlyJob, JobConfig, JobStats
from repro_torch.core.pipeline.records import segments_of_block, block_of_segments
from repro_torch.core.pipeline.stream import (MapFnTransform, SegmentFFTTransform,
                                        StagingPool, StreamExecutor,
                                        StreamTransform)

__all__ = ["BlockIntegrityError", "BlockStore", "MapOnlyJob", "JobConfig",
           "JobStats", "segments_of_block", "block_of_segments", "StoreStats",
           "StreamExecutor", "StreamTransform", "SegmentFFTTransform",
           "MapFnTransform", "StagingPool"]
