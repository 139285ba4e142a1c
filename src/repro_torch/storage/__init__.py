# Disk-resident index store (DESIGN.md §6): block segment files per
# SweepPlan (format v5: per-block codec frames, decompressed on cache
# fill), a bounded-byte page cache metered through the block-I/O
# device, a read pipeline, and a streaming engine that runs queries on
# the card with one plan level there at a time.  Numpy and torch only:
# the same bytes on disk as the JAX package's store.
from .blockfile import (DEFAULT_BLOCK_BYTES, DEFAULT_CODEC,  # noqa: F401
                        IndexStore, SEGMENT_NAMES, SegmentReader,
                        load_store, open_store, save_store, segment_bytes,
                        segment_logical_bytes)
from .codecs import CODEC_IDS, F16_EPS_REL  # noqa: F401
from .pagecache import CacheStats, PageCache, PendingBlock  # noqa: F401
from .pipeline import PipelineStats, ReadPipeline  # noqa: F401
from .stream import StreamTimes, StreamingQueryEngine  # noqa: F401
