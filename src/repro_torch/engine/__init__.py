"""repro_torch.engine — sketch serving over append-only and mutable stores.

| piece | file | role |
|---|---|---|
| SketchStore | store.py | packed corpus, incremental ingest, fill cache |
| SegmentedStore | segments.py | counting head, sealed segments, tombstones, compaction and distillation (synchronous or background), checkpoints, hits and lifecycle_snapshot() |
| ControllerPolicy, LifecycleController | lifecycle.py | the hands-off maintenance loop: size-tiered merges, a distill ladder under a memory budget, a recall guardrail, one tick a heartbeat |
| JobSupervisor | supervision.py | retries, watchdog, quarantine, degraded modes, health() of background jobs |
| BandPolicy, BandIndex | banding.py | the banded LSH prefilter's knobs and per-segment bucket index |
| Backend registry | backends.py | reference / cuda behind one name; register_backend adds more |
| QueryPlanner | planner.py | ragged batches -> bounded set of padded shapes |
| SegmentPlacer, SegmentPlacement, WidthSlab | placement.py | whole sealed segments placed on mesh shards, one id-ascending slab per shard and width, lazily refreshed validity masks |
| SketchEngine, shard_topk | engine.py | build + add + lifecycle verbs + score_all + mixed-width, prefiltered query + query_sharded (placed or sliced) + health() + enable_metrics() / metrics() |
"""

from .backends import (Backend, CudaBackend, ReferenceBackend, available_backends, get_backend,
                       register_backend)
from .banding import BandIndex, BandPolicy
from .engine import SketchEngine, merge_segment_topk, shard_topk
from .lifecycle import ControllerPolicy, LifecycleController
from .placement import SegmentPlacement, SegmentPlacer, WidthSlab
from .planner import QueryChunk, QueryPlanner
from .segments import DistillPolicy, SealedSegment, SegmentedStore
from .store import SegmentView, SketchStore
from .supervision import DegradedMode, JobSupervisor, SupervisedJob, SupervisionPolicy

__all__ = [
    "Backend",
    "BandIndex",
    "BandPolicy",
    "ControllerPolicy",
    "CudaBackend",
    "DegradedMode",
    "DistillPolicy",
    "JobSupervisor",
    "LifecycleController",
    "QueryChunk",
    "QueryPlanner",
    "ReferenceBackend",
    "SealedSegment",
    "SegmentPlacement",
    "SegmentPlacer",
    "SegmentView",
    "SegmentedStore",
    "SketchEngine",
    "SketchStore",
    "SupervisedJob",
    "SupervisionPolicy",
    "WidthSlab",
    "available_backends",
    "get_backend",
    "merge_segment_topk",
    "register_backend",
    "shard_topk",
]
