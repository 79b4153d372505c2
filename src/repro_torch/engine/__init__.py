"""repro_torch.engine — append-only sketch serving.

| piece | file | role |
|---|---|---|
| SketchStore | store.py | packed corpus, incremental ingest, fill cache |
| Backend registry | backends.py | reference / cuda behind one name |
| QueryPlanner | planner.py | ragged batches -> bounded set of padded shapes |
| SketchEngine | engine.py | build + add + score_all + query |
"""

from .backends import Backend, CudaBackend, ReferenceBackend, available_backends, get_backend
from .engine import SketchEngine, merge_segment_topk
from .planner import QueryChunk, QueryPlanner
from .store import SegmentView, SketchStore

__all__ = [
    "Backend",
    "CudaBackend",
    "QueryChunk",
    "QueryPlanner",
    "ReferenceBackend",
    "SegmentView",
    "SketchEngine",
    "SketchStore",
    "available_backends",
    "get_backend",
    "merge_segment_topk",
]
