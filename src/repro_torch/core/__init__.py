# Copy of src/repro/core/__init__.py, kept numpy-only; change both copies together.
"""Thallus core: zero-copy columnar transport (the paper's contribution)."""
from .schema import Field, Schema, schema  # noqa: F401
from .recordbatch import (  # noqa: F401
    Column, RecordBatch, batch_from_arrays, batch_from_pydict,
    column_from_pylist, concat_batches, pack_validity, unpack_validity,
)
from .bulk import (  # noqa: F401
    BulkHandle, SegmentDesc, allocate_like, assemble_batch, expose_batch,
    size_vectors,
)
from .serialize import pack, unpack, serialized_size  # noqa: F401
from .fabric import (  # noqa: F401
    Fabric, FabricConfig, FlappingFabric, WireStats,
)
from .transport import (  # noqa: F401
    RpcTransport, ThallusTransport, Transport, TransportStats, make_transport,
    rdma_pull_batch,
)
from .protocol import (  # noqa: F401
    QueryEngine, RecordBatchReader, RpcClient, ScanHandle, ServerCrashedError,
    ThallusClient, ThallusServer,
)
