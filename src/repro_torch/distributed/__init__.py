"""Distribution pieces of the port: collectives over a mesh's process
groups and the int8 compressed all-reduce (``collectives.py``), elastic
resharding (``elastic.py``) and host-side fault tolerance (``fault.py``, a
copy of ``repro/distributed/fault.py``)."""
from repro_torch.distributed.collectives import (
    CompressionState,
    compressed_psum_int8,
    init_compression_state,
)
from repro_torch.distributed.elastic import reshard_plan
from repro_torch.distributed.fault import StepTimeMonitor, retry_transient

__all__ = [
    "compressed_psum_int8",
    "CompressionState",
    "init_compression_state",
    "StepTimeMonitor",
    "retry_transient",
    "reshard_plan",
]
