from repro_torch.serve.blockpool import BlockPool
from repro_torch.serve.config import ServeConfig
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.scheduler import (
    Completion,
    Request,
    Scheduler,
    latency_stats,
    serve_requests,
)

__all__ = [
    "BlockPool",
    "Completion",
    "Request",
    "Scheduler",
    "ServeConfig",
    "ServeEngine",
    "latency_stats",
    "serve_requests",
]
