from repro_torch.serve.blockpool import BlockPool
from repro_torch.serve.config import Capability, ServeConfig, capabilities
from repro_torch.serve.engine import ServeEngine, filter_logits, greedy_generate, sample_tokens
from repro_torch.serve.scheduler import (
    Completion,
    Request,
    Scheduler,
    fully_paged_tier,
    latency_stats,
    serve_requests,
)

__all__ = [
    "BlockPool",
    "Capability",
    "Completion",
    "Request",
    "Scheduler",
    "ServeConfig",
    "ServeEngine",
    "capabilities",
    "filter_logits",
    "fully_paged_tier",
    "greedy_generate",
    "latency_stats",
    "sample_tokens",
    "serve_requests",
]
