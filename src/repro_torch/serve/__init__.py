from repro_torch.serve.async_engine import AsyncServeEngine
from repro_torch.serve.blockpool import BlockPool
from repro_torch.serve.config import Capability, ServeConfig, TelemetryConfig, capabilities
from repro_torch.serve.engine import ServeEngine, filter_logits, greedy_generate, sample_tokens
from repro_torch.serve.prefixcache import PrefixCache
from repro_torch.serve.scheduler import (
    Completion,
    Request,
    Scheduler,
    fully_paged_tier,
    latency_stats,
    prefix_cache_eligible,
    serve_requests,
)
from repro_torch.serve.speculative import (
    SpeculativeConfig,
    SpeculativeScheduler,
    speculative_eligible,
)

__all__ = [
    "AsyncServeEngine",
    "BlockPool",
    "Capability",
    "Completion",
    "PrefixCache",
    "Request",
    "Scheduler",
    "ServeConfig",
    "ServeEngine",
    "SpeculativeConfig",
    "SpeculativeScheduler",
    "TelemetryConfig",
    "capabilities",
    "filter_logits",
    "fully_paged_tier",
    "greedy_generate",
    "latency_stats",
    "prefix_cache_eligible",
    "sample_tokens",
    "serve_requests",
    "speculative_eligible",
]
