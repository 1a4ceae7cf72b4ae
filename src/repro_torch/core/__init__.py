# The serving system's engine and its host-side modules (paged KV
# allocator, scheduler, metrics, tracing, timeline). The replica, router
# and gateway stack of the reference come with a later slice.
from repro_torch.core.engine import EngineConfig, InferenceEngine, TokenEvent, sample_tokens
from repro_torch.core.kv_cache import OutOfPages, PagedAllocator, PrefixCache
from repro_torch.core.metrics import BenchmarkSummary, Request, now, request_metrics, summarize
from repro_torch.core.observability import MetricsSink, Span, Tracer
from repro_torch.core.scheduler import ContinuousBatchScheduler
from repro_torch.core.timeline import LogHistogram, SLOConfig, StepRecord, TimelineAggregator

__all__ = [
    "EngineConfig", "InferenceEngine", "TokenEvent", "sample_tokens",
    "OutOfPages", "PagedAllocator", "PrefixCache", "BenchmarkSummary",
    "Request", "now", "request_metrics", "summarize", "MetricsSink",
    "ContinuousBatchScheduler", "Span", "Tracer", "LogHistogram", "SLOConfig",
    "StepRecord", "TimelineAggregator",
]
