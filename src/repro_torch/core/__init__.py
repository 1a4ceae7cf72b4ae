# The paper's primary contribution: the end-to-end serving system
# (gateway + router + replicas + continuous-batching engine + paged KV).
# Speculative decoding (the reference's core.spec) comes with a later slice.
from repro_torch.core.engine import EngineConfig, InferenceEngine, TokenEvent, sample_tokens
from repro_torch.core.faults import FaultEvent, FaultInjector, FaultPlan, TransientSubmitError
from repro_torch.core.gateway import Gateway, GatewayConfig, baseline_gateway_config, scale_gateway_config
from repro_torch.core.kv_cache import OutOfPages, PagedAllocator, PrefixCache
from repro_torch.core.metrics import BenchmarkSummary, Request, now, request_metrics, summarize
from repro_torch.core.observability import MetricsSink, Span, Tracer
from repro_torch.core.replica import Replica
from repro_torch.core.router import FailoverEvent, NoReplicaAvailable, ReplicaRouter, RouterConfig
from repro_torch.core.scheduler import ContinuousBatchScheduler
from repro_torch.core.serde import CODECS
from repro_torch.core.timeline import LogHistogram, SLOConfig, StepRecord, TimelineAggregator

__all__ = [
    "EngineConfig", "InferenceEngine", "TokenEvent", "sample_tokens",
    "FaultEvent", "FaultInjector", "FaultPlan", "TransientSubmitError",
    "FailoverEvent",
    "Gateway", "GatewayConfig", "baseline_gateway_config", "scale_gateway_config",
    "OutOfPages", "PagedAllocator", "PrefixCache", "BenchmarkSummary",
    "Request", "now",
    "request_metrics", "summarize", "MetricsSink", "Replica",
    "NoReplicaAvailable", "ReplicaRouter", "RouterConfig",
    "ContinuousBatchScheduler", "CODECS",
    "Span", "Tracer", "LogHistogram", "SLOConfig", "StepRecord",
    "TimelineAggregator",
]
