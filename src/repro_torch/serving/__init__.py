from .block_allocator import BlockAllocator, NULL_BLOCK
from .session import make_session_fns
from .sampler import choose_tokens, choose_tokens_lanes
from .scheduler import ContinuousScheduler, SchedulerStats
from .api import (EngineConfig, Request, RequestHandle, SamplingParams,
                  ServingEngine, build_engine, build_session_fns)

__all__ = ["make_session_fns", "choose_tokens", "choose_tokens_lanes",
           "ContinuousScheduler", "SchedulerStats", "BlockAllocator",
           "NULL_BLOCK", "EngineConfig", "Request", "RequestHandle",
           "SamplingParams", "ServingEngine", "build_engine",
           "build_session_fns"]
