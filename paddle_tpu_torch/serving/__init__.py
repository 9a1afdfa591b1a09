"""LLM serving for the port: Request lifecycle, the dense engine, the
paged engine over the host BlockPool and its speculative sibling, the
block-level KV handoff, and the continuous-batching Scheduler with its
fault, drain, token-mask, priority and role policy."""
from .engine import HEALTH_STATES, ServingEngine
from .metrics import ServingMetrics
from .paged import (BlockPool, BlockPoolExhausted, HandoffRefused,
                    PagedServingEngine, SpeculativePagedEngine)
from .request import Request, RequestState
from .scheduler import ROLES, Scheduler

__all__ = ["BlockPool", "BlockPoolExhausted", "HEALTH_STATES",
           "HandoffRefused", "PagedServingEngine", "ROLES", "Request",
           "RequestState", "Scheduler", "ServingEngine", "ServingMetrics",
           "SpeculativePagedEngine"]
