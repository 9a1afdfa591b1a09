"""LLM serving for the port: Request lifecycle, the dense engine, the
paged engine over the host BlockPool and its speculative sibling, and
the continuous-batching Scheduler."""
from .engine import ServingEngine
from .metrics import ServingMetrics
from .paged import (BlockPool, BlockPoolExhausted, PagedServingEngine,
                    SpeculativePagedEngine)
from .request import Request, RequestState
from .scheduler import Scheduler

__all__ = ["BlockPool", "BlockPoolExhausted", "PagedServingEngine",
           "Request", "RequestState", "Scheduler", "ServingEngine",
           "ServingMetrics", "SpeculativePagedEngine"]
