"""repro_torch.serve — continuous-batching inference engine (PyTorch).

Counterpart of ``repro.serve``::

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.serve import EngineConfig, Request, ServeEngine

    model = get_arch("granite-3-2b").make_model()
    params = model.init(torch.Generator("cuda").manual_seed(0))
    engine = ServeEngine(model, params, EngineConfig(
        max_batch=8, max_seq=576, kv_backend="paged"))
    comps = engine.generate([Request(tokens=[1, 2, 3], max_new_tokens=32)])
"""

from .cache import CachePool, PagedCachePool
from .config import EngineConfig
from .engine import ServeEngine
from .naive import NaiveLoop, naive_generate
from .sampling import make_token_sampler
from .scheduler import RequestState, Scheduler
from .types import Completion, EngineStats, Request, SamplingParams

__all__ = [
    "Request", "SamplingParams", "Completion", "EngineStats",
    "EngineConfig", "ServeEngine", "CachePool", "PagedCachePool",
    "Scheduler", "RequestState", "NaiveLoop", "naive_generate",
    "make_token_sampler",
]
