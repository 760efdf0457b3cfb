"""Serving subsystem of the port: one-call prefill, slot-based continuous
batching, with ``resolve_serve_engine`` as the single config-resolution
point (from ``repro/serving``)."""
from .engine import (ContinuousServeEngine, MeasuredTimer, ModelTimer,
                     ServeConfig, ServeEngine, ServeEvent, ServePlan,
                     StaticServeEngine, make_serve_engine,
                     resolve_serve_engine)
from .scheduler import Request, SlotAllocator, poisson_requests

__all__ = [
    "ServeConfig", "ServePlan", "ServeEvent", "ServeEngine",
    "ContinuousServeEngine", "StaticServeEngine", "MeasuredTimer",
    "ModelTimer", "resolve_serve_engine", "make_serve_engine",
    "Request", "SlotAllocator", "poisson_requests",
]
