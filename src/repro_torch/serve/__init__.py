"""Serving: the slot loop shared by the port's engines (:class:`SlotLoop`),
the LM generation engine and its continuous batcher."""
from repro_torch.serve.batcher import Batcher, Request
from repro_torch.serve.engine import GenerationConfig, ServeEngine

__all__ = ["Batcher", "GenerationConfig", "Request", "ServeEngine"]
