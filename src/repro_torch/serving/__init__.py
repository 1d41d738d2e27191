"""Batched serving over the KV-cache engine."""

from repro_torch.serving.engine import Request, RequestState, ServingConfig, ServingEngine

__all__ = ["Request", "RequestState", "ServingConfig", "ServingEngine"]
