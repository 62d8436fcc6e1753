"""Serving: the continuous-batching decode engine, window micro-batching
and the HTTP server with its client."""

from dreamllm_tpu_torch.serve.engine import ContinuousBatchingEngine, EngineConfig
from dreamllm_tpu_torch.serve.server import ModelServer, OnlineClient

__all__ = ["ModelServer", "OnlineClient", "ContinuousBatchingEngine", "EngineConfig"]
