"""OpenAI-compatible streaming serving gateway (HTTP/SSE front-end)."""

from llmq_tpu_torch.gateway.server import ServingGateway

__all__ = ["ServingGateway"]
