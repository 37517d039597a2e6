"""Typed, versioned OpenAI-compatible /v1 API layer (the paper's product
surface): request/response schemas, the error taxonomy, token streaming,
and the batch-jobs shape. See docs/API.md for the full reference.

A copy of the JAX package's ``repro/api`` (framework-neutral), unchanged
in behaviour."""
from repro_torch.api.errors import (APIError, AuthenticationError,
                              InvalidRequestError, ModelNotFoundError,
                              OverloadedError, RateLimitError,
                              RequestCancelled, error_from_dict)
from repro_torch.api.schemas import (API_VERSION, VALID_ENDPOINTS, BatchItem,
                               BatchRequest, BatchStatus, ChatCompletionRequest,
                               ChatCompletionResponse, ChatMessage,
                               CompletionChoice, CompletionRequest,
                               CompletionResponse, EmbeddingRequest,
                               EmbeddingResponse, StreamDelta, Usage, dumps,
                               from_wire, parse_request, response_from_result,
                               to_inference_request, to_wire)
from repro_torch.api.stream import StreamAssembler
from repro_torch.api.client import FirstClient

__all__ = [
    "FirstClient",
    "APIError", "AuthenticationError", "InvalidRequestError",
    "ModelNotFoundError", "OverloadedError", "RateLimitError",
    "RequestCancelled", "error_from_dict",
    "API_VERSION", "VALID_ENDPOINTS", "BatchItem", "BatchRequest",
    "BatchStatus", "ChatCompletionRequest", "ChatCompletionResponse",
    "ChatMessage", "CompletionChoice", "CompletionRequest",
    "CompletionResponse", "EmbeddingRequest", "EmbeddingResponse",
    "StreamDelta", "Usage", "dumps", "from_wire", "parse_request",
    "response_from_result", "to_inference_request", "to_wire",
    "StreamAssembler",
]
