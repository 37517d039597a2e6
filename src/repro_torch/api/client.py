"""Typed /v1 client over the Inference Gateway.

The DES analogue of an OpenAI SDK: builds typed requests, submits them to
a gateway, and hands back futures of typed responses. Streaming requests
attach a ``StreamAssembler`` (or any callback) to receive ``StreamDelta``
frames; ``cancel`` models a client disconnect.

    client = FirstClient(system.gateway, token)
    fut = client.chat(model="llama3.3-70b", prompt_tokens=256,
                      max_tokens=64)
    system.loop.run_until_idle()
    resp = fut.result()             # ChatCompletionResponse, with .usage

A copy of the JAX package's ``repro/api/client.py``. The gateway is duck
typed: any object with ``submit``, ``cancel``, ``create_batch``,
``batch_status``, ``batch_results``, ``jobs_status`` and a ``loop`` clock
(the port has no gateway of its own yet: ROADMAP Queue 1 item 14).
"""
from __future__ import annotations

from repro_torch.api import schemas
from repro_torch.api.stream import StreamAssembler


class FirstClient:
    def __init__(self, gateway, token: str):
        self.gateway = gateway
        self.token = token

    # -- generation -------------------------------------------------------------
    def chat(self, *, on_delta=None, **fields):
        """/v1/chat/completions; pass ``stream=True`` + ``on_delta`` for
        incremental frames."""
        req = schemas.ChatCompletionRequest(**fields)
        return self.gateway.submit(self.token, req, on_delta=on_delta)

    def complete(self, *, on_delta=None, **fields):
        """/v1/completions."""
        req = schemas.CompletionRequest(**fields)
        return self.gateway.submit(self.token, req, on_delta=on_delta)

    def embed(self, **fields):
        """/v1/embeddings."""
        req = schemas.EmbeddingRequest(**fields)
        return self.gateway.submit(self.token, req)

    def stream(self, *, assembler: StreamAssembler | None = None, **fields):
        """Streamed chat completion: returns ``(future, assembler)`` — the
        assembler collects frames and client-observed TTFT/ITL while the
        future resolves with the full typed response."""
        asm = assembler or StreamAssembler(clock=self.gateway.loop)
        fut = self.chat(stream=True, on_delta=asm, **fields)
        return fut, asm

    def cancel(self, request_id: str) -> bool:
        """Model a client disconnect: abort the in-flight request."""
        return self.gateway.cancel(request_id)

    # -- batches ----------------------------------------------------------------
    def create_batch(self, items, **fields):
        """/v1/batches: ``items`` are ``BatchItem``s (or their dicts)."""
        req = schemas.BatchRequest(
            items=[schemas.BatchItem.from_dict(it) if isinstance(it, dict)
                   else it for it in items], **fields)
        return self.gateway.create_batch(self.token, req)

    def batch_status(self, batch_id: str):
        return self.gateway.batch_status(batch_id)

    def batch_results(self, batch_id: str):
        return self.gateway.batch_results(batch_id)

    # -- status -----------------------------------------------------------------
    def jobs(self) -> dict:
        return self.gateway.jobs_status()
