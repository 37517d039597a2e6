"""Typed, versioned /v1 request & response schemas (OpenAI-compatible).

A copy of the JAX package's ``repro/api/schemas.py``, unchanged in
behaviour; ``to_inference_request`` builds the port's
``repro_torch.serving.request`` types.

These dataclasses are the system's public contract: the gateway parses
every inbound payload into one of them, the compute hop serializes them
into a version-tagged wire dict (``to_wire``/``from_wire``), endpoints
decode them back, and responses return as typed objects carrying OpenAI
``usage`` accounting.

Two prompt representations coexist because the repo has two planes:

* control plane (DES): ``prompt_tokens`` is an int TOKEN COUNT — the
  simulator never materializes token ids;
* data plane (the real serving engine): ``prompt_tokens`` is a list of
  token ids.

``content_hash`` is defined for id-list prompts (sha256 of the ids) or an
explicit ``prompt_hash``; count-only prompts have NO content identity and
are therefore never response-cached (two different prompts with equal
length must not share a cache entry).

Serialization is canonical: ``dumps()`` emits sorted keys with compact
separators, so serialize -> parse -> serialize is byte-stable — the golden
fixtures under ``tests/golden/`` pin this for every schema.

Legacy compatibility: response objects support read-only ``Mapping``-style
access (``resp["output_tokens"]``) for the pre-/v1 dict keys, so existing
drivers keep working while they migrate.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field, replace
from typing import Any

from repro_torch.api.errors import InvalidRequestError

API_VERSION = "v1"

VALID_ENDPOINTS = ("chat/completions", "completions", "embeddings")


def dumps(obj) -> str:
    """Canonical JSON for a schema object (or plain dict): sorted keys,
    compact separators — the byte-stable wire form."""
    d = obj.to_dict() if hasattr(obj, "to_dict") else obj
    return json.dumps(d, sort_keys=True, separators=(",", ":"))


def _req_int(d: dict, key: str, minimum: int | None = None, default=None):
    v = d.get(key, default)
    if v is None:
        raise InvalidRequestError(f"missing required field {key!r}",
                                  param=key)
    try:
        v = int(v)
    except (TypeError, ValueError):
        raise InvalidRequestError(f"field {key!r} must be an integer",
                                  param=key) from None
    if minimum is not None and v < minimum:
        raise InvalidRequestError(f"field {key!r} must be >= {minimum}",
                                  param=key)
    return v


def _prompt_field(v, key: str):
    """Validate a prompt: int token count (DES) or list of token ids."""
    if isinstance(v, bool):
        raise InvalidRequestError(f"field {key!r} must be a token count or "
                                  "a list of token ids", param=key)
    if isinstance(v, int):
        if v < 0:
            raise InvalidRequestError(f"field {key!r} must be >= 0",
                                      param=key)
        return v
    if isinstance(v, (list, tuple)):
        try:
            return [int(t) for t in v]
        except (TypeError, ValueError):
            raise InvalidRequestError(
                f"field {key!r} token ids must be integers",
                param=key) from None
    raise InvalidRequestError(f"field {key!r} must be a token count or a "
                              "list of token ids", param=key)


# ---------------------------------------------------------------------------
# usage accounting
# ---------------------------------------------------------------------------

@dataclass
class Usage:
    """OpenAI usage block; ``cached_tokens`` is the prefix-cache reuse."""
    prompt_tokens: int = 0
    completion_tokens: int = 0
    total_tokens: int = 0
    cached_tokens: int = 0

    def to_dict(self) -> dict:
        return {"prompt_tokens": self.prompt_tokens,
                "completion_tokens": self.completion_tokens,
                "total_tokens": self.total_tokens,
                "prompt_tokens_details": {"cached_tokens": self.cached_tokens}}

    @classmethod
    def from_dict(cls, d: dict) -> "Usage":
        details = d.get("prompt_tokens_details") or {}
        return cls(prompt_tokens=_req_int(d, "prompt_tokens", 0, 0),
                   completion_tokens=_req_int(d, "completion_tokens", 0, 0),
                   total_tokens=_req_int(d, "total_tokens", 0, 0),
                   cached_tokens=int(details.get("cached_tokens", 0)))


# ---------------------------------------------------------------------------
# requests
# ---------------------------------------------------------------------------

@dataclass
class ChatMessage:
    role: str
    content: str

    def to_dict(self) -> dict:
        return {"role": self.role, "content": self.content}

    @classmethod
    def from_dict(cls, d: dict) -> "ChatMessage":
        if not isinstance(d.get("role"), str) \
                or not isinstance(d.get("content"), str):
            raise InvalidRequestError("message needs string 'role' and "
                                      "'content'", param="messages")
        return cls(role=d["role"], content=d["content"])


@dataclass
class _RequestBase:
    """Fields shared by every generation request."""
    model: str = ""
    max_tokens: int = 16
    temperature: float = 0.0
    top_p: float = 1.0
    seed: int = 0
    stop_token: int | None = None
    stream: bool = False
    user: str = ""
    qos: str = "interactive"              # interactive | batch
    priority: int = 0                     # intra-class, lower = more urgent
    deadline: float | None = None         # absolute TTFT deadline
    request_id: str = ""
    prompt_hash: str | None = None        # explicit content hash override
    resume_tokens: int = 0                # failover resume: tokens already
    #                                       streamed to the client; the new
    #                                       engine restores and continues

    endpoint = "completions"              # class attr, set per subclass

    def _prompt(self) -> int | list:
        raise NotImplementedError         # each endpoint defines its prompt

    def _validate(self):
        if not self.model or not isinstance(self.model, str):
            raise InvalidRequestError("field 'model' is required",
                                      param="model")
        if int(self.max_tokens) < 1:
            raise InvalidRequestError("field 'max_tokens' must be >= 1",
                                      param="max_tokens")
        if self.qos not in ("interactive", "batch"):
            raise InvalidRequestError(
                f"unknown qos class {self.qos!r}", param="qos")
        if not (0.0 < float(self.top_p) <= 1.0):
            raise InvalidRequestError("field 'top_p' must be in (0, 1]",
                                      param="top_p")
        if float(self.temperature) < 0.0:
            raise InvalidRequestError("field 'temperature' must be >= 0",
                                      param="temperature")

    # -- token-count views (both planes) -----------------------------------
    @property
    def prompt_token_count(self) -> int:
        p = self._prompt()
        return p if isinstance(p, int) else len(p)

    @property
    def prompt_token_ids(self) -> list | None:
        p = self._prompt()
        return p if isinstance(p, list) else None

    @property
    def content_hash(self) -> str | None:
        """Content identity for response caching: explicit hash, or the
        hash of materialized token ids. Count-only prompts return None —
        they carry no content and MUST NOT be cached."""
        if self.prompt_hash:
            return self.prompt_hash
        return self._ids_hash()

    def _ids_hash(self) -> str | None:
        ids = self.prompt_token_ids
        if ids is None:
            return None
        h = hashlib.sha256()
        h.update(repr(ids).encode())
        return h.hexdigest()[:32]

    def _common_dict(self) -> dict:
        d = {"model": self.model, "max_tokens": self.max_tokens,
             "temperature": self.temperature, "top_p": self.top_p,
             "seed": self.seed, "stream": self.stream, "qos": self.qos,
             "priority": self.priority}
        if self.stop_token is not None:
            d["stop_token"] = self.stop_token
        if self.deadline is not None:
            d["deadline"] = self.deadline
        if self.user:
            d["user"] = self.user
        if self.request_id:
            d["request_id"] = self.request_id
        if self.prompt_hash:
            d["prompt_hash"] = self.prompt_hash
        if self.resume_tokens:
            d["resume_tokens"] = self.resume_tokens
        return d

    @classmethod
    def _common_kwargs(cls, d: dict) -> dict:
        if not isinstance(d.get("model"), str) or not d.get("model"):
            raise InvalidRequestError("field 'model' is required",
                                      param="model")
        return dict(
            model=d["model"],
            max_tokens=_req_int(d, "max_tokens", 1, 16),
            temperature=float(d.get("temperature", 0.0)),
            top_p=float(d.get("top_p", 1.0)),
            seed=int(d.get("seed", 0)),
            stop_token=(None if d.get("stop_token") is None
                        else int(d["stop_token"])),
            stream=bool(d.get("stream", False)),
            user=str(d.get("user", "") or ""),
            qos=str(d.get("qos", "interactive")),
            priority=int(d.get("priority", 0)),
            deadline=(None if d.get("deadline") is None
                      else float(d["deadline"])),
            request_id=str(d.get("request_id", "") or ""),
            prompt_hash=d.get("prompt_hash"),
            resume_tokens=int(d.get("resume_tokens", 0) or 0),
        )


@dataclass
class CompletionRequest(_RequestBase):
    """/v1/completions — raw prompt in, tokens out."""
    prompt_tokens: int | list = 0

    endpoint = "completions"

    def _prompt(self):
        return self.prompt_tokens

    def validate(self) -> "CompletionRequest":
        self.prompt_tokens = _prompt_field(self.prompt_tokens,
                                           "prompt_tokens")
        self._validate()
        return self

    def to_dict(self) -> dict:
        d = self._common_dict()
        d["object"] = "completion.request"
        d["prompt_tokens"] = self.prompt_tokens
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "CompletionRequest":
        kw = cls._common_kwargs(d)
        prompt = d.get("prompt_tokens", d.get("prompt"))
        return cls(prompt_tokens=_prompt_field(prompt, "prompt_tokens"),
                   **kw).validate()


@dataclass
class ChatCompletionRequest(_RequestBase):
    """/v1/chat/completions — messages in (or a pre-tokenized prompt)."""
    messages: list = field(default_factory=list)      # list[ChatMessage]
    prompt_tokens: int | list | None = None           # tokenized override

    endpoint = "chat/completions"

    def _prompt(self):
        if self.prompt_tokens is not None:
            return self.prompt_tokens
        # count view of untokenized messages: whitespace token estimate
        return sum(len(m.content.split()) for m in self.messages)

    @property
    def content_hash(self) -> str | None:
        if self.prompt_hash:
            return self.prompt_hash
        if self.prompt_tokens is None and self.messages:
            h = hashlib.sha256()
            for m in self.messages:
                h.update(f"{m.role}\x00{m.content}\x00".encode())
            return h.hexdigest()[:32]
        return self._ids_hash()

    def validate(self) -> "ChatCompletionRequest":
        if self.prompt_tokens is None and not self.messages:
            raise InvalidRequestError(
                "chat completion needs 'messages' or 'prompt_tokens'",
                param="messages")
        if self.prompt_tokens is not None:
            self.prompt_tokens = _prompt_field(self.prompt_tokens,
                                               "prompt_tokens")
        self._validate()
        return self

    def to_dict(self) -> dict:
        d = self._common_dict()
        d["object"] = "chat.completion.request"
        if self.messages:
            d["messages"] = [m.to_dict() for m in self.messages]
        if self.prompt_tokens is not None:
            d["prompt_tokens"] = self.prompt_tokens
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ChatCompletionRequest":
        kw = cls._common_kwargs(d)
        msgs = [ChatMessage.from_dict(m) for m in d.get("messages", ())]
        prompt = d.get("prompt_tokens")
        if prompt is not None:
            prompt = _prompt_field(prompt, "prompt_tokens")
        return cls(messages=msgs, prompt_tokens=prompt, **kw).validate()


@dataclass
class EmbeddingRequest(_RequestBase):
    """/v1/embeddings — one-step encode; ``input`` is count or token ids."""
    input: int | list = 0

    endpoint = "embeddings"

    def _prompt(self):
        return self.input

    def validate(self) -> "EmbeddingRequest":
        self.input = _prompt_field(self.input, "input")
        self.max_tokens = 1               # embeddings are single-step tasks
        self._validate()
        return self

    def to_dict(self) -> dict:
        d = self._common_dict()
        d["object"] = "embedding.request"
        d["input"] = self.input
        d.pop("stream", None)             # embeddings never stream
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "EmbeddingRequest":
        kw = cls._common_kwargs(d)
        kw["max_tokens"] = 1
        prompt = d.get("input", d.get("prompt_tokens"))
        return cls(input=_prompt_field(prompt, "input"), **kw).validate()


_REQUEST_TYPES = {
    "chat/completions": ChatCompletionRequest,
    "completions": CompletionRequest,
    "embeddings": EmbeddingRequest,
}

_WIRE_KINDS = {
    "chat.completion.request": ChatCompletionRequest,
    "completion.request": CompletionRequest,
    "embedding.request": EmbeddingRequest,
}


def parse_request(payload: dict, endpoint: str | None = None):
    """Parse an untyped payload into the matching typed request.

    ``endpoint`` (or the payload's legacy ``api`` key) selects the schema;
    defaults to chat/completions like the original gateway."""
    if not isinstance(payload, dict):
        raise InvalidRequestError("request payload must be a JSON object")
    ep = endpoint or payload.get("api") or payload.get("endpoint") \
        or "chat/completions"
    cls = _REQUEST_TYPES.get(ep)
    if cls is None:
        raise InvalidRequestError(f"unknown endpoint {ep!r}", param="api")
    return cls.from_dict(payload)


def to_wire(req) -> dict:
    """Version-tagged wire envelope for the gateway -> endpoint hop."""
    d = req.to_dict()
    return {"v": API_VERSION, "kind": d["object"], "data": d}


def abort_wire(request_id: str) -> dict:
    """Version-tagged control payload for the 'abort' endpoint function."""
    return {"v": API_VERSION, "request_id": request_id}


def from_wire(payload: dict):
    """Decode a wire envelope back into a typed request (endpoint side).
    Untagged legacy dicts fall back to ``parse_request``."""
    if payload.get("v") == API_VERSION and "kind" in payload:
        cls = _WIRE_KINDS.get(payload["kind"])
        if cls is None:
            raise InvalidRequestError(
                f"unknown wire kind {payload['kind']!r}", param="kind")
        return cls.from_dict(payload["data"])
    return parse_request(payload)


# ---------------------------------------------------------------------------
# responses
# ---------------------------------------------------------------------------

@dataclass
class CompletionChoice:
    index: int = 0
    tokens: list | None = None            # token ids (data plane) or None
    finish_reason: str = ""

    def to_dict(self) -> dict:
        d = {"index": self.index, "finish_reason": self.finish_reason}
        if self.tokens is not None:
            d["tokens"] = self.tokens
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "CompletionChoice":
        return cls(index=int(d.get("index", 0)), tokens=d.get("tokens"),
                   finish_reason=str(d.get("finish_reason", "")))


# legacy dict keys the pre-/v1 drivers read off raw result dicts
_LEGACY_KEYS = {
    "request_id": lambda r: r.id,
    "output_tokens": lambda r: r.usage.completion_tokens,
    "prompt_tokens": lambda r: r.usage.prompt_tokens,
    "cached_prompt_tokens": lambda r: r.usage.cached_tokens,
    "endpoint": lambda r: r.endpoint_id,
    "first_token_time": lambda r: r.first_token_time,
    "finish_time": lambda r: r.finish_time,
    "prefill_chunks": lambda r: r.prefill_chunks,
    "preemptions": lambda r: r.preemptions,
    "restore_cached_tokens": lambda r: r.restore_cached_tokens,
}


@dataclass
class _ResponseBase:
    id: str = ""
    model: str = ""
    created: float = 0.0
    usage: Usage = field(default_factory=Usage)
    # serving metadata beyond the OpenAI shape (kept under one key on the
    # wire): which federation endpoint answered + engine timing/accounting
    endpoint_id: str = ""
    first_token_time: float = 0.0
    finish_time: float = 0.0
    prefill_chunks: int = 0
    preemptions: int = 0
    restore_cached_tokens: int = 0
    cached: bool = False                  # served from the response cache

    object = "response"

    # -- Mapping-style legacy access ---------------------------------------
    def __getitem__(self, key):
        fn = _LEGACY_KEYS.get(key)
        if fn is None:
            raise KeyError(key)
        return fn(self)

    def get(self, key, default=None):
        try:
            return self[key]
        except KeyError:
            return default

    def copy(self):
        return replace(self, usage=replace(self.usage))

    def _meta_dict(self) -> dict:
        return {"endpoint": self.endpoint_id,
                "first_token_time": round(self.first_token_time, 6),
                "finish_time": round(self.finish_time, 6),
                "prefill_chunks": self.prefill_chunks,
                "preemptions": self.preemptions,
                "restore_cached_tokens": self.restore_cached_tokens,
                "cached": self.cached}

    def _base_dict(self) -> dict:
        return {"id": self.id, "object": self.object, "model": self.model,
                "created": round(self.created, 6),
                "usage": self.usage.to_dict(),
                "first_meta": self._meta_dict()}

    @classmethod
    def _base_kwargs(cls, d: dict) -> dict:
        meta = d.get("first_meta") or {}
        return dict(id=str(d.get("id", "")), model=str(d.get("model", "")),
                    created=float(d.get("created", 0.0)),
                    usage=Usage.from_dict(d.get("usage") or {}),
                    endpoint_id=str(meta.get("endpoint", "")),
                    first_token_time=float(meta.get("first_token_time", 0.0)),
                    finish_time=float(meta.get("finish_time", 0.0)),
                    prefill_chunks=int(meta.get("prefill_chunks", 0)),
                    preemptions=int(meta.get("preemptions", 0)),
                    restore_cached_tokens=int(
                        meta.get("restore_cached_tokens", 0)),
                    cached=bool(meta.get("cached", False)))


@dataclass
class ChatCompletionResponse(_ResponseBase):
    choices: list = field(default_factory=list)   # list[CompletionChoice]

    object = "chat.completion"

    def to_dict(self) -> dict:
        d = self._base_dict()
        d["choices"] = [c.to_dict() for c in self.choices]
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ChatCompletionResponse":
        return cls(choices=[CompletionChoice.from_dict(c)
                            for c in d.get("choices", ())],
                   **cls._base_kwargs(d))


@dataclass
class CompletionResponse(_ResponseBase):
    choices: list = field(default_factory=list)

    object = "text_completion"

    def to_dict(self) -> dict:
        d = self._base_dict()
        d["choices"] = [c.to_dict() for c in self.choices]
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "CompletionResponse":
        return cls(choices=[CompletionChoice.from_dict(c)
                            for c in d.get("choices", ())],
                   **cls._base_kwargs(d))


@dataclass
class EmbeddingResponse(_ResponseBase):
    # DES embeddings carry no vector data; the real embedding service fills
    # ``data`` with {"object": "embedding", "index", "embedding"} entries
    data: list = field(default_factory=list)

    object = "list"

    def to_dict(self) -> dict:
        d = self._base_dict()
        d["data"] = self.data
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "EmbeddingResponse":
        return cls(data=list(d.get("data", ())), **cls._base_kwargs(d))


_RESPONSE_FOR = {
    "chat/completions": ChatCompletionResponse,
    "completions": CompletionResponse,
    "embeddings": EmbeddingResponse,
}


def response_from_result(req, result: dict, created: float):
    """Build the typed /v1 response for ``req`` from an endpoint result
    dict (the engine completion record)."""
    out = int(result.get("output_tokens", 0))
    usage = Usage(
        prompt_tokens=req.prompt_token_count,
        completion_tokens=out,
        total_tokens=req.prompt_token_count + out,
        cached_tokens=int(result.get("cached_prompt_tokens", 0)))
    cls = _RESPONSE_FOR[req.endpoint]
    kw = dict(
        id=str(result.get("request_id", req.request_id)),
        model=req.model, created=created, usage=usage,
        endpoint_id=str(result.get("endpoint", "")),
        first_token_time=float(result.get("first_token_time", 0.0)),
        finish_time=float(result.get("finish_time", 0.0)),
        prefill_chunks=int(result.get("prefill_chunks", 0)),
        preemptions=int(result.get("preemptions", 0)),
        restore_cached_tokens=int(result.get("restore_cached_tokens", 0)))
    if cls is EmbeddingResponse:
        return EmbeddingResponse(**kw)
    choice = CompletionChoice(index=0, tokens=result.get("tokens"),
                              finish_reason=str(
                                  result.get("finish_reason", "length")))
    return cls(choices=[choice], **kw)


# ---------------------------------------------------------------------------
# streaming
# ---------------------------------------------------------------------------

@dataclass
class StreamDelta:
    """One incremental chunk of a streamed response (SSE frame analogue).

    ``tokens`` holds the emitted ids on the data plane; the DES control
    plane streams counts only (``tokens=None``, ``n_tokens`` set). The
    final frame has ``finished=True`` + ``finish_reason`` and no tokens.

    ``offset`` is the stream position of the frame's FIRST token: if a
    fault-tolerance requeue restarts generation, re-emitted frames carry
    offsets the receiver has already passed and are deduplicated at the
    gateway — the client never sees a token twice."""
    id: str = ""
    index: int = 0                        # 0-based frame sequence number
    tokens: list | None = None
    n_tokens: int = 0
    offset: int = 0                       # stream position of tokens[0]
    created: float = 0.0                  # engine-side emit time
    finished: bool = False
    finish_reason: str = ""

    object = "chat.completion.chunk"

    def to_dict(self) -> dict:
        d = {"id": self.id, "object": self.object, "index": self.index,
             "n_tokens": self.n_tokens, "offset": self.offset,
             "created": round(self.created, 6)}
        if self.tokens is not None:
            d["tokens"] = self.tokens
        if self.finished:
            d["finished"] = True
            d["finish_reason"] = self.finish_reason
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "StreamDelta":
        return cls(id=str(d.get("id", "")), index=int(d.get("index", 0)),
                   tokens=d.get("tokens"),
                   n_tokens=int(d.get("n_tokens", 0)),
                   offset=int(d.get("offset", 0)),
                   created=float(d.get("created", 0.0)),
                   finished=bool(d.get("finished", False)),
                   finish_reason=str(d.get("finish_reason", "")))


# ---------------------------------------------------------------------------
# batches (/v1/batches)
# ---------------------------------------------------------------------------

@dataclass
class BatchItem:
    """One NDJSON line of a batch input file. ``body`` may be a typed
    request or its raw dict: parsing/validation is DEFERRED to
    ``parsed_body()`` so one malformed line becomes a per-request error
    instead of rejecting the whole batch."""
    custom_id: str
    body: Any                             # typed request OR its raw dict
    method: str = "POST"
    url: str = "/v1/completions"

    def parsed_body(self):
        """The typed, validated request; raises InvalidRequestError for
        THIS item only."""
        if isinstance(self.body, dict):
            ep = self.url.split("/v1/", 1)[-1]
            return parse_request(self.body, endpoint=ep)
        return self.body.validate()

    def body_model(self) -> str:
        return (self.body.get("model", "") if isinstance(self.body, dict)
                else self.body.model)

    def to_dict(self) -> dict:
        body = self.body if isinstance(self.body, dict) \
            else self.body.to_dict()
        return {"custom_id": self.custom_id, "method": self.method,
                "url": self.url, "body": body}

    @classmethod
    def from_dict(cls, d: dict) -> "BatchItem":
        if not d.get("custom_id"):
            raise InvalidRequestError("batch item needs 'custom_id'",
                                      param="custom_id")
        body = d.get("body")
        if not isinstance(body, dict):
            raise InvalidRequestError("batch item needs a 'body' object",
                                      param="body")
        return cls(custom_id=str(d["custom_id"]), body=body,
                   method=str(d.get("method", "POST")),
                   url=str(d.get("url", "/v1/completions")))


@dataclass
class BatchRequest:
    """/v1/batches submission: a list of request items processed offline
    on a dedicated instance. All items must target one model (one batch =
    one dedicated cluster job)."""
    items: list = field(default_factory=list)         # list[BatchItem]
    completion_window: str = "24h"
    metadata: dict = field(default_factory=dict)

    @property
    def model(self) -> str:
        for it in self.items:
            if it.body_model():
                return it.body_model()
        return ""

    def validate(self) -> "BatchRequest":
        models = {it.body_model() for it in self.items} - {""}
        if len(models) > 1:
            raise InvalidRequestError(
                f"batch items span multiple models {sorted(models)}; one "
                "batch runs one dedicated model job", param="items")
        ids = [it.custom_id for it in self.items]
        if len(set(ids)) != len(ids):
            raise InvalidRequestError("duplicate custom_id in batch",
                                      param="custom_id")
        return self

    def to_dict(self) -> dict:
        return {"object": "batch.request",
                "completion_window": self.completion_window,
                "metadata": self.metadata,
                "items": [it.to_dict() for it in self.items]}

    @classmethod
    def from_dict(cls, d: dict) -> "BatchRequest":
        return cls(items=[BatchItem.from_dict(it)
                          for it in d.get("items", ())],
                   completion_window=str(d.get("completion_window", "24h")),
                   metadata=dict(d.get("metadata") or {})).validate()


@dataclass
class BatchStatus:
    """/v1/batches/{id} poll result (OpenAI batch object shape)."""
    id: str = ""
    status: str = "validating"
    model: str = ""
    created_at: float = 0.0
    in_progress_at: float = 0.0
    completed_at: float = 0.0
    total: int = 0
    completed: int = 0
    failed: int = 0
    output_tokens: int = 0

    object = "batch"

    def to_dict(self) -> dict:
        return {"id": self.id, "object": self.object, "status": self.status,
                "model": self.model,
                "created_at": round(self.created_at, 6),
                "in_progress_at": round(self.in_progress_at, 6),
                "completed_at": round(self.completed_at, 6),
                "request_counts": {"total": self.total,
                                   "completed": self.completed,
                                   "failed": self.failed},
                "output_tokens": self.output_tokens}

    @classmethod
    def from_dict(cls, d: dict) -> "BatchStatus":
        counts = d.get("request_counts") or {}
        return cls(id=str(d.get("id", "")),
                   status=str(d.get("status", "validating")),
                   model=str(d.get("model", "")),
                   created_at=float(d.get("created_at", 0.0)),
                   in_progress_at=float(d.get("in_progress_at", 0.0)),
                   completed_at=float(d.get("completed_at", 0.0)),
                   total=int(counts.get("total", 0)),
                   completed=int(counts.get("completed", 0)),
                   failed=int(counts.get("failed", 0)),
                   output_tokens=int(d.get("output_tokens", 0)))

    # legacy keys (pre-/v1 BatchJob.status() dict)
    def __getitem__(self, key):
        legacy = {"batch_id": self.id, "state": self.status,
                  "completed": self.completed, "total": self.total,
                  "output_tokens": self.output_tokens}
        if key in legacy:
            return legacy[key]
        raise KeyError(key)

    def get(self, key, default=None):
        try:
            return self[key]
        except KeyError:
            return default


# ---------------------------------------------------------------------------
# data-plane bridge
# ---------------------------------------------------------------------------

def to_inference_request(req, arrival_time: float = 0.0):
    """Convert a typed /v1 request into the engine's ``InferenceRequest``
    (data plane only: the prompt must be token ids)."""
    from repro_torch.serving.request import InferenceRequest, SamplingParams
    ids = req.prompt_token_ids
    if ids is None:
        raise InvalidRequestError(
            "data-plane requests need token ids, not a token count",
            param="prompt_tokens")
    return InferenceRequest(
        model=req.model, prompt_tokens=list(ids),
        request_id=req.request_id, user=req.user or "anonymous",
        arrival_time=arrival_time, api_endpoint=req.endpoint,
        qos=req.qos, priority=req.priority, deadline=req.deadline,
        sampling=SamplingParams(max_tokens=req.max_tokens,
                                temperature=req.temperature,
                                top_p=req.top_p, seed=req.seed,
                                stop_token=req.stop_token))
