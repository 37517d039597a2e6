"""OpenAI-style API error taxonomy with stable codes (paper §3.1).

Every error the /v1 surface can return is an ``APIError`` subclass carrying
a stable ``code`` (what clients switch on), an HTTP-equivalent ``status``
(what a real front end would send), and — for throttling errors — a
computed ``retry_after`` in seconds. ``to_dict()`` renders the OpenAI wire
shape ``{"error": {"message", "type", "code", "param", "retry_after"}}``.

The taxonomy is part of the versioned contract: codes never change meaning
across /v1 revisions, new conditions get NEW codes.

A copy of the JAX package's ``repro/api/errors.py``.
"""
from __future__ import annotations


class APIError(Exception):
    """Base of the /v1 error taxonomy."""

    code = "api_error"
    status = 500

    def __init__(self, message: str, *, param: str | None = None,
                 retry_after: float | None = None):
        super().__init__(message)
        self.message = message
        self.param = param
        self.retry_after = retry_after

    def to_dict(self) -> dict:
        err: dict = {"message": self.message, "type": self.code,
                     "code": self.code}
        if self.param is not None:
            err["param"] = self.param
        if self.retry_after is not None:
            err["retry_after"] = round(self.retry_after, 6)
        return {"error": err}

    def __repr__(self):                                    # pragma: no cover
        return f"{type(self).__name__}({self.message!r})"


class InvalidRequestError(APIError):
    """Malformed payload: unknown endpoint, bad types, out-of-range values."""
    code = "invalid_request_error"
    status = 400


class AuthenticationError(APIError):
    """Invalid/expired token, or the identity lacks access to the model."""
    code = "authentication_error"
    status = 401


class ModelNotFoundError(APIError):
    """The model is not configured anywhere in the federation registry."""
    code = "model_not_found"
    status = 404


class RateLimitError(APIError):
    """Per-user token bucket exhausted; ``retry_after`` says when the next
    request token accrues."""
    code = "rate_limit_error"
    status = 429


class OverloadedError(APIError):
    """Transient capacity exhaustion: gateway queue full, or no healthy
    endpoint currently hosts the model."""
    code = "overloaded"
    status = 503


class RequestCancelled(APIError):
    """The client disconnected (or a hedged duplicate lost the race) and the
    request was aborted before completion."""
    code = "request_cancelled"
    status = 499


class DegradedError(OverloadedError):
    """Shed by brownout admission control: the gateway is running in a
    degraded mode (capacity loss or sustained overload) and is deliberately
    rejecting lower-value work to protect interactive latency. A subclass
    of ``overloaded`` so legacy handlers keep working; clients that switch
    on the code can distinguish policy shedding from raw capacity
    exhaustion."""
    code = "degraded"
    status = 503


class UpstreamTimeoutError(APIError):
    """Every dispatch attempt timed out (or the retry budget ran dry) before
    an upstream endpoint produced a first token."""
    code = "upstream_timeout"
    status = 504


def error_from_dict(d: dict) -> APIError:
    """Parse the wire shape back into the matching typed error."""
    err = d.get("error", d)
    cls = _BY_CODE.get(err.get("code"), APIError)
    return cls(err.get("message", ""), param=err.get("param"),
               retry_after=err.get("retry_after"))


_BY_CODE = {c.code: c for c in (InvalidRequestError, AuthenticationError,
                                ModelNotFoundError, RateLimitError,
                                OverloadedError, RequestCancelled,
                                DegradedError, UpstreamTimeoutError,
                                APIError)}
