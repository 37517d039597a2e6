"""Globus-Auth analogue: token issuance, introspection, group-based RBAC, and
the gateway-side introspection cache (paper Optimization 2 — caching removed
~2 s/request and avoided provider rate limits).

A copy of the JAX package's ``repro/core/auth.py``, unchanged in
behaviour.
"""
from __future__ import annotations

import hashlib
import itertools
from dataclasses import dataclass, field

_tok_counter = itertools.count()

TOKEN_TTL = 48 * 3600.0            # paper §4.6: tokens valid 48 h


class AuthError(Exception):
    pass


@dataclass
class Identity:
    user: str
    groups: tuple = ()
    expires_at: float = 0.0


class AuthService:
    """The identity provider (runs 'remotely': introspection costs latency)."""

    def __init__(self, loop, introspection_latency: float = 2.0,
                 rate_limit_per_s: float = 50.0):
        self.loop = loop
        self.introspection_latency = introspection_latency
        self.rate_limit_per_s = rate_limit_per_s
        self._tokens: dict[str, Identity] = {}
        self._groups: dict[str, set] = {}
        self._window_start = 0.0
        self._window_count = 0
        self.introspections = 0

    # -- admin ------------------------------------------------------------------
    def add_user(self, user: str, groups=()):
        self._groups[user] = set(groups)

    def issue_token(self, user: str) -> str:
        if user not in self._groups:
            raise AuthError(f"unknown user {user}")
        raw = f"{user}:{next(_tok_counter)}"
        tok = hashlib.sha256(raw.encode()).hexdigest()[:32]
        self._tokens[tok] = Identity(
            user=user, groups=tuple(sorted(self._groups[user])),
            expires_at=self.loop.now() + TOKEN_TTL)
        return tok

    def refresh(self, token: str) -> str:
        ident = self._tokens.get(token)
        if ident is None:
            raise AuthError("unknown token")
        return self.issue_token(ident.user)

    # -- introspection (remote call: latency + provider rate limit) --------------
    def introspect(self, token: str, cb):
        """Async introspection; calls cb(identity or AuthError)."""
        now = self.loop.now()
        if now - self._window_start >= 1.0:
            self._window_start, self._window_count = now, 0
        self._window_count += 1
        if self._window_count > self.rate_limit_per_s:
            self.loop.call_after(self.introspection_latency, cb,
                                 AuthError("identity provider rate limited"))
            return
        self.introspections += 1
        ident = self._tokens.get(token)
        result = ident if ident and ident.expires_at > now else \
            AuthError("invalid or expired token")
        self.loop.call_after(self.introspection_latency, cb, result)


class CachingAuthClient:
    """Gateway-side cache of token introspections (Optimization 2)."""

    def __init__(self, loop, service: AuthService, ttl: float = 600.0,
                 enabled: bool = True):
        self.loop = loop
        self.service = service
        self.ttl = ttl
        self.enabled = enabled
        self._cache: dict[str, tuple[float, Identity]] = {}
        self._inflight: dict[str, list] = {}   # coalesce concurrent lookups
        self.hits = 0
        self.misses = 0

    def validate(self, token: str, cb):
        """cb(Identity) on success, cb(AuthError) on failure. Concurrent
        lookups of the same token coalesce into ONE introspection — a burst
        of first requests must not trip the provider's rate limit."""
        now = self.loop.now()
        if self.enabled:
            hit = self._cache.get(token)
            if hit and hit[0] > now:
                self.hits += 1
                self.loop.call_after(0.0, cb, hit[1])
                return
            if token in self._inflight:
                self.hits += 1
                self._inflight[token].append(cb)
                return
        self.misses += 1
        if self.enabled:
            self._inflight[token] = [cb]

        def _store(result):
            if isinstance(result, Identity) and self.enabled:
                self._cache[token] = (self.loop.now() + self.ttl, result)
            waiters = self._inflight.pop(token, [cb]) if self.enabled else [cb]
            for w in waiters:
                w(result)

        self.service.introspect(token, _store)


@dataclass
class AccessPolicy:
    """Globus-groups-style RBAC: which groups may use which models."""
    model_groups: dict = field(default_factory=dict)   # model -> required group
    default_allow: bool = True

    def allowed(self, ident: Identity, model: str) -> bool:
        need = self.model_groups.get(model)
        if need is None:
            return self.default_allow
        return need in ident.groups
