"""Request metrics log + summary statistics (paper §5.1 metrics).

A copy of the JAX package's ``repro/core/metrics.py``, unchanged in
behaviour.
"""
from __future__ import annotations

import statistics
from dataclasses import dataclass, field


@dataclass
class RequestRecord:
    request_id: str
    user: str = ""
    model: str = ""
    endpoint: str = ""
    arrival: float = 0.0
    dispatched: float = 0.0
    first_token: float = 0.0
    finish: float = 0.0
    prompt_tokens: int = 0
    output_tokens: int = 0
    ok: bool = True
    error: str = ""
    error_code: str = ""            # stable /v1 taxonomy code, "" when ok
    cached: bool = False
    cached_prompt_tokens: int = 0   # engine prefix-cache reuse (partial hit)
    prefill_chunks: int = 0         # chunked-prefill steps for this prompt
    # streaming observability (only populated for stream=true requests):
    # frames received at the GATEWAY and the gaps between them — TTFT/ITL
    # as the API boundary sees them, network hop included
    streamed: bool = False
    stream_frames: int = 0
    itl: list = field(default_factory=list)
    # resilience accounting (gateway retry layer)
    attempts: int = 1               # dispatch attempts (1 = no retries)
    timeouts: int = 0               # attempts killed by the TTFT/stall bound
    resumed_tokens: int = 0         # tokens carried across a failover resume

    @property
    def e2e(self) -> float:
        return self.finish - self.arrival

    @property
    def ttft(self) -> float:
        return self.first_token - self.arrival


class MetricsLog:
    """The gateway's PostgreSQL-activity-log analogue + live dashboard stats."""

    def __init__(self):
        self.records: list[RequestRecord] = []
        self._open: dict[str, RequestRecord] = {}
        # gateway admission-control counters, keyed by /v1 error code
        # (rate_limit_error, overloaded, ...): rejections never reach an
        # endpoint, so they are visible ONLY here and in jobs_status()
        self.rejections: dict[str, int] = {}
        # hedged duplicates cancelled after losing the first-token race
        # (instead of running to completion and burning engine slots)
        self.hedges_cancelled = 0
        # resilience counters (gateway retry/breaker/brownout layer); the
        # chaos gates cross-check these against per-record accounting
        self.retries = 0                # re-dispatches after a failure
        self.timeouts = 0               # attempts killed by a timeout
        self.failovers_resumed = 0      # retries that resumed mid-stream
        self.resumed_tokens = 0         # tokens carried across failovers
        self.breaker_opens = 0          # circuit-breaker trips
        self.brownout_shed = 0          # requests shed by degradation

    # -- lifecycle hooks ------------------------------------------------------
    def on_arrival(self, request_id, user, model, t, prompt_tokens=0):
        r = RequestRecord(request_id=request_id, user=user, model=model,
                          arrival=t, prompt_tokens=prompt_tokens)
        self._open[request_id] = r
        return r

    def on_dispatch(self, request_id, endpoint, t):
        r = self._open.get(request_id)
        if r:
            r.dispatched = t
            r.endpoint = endpoint

    def on_first_token(self, request_id, t):
        r = self._open.get(request_id)
        if r and not r.first_token:
            r.first_token = t

    def on_delta(self, request_id, t, n_tokens=1):
        """A stream frame reached the gateway: record TTFT on the first and
        the inter-frame gap on every later one."""
        r = self._open.get(request_id)
        if r is None:
            return
        r.streamed = True
        if r.stream_frames > 0:
            r.itl.append(t - r._last_frame)
        elif not r.first_token:
            r.first_token = t
        r.stream_frames += 1
        r._last_frame = t

    def on_reject(self, code: str):
        """An admission-control rejection (never dispatched)."""
        self.rejections[code] = self.rejections.get(code, 0) + 1

    def on_hedge_cancelled(self):
        self.hedges_cancelled += 1

    # -- resilience hooks -------------------------------------------------------
    def on_retry(self, request_id, resumed_tokens: int = 0):
        """A failed/timed-out attempt is being re-dispatched; nonzero
        ``resumed_tokens`` means the retry resumes a live stream."""
        self.retries += 1
        if resumed_tokens > 0:
            self.failovers_resumed += 1
            self.resumed_tokens += resumed_tokens
        r = self._open.get(request_id)
        if r:
            r.attempts += 1
            r.resumed_tokens = max(r.resumed_tokens, resumed_tokens)

    def on_timeout(self, request_id):
        self.timeouts += 1
        r = self._open.get(request_id)
        if r:
            r.timeouts += 1

    def on_breaker_open(self):
        self.breaker_opens += 1

    def on_brownout_shed(self):
        self.brownout_shed += 1

    def on_finish(self, request_id, t, output_tokens=0, ok=True, error="",
                  cached=False, cached_prompt_tokens=0, prefill_chunks=0,
                  error_code=""):
        r = self._open.pop(request_id, None)
        if r is None:
            return
        r.finish = t
        r.output_tokens = output_tokens
        r.ok = ok
        r.error = error
        r.error_code = error_code
        r.cached = cached
        r.cached_prompt_tokens = cached_prompt_tokens
        r.prefill_chunks = prefill_chunks
        self.records.append(r)

    # -- summaries --------------------------------------------------------------
    def summary(self, t0: float | None = None, t1: float | None = None) -> dict:
        recs = [r for r in self.records if r.ok]
        if t0 is not None:
            recs = [r for r in recs if r.finish >= t0]
        if t1 is not None:
            recs = [r for r in recs if r.finish <= t1]
        if not recs:
            return {"completed": 0}
        start = t0 if t0 is not None else min(r.arrival for r in recs)
        end = t1 if t1 is not None else max(r.finish for r in recs)
        dur = max(end - start, 1e-9)
        toks = sum(r.output_tokens for r in recs)
        prompt_toks = sum(r.prompt_tokens for r in recs)
        cached_toks = sum(r.cached_prompt_tokens for r in recs)
        return {
            "prompt_tokens": prompt_toks,
            "cached_prompt_tokens": cached_toks,
            "prefix_cache_hit_rate": (cached_toks / prompt_toks
                                      if prompt_toks else 0.0),
            "completed": len(recs),
            "failed": sum(1 for r in self.records if not r.ok),
            "duration_s": dur,
            "req_per_s": len(recs) / dur,
            "output_tok_per_s": toks / dur,
            "median_e2e_s": statistics.median(r.e2e for r in recs),
            "mean_e2e_s": statistics.fmean(r.e2e for r in recs),
            "p90_e2e_s": sorted(r.e2e for r in recs)[int(0.9 * (len(recs) - 1))],
            "median_ttft_s": statistics.median(
                r.ttft for r in recs if r.first_token),
            "output_tokens": toks,
            **self._stream_stats(recs),
        }

    def _stream_stats(self, recs) -> dict:
        """Gateway-observed streaming latencies (stream=true requests)."""
        gaps = [g for r in recs if r.streamed for g in r.itl]
        streamed = [r for r in recs if r.streamed and r.first_token]
        out = {"streamed": sum(1 for r in recs if r.streamed),
               "hedges_cancelled": self.hedges_cancelled,
               "rejections": dict(self.rejections),
               "retries": self.retries,
               "timeouts": self.timeouts,
               "failovers_resumed": self.failovers_resumed,
               "resumed_tokens": self.resumed_tokens,
               "breaker_opens": self.breaker_opens}
        if streamed:
            out["stream_median_ttft_s"] = statistics.median(
                r.ttft for r in streamed)
        if gaps:
            gaps.sort()
            out["stream_median_itl_s"] = statistics.median(gaps)
            out["stream_p99_itl_s"] = gaps[int(0.99 * (len(gaps) - 1))]
        return out
