"""One cell's run against the port: the engine built from the configuration,
the warm-up, the measured window over the generated traffic, the bounded
drain and, in a traced run, the profiled sub-window.

The entry the window drives is ``repro_torch.serving.engine.
ContinuousBatchingEngine`` (``add_request`` / ``step``), the calls
``serving/offline.py`` and ``launch/serve.py`` make. The harness records,
on its own clock, when each request was due, when it was handed over and when
each frame of its tokens came back; and, by wrapping three of the backend's
calls on the instance, each step's admissions, prefill chunks and decode
call.
"""
from __future__ import annotations

import gc
import time
from dataclasses import dataclass, field

from harness.stats import Timeline


@dataclass
class Step:
    """One ``engine.step()``: its host-clock span and what it did."""
    t0: float
    t1: float = 0.0
    admitted: int = 0            # prompt tokens of the requests it admitted
    cached: int = 0              # of which served by the prefix cache
    prefill: list = field(default_factory=list)     # (rid, start, n)
    K: int = 0                   # decode iterations of its decode call
    running: int = 0             # sequences decoding after it
    frames: list = field(default_factory=list)      # (rid, offset, n)
    spans: list = field(default_factory=list)       # (name, start, end)


class HostClock:
    """The host's monotonic clock in seconds, and its sleep."""

    def __call__(self) -> float:
        return time.perf_counter()

    def sleep(self, seconds: float) -> None:
        time.sleep(seconds)


def port_config(conf: dict):
    """The port's ``ModelConfig`` for a configuration file's ``model``."""
    from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig
    m = dict(conf["model"])
    moe, ssm = m.pop("moe", None), m.pop("ssm", None)
    return ModelConfig(name=conf["name"], moe=MoEConfig(**moe) if moe else None,
                       ssm=SSMConfig(**ssm) if ssm else None, **m)


def engine_config(conf: dict, mix: dict) -> dict:
    """The cell's engine settings: the configuration's, then the mix's."""
    return {**conf["engine"], **mix.get("engine", {})}


class Run:
    """The engine of one run and the harness's record of it."""

    def __init__(self, conf: dict, mix: dict, params, device, clock=None):
        """``clock``: the harness's clock, a callable returning seconds with
        a ``sleep(seconds)``; default the host's (``time.perf_counter``,
        ``time.sleep``)."""
        from repro_torch.models import make_model
        from repro_torch.serving.engine import (ContinuousBatchingEngine,
                                                EngineConfig)
        self.clock = clock or HostClock()
        self.model_cfg = port_config(conf)
        self.engine = ContinuousBatchingEngine(
            make_model(self.model_cfg), params,
            EngineConfig(**engine_config(conf, mix)), device=device)
        self.timelines: dict[str, Timeline] = {}
        self.requests = {}
        self.steps: list[Step] = []
        self.t0 = 0.0
        self._cur: Step | None = None
        self._wrap(self.engine.backend)

    # -- instruments ---------------------------------------------------------
    def _span(self, name, fn):
        def timed(*a, **kw):
            s = self.clock()
            out = fn(*a, **kw)
            if self._cur is not None:
                self._cur.spans.append((name, s - self.t0, self.clock() - self.t0))
            return out
        return timed

    def _wrap(self, backend):
        start, chunk, fused = (backend.start_prefill, backend.prefill_chunk,
                               backend.fused_decode)

        def start_prefill(seq_id, prompt):
            task = start(seq_id, prompt)
            if self._cur is not None:
                self._cur.admitted += len(prompt)
                self._cur.cached += task.cached_tokens
            return task

        def prefill_chunk(task, budget=None):
            pos = task.pos
            out = chunk(task, budget)
            if self._cur is not None:
                self._cur.prefill.append((task.seq_id, pos, out[1]))
            return out

        def fused_decode(K, host_state=None):
            out = fused(K, host_state)
            if self._cur is not None:
                self._cur.K = out[0].shape[0]
            return out

        backend.start_prefill = self._span("admit", start_prefill)
        backend.prefill_chunk = self._span("prefill", prefill_chunk)
        backend.fused_decode = self._span("decode", fused_decode)

    # -- requests ------------------------------------------------------------
    def add(self, r):
        """Hand request ``r`` (``traffic.Request``) to the engine; its
        frames land in its timeline, timed on arrival at the harness."""
        from repro_torch.serving.request import InferenceRequest, SamplingParams
        tl = Timeline(r.rid, r.due, len(r.prompt), r.max_tokens)
        self.timelines[r.rid] = tl
        self.requests[r.rid] = r

        def on_delta(frame, tl=tl):
            at = self.clock() - self.t0
            if frame.n_tokens:
                tl.frames.append((at, frame.n_tokens))
                tl.tokens.extend(frame.tokens)
                if self._cur is not None:
                    self._cur.frames.append((tl.rid, frame.offset, frame.n_tokens))
            if frame.finished:
                tl.finished = at

        self.engine.add_request(InferenceRequest(
            model=self.model_cfg.name, prompt_tokens=r.prompt, request_id=r.rid,
            sampling=SamplingParams(max_tokens=r.max_tokens,
                                    temperature=r.temperature, top_p=r.top_p,
                                    seed=r.seed)), on_delta=on_delta)

    def step(self):
        st = Step(self.clock() - self.t0)
        self._cur = st
        try:
            self.engine.step()
        finally:
            self._cur = None
        st.t1 = self.clock() - self.t0
        st.running = self.engine.num_running
        self.steps.append(st)

    def serve(self, reqs, limit_s: float):
        """Serve ``reqs`` at once to their end (the warm-up); raises if
        they take over ``limit_s``."""
        self.t0 = self.clock()
        for r in reqs:
            self.add(r)
        while self.engine.has_work():
            if self.clock() - self.t0 > limit_s:
                raise RuntimeError(f"warm-up not done in {limit_s} s")
            self.step()

    def reset_records(self):
        self.timelines, self.requests, self.steps = {}, {}, []

    # -- the window ----------------------------------------------------------
    def window(self, reqs, seconds: float, drain_s: float, tracer=None):
        """Send ``reqs`` at their due times for ``seconds``, stepping the
        engine whenever it has work; then, for ``drain_s`` at most, step on
        with no new arrival until every request due in the window has
        finished (``drain_s`` 0: stop at the window's close). ``tracer``:
        called with (run, now) before every step and once at the close.
        Returns the seconds the generator ran late at most (a request is
        handed over after the step that was running when it fell due)."""
        reqs = sorted(reqs, key=lambda r: r.due)
        late = 0.0
        i = 0
        gc.collect()
        gc.disable()
        try:
            self.t0 = self.clock()
            while True:
                now = self.clock() - self.t0
                if now >= seconds:
                    break
                while i < len(reqs) and reqs[i].due <= now:
                    late = max(late, now - reqs[i].due)
                    self.add(reqs[i])
                    i += 1
                if tracer is not None:
                    tracer(self, now)
                if self.engine.has_work():
                    self.step()
                else:
                    nxt = reqs[i].due if i < len(reqs) else seconds
                    self.clock.sleep(max(0.0, min(nxt, seconds) - now))
            if tracer is not None:
                tracer(self, None)
            # a request due before the close, while the last step ran, is
            # handed over now: it belongs to the window and its wait counts
            while drain_s and i < len(reqs) and reqs[i].due < seconds:
                now = self.clock() - self.t0
                late = max(late, now - reqs[i].due)
                self.add(reqs[i])
                i += 1
            end = seconds + drain_s
            while drain_s and any(t.finished is None
                                  for t in self.timelines.values()):
                if self.clock() - self.t0 >= end:
                    break
                self.step()
        finally:
            gc.enable()
        return late


def free(run: Run):
    """Drop the engine (its KV pools and caches) so that the reference has
    the memory."""
    run.engine = None
    gc.collect()

