"""Fault tolerance: failure injection (nodes, instances, endpoints,
heartbeat loss, latency, correlated racks) and the heartbeat-driven health
monitor that feeds endpoint liveness into the federation router.

Detection is OBSERVED, not scripted: ``ComputeEndpoint.attach_monitor``
makes each endpoint emit periodic beats over the (injectable) network; the
monitor derives liveness from missed beats, recovery from the first beat
seen again, and a straggler flag from the beat-latency EWMA. The router is
only ever told about *transitions* — the monitor never blanket-rewrites
health, so an outage injected directly into the router (or a manual
``mark_down``) persists until its owner lifts it.

Instance/process restart + in-flight resume lives in ComputeEndpoint;
gateway-side retries/breakers live in ``repro_torch.core.resilience``; this
module provides the chaos and the detection.

A copy of the JAX package's ``repro/core/faults.py``, unchanged in
behaviour.
"""
from __future__ import annotations

import random


class FailureInjector:
    def __init__(self, loop, seed: int = 0):
        self.loop = loop
        self.rng = random.Random(seed)
        self.injected: list[tuple[float, str]] = []

    # -- targeted ---------------------------------------------------------------
    def fail_node_at(self, scheduler, node_id: int, t: float,
                     restore_after: float | None = None):
        def _fail():
            self.injected.append((self.loop.now(), f"node:{scheduler.name}/{node_id}"))
            scheduler.fail_node(node_id)
            if restore_after is not None:
                self.loop.call_after(restore_after, scheduler.restore_node,
                                     node_id)
        self.loop.call_at(t, _fail)

    def fail_instance_at(self, endpoint, model: str, t: float,
                         which: int = 0):
        def _fail():
            alive = [i for i in endpoint.instances.get(model, []) if i.alive]
            if which < len(alive):
                self.injected.append(
                    (self.loop.now(), f"instance:{alive[which].instance_id}"))
                alive[which].fail()
        self.loop.call_at(t, _fail)

    def endpoint_outage(self, router, endpoint_id: str, t: float,
                        duration: float):
        """Router-level outage (e.g. a network partition the control plane
        learned about out of band): mark unhealthy now, healthy at
        ``t+duration``. The heartbeat monitor must NOT undo this — its own
        belief about the endpoint never changed, so it emits no transition."""
        def _down():
            self.injected.append((self.loop.now(), f"endpoint:{endpoint_id}"))
            router.set_healthy(endpoint_id, False)
            self.loop.call_after(duration, router.set_healthy, endpoint_id,
                                 True)
        self.loop.call_at(t, _down)

    def crash_endpoint(self, endpoint, t: float, duration: float,
                       silent: bool = False):
        """Real endpoint-process crash: beats stop (the monitor detects it),
        in-flight tasks error — or vanish when ``silent``, exercising the
        gateway's per-attempt timeout — and the process restarts cold at
        ``t+duration``."""
        def _crash():
            self.injected.append(
                (self.loop.now(),
                 f"crash{':silent' if silent else ''}:{endpoint.endpoint_id}"))
            endpoint.crash(duration, silent=silent)
        self.loop.call_at(t, _crash)

    def heartbeat_loss(self, endpoint, t: float, duration: float):
        """Beats vanish while the endpoint keeps serving: a detector
        false-positive. Liveness must recover from the first beat after the
        window without operator action."""
        def _lose():
            self.injected.append(
                (self.loop.now(), f"hb-loss:{endpoint.endpoint_id}"))
            endpoint.suppress_heartbeats(duration)
        self.loop.call_at(t, _lose)

    def latency_injection(self, endpoint, t: float, duration: float,
                          extra: float):
        """Straggler: beat latency inflated by ``extra`` seconds for
        ``duration`` — the monitor's EWMA should flag (and later clear) the
        endpoint as slow."""
        def _slow():
            self.injected.append(
                (self.loop.now(), f"latency:{endpoint.endpoint_id}+{extra:g}s"))
            endpoint.inject_latency(duration, extra)
        self.loop.call_at(t, _slow)

    def rack_outage(self, scheduler, t: float, nodes: list[int],
                    restore_after: float | None = None):
        """Correlated failure: a whole rack's nodes die at the same instant
        (shared PDU/switch), not as independent Poisson events."""
        def _fail():
            self.injected.append(
                (self.loop.now(),
                 f"rack:{scheduler.name}/{min(nodes)}-{max(nodes)}"))
            for n in nodes:
                scheduler.fail_node(n)
            if restore_after is not None:
                for n in nodes:
                    self.loop.call_after(restore_after,
                                         scheduler.restore_node, n)
        self.loop.call_at(t, _fail)

    # -- stochastic (MTBF-style, for scale studies) -------------------------------
    def random_node_failures(self, scheduler, rate_per_node_hour: float,
                             horizon: float, restore_after: float = 600.0):
        """Poisson failures: at 1000+ nodes even small per-node rates mean
        failures every few minutes — the control plane must absorb them."""
        lam = rate_per_node_hour * scheduler.num_nodes / 3600.0
        t = 0.0
        while True:
            t += self.rng.expovariate(lam) if lam > 0 else horizon
            if t >= horizon:
                break
            node = self.rng.randrange(scheduler.num_nodes)
            self.fail_node_at(scheduler, node, t, restore_after=restore_after)

    # -- seeded chaos schedule ----------------------------------------------------
    def _poisson_times(self, rate: float, start: float,
                       horizon: float) -> list[float]:
        ts, t = [], start
        while rate > 0:
            t += self.rng.expovariate(rate)
            if t >= horizon:
                break
            ts.append(t)
        return ts

    def plan_chaos(self, endpoints, schedulers, horizon: float, *,
                   start: float = 0.0,
                   node_rate: float = 0.0,
                   instance_rate: float = 0.0,
                   crash_rate: float = 0.0,
                   silent_crash_rate: float = 0.0,
                   hb_loss_rate: float = 0.0,
                   latency_rate: float = 0.0,
                   rack_rate: float = 0.0,
                   rack_size: int = 4,
                   mean_outage: float = 20.0,
                   latency_extra: float = 3.0) -> list[dict]:
        """Build and schedule a full chaos run: independent Poisson streams
        per fault class (rates are events/second across the federation),
        uniformly random targets, exponential outage durations. Everything
        derives from this injector's seed, so a schedule replays exactly —
        the JAX package's ``benchmarks/chaos_soak.py`` leans on that for its
        deterministic gates. Returns the plan (sorted by time) for logging/auditing."""
        eps = list(endpoints.values()) if isinstance(endpoints, dict) \
            else list(endpoints)
        scheds = list(schedulers.values()) if isinstance(schedulers, dict) \
            else list(schedulers)
        plan: list[dict] = []

        def _dur() -> float:
            return max(self.rng.expovariate(1.0 / mean_outage), 1.0)

        for t in self._poisson_times(node_rate, start, horizon):
            s = self.rng.choice(scheds)
            plan.append({"t": t, "kind": "node",
                         "target": s.name,
                         "node": self.rng.randrange(s.num_nodes),
                         "duration": _dur()})
        for t in self._poisson_times(instance_rate, start, horizon):
            ep = self.rng.choice(eps)
            model = self.rng.choice(sorted(ep.deployments))
            plan.append({"t": t, "kind": "instance",
                         "target": ep.endpoint_id, "model": model})
        for t in self._poisson_times(crash_rate, start, horizon):
            ep = self.rng.choice(eps)
            plan.append({"t": t, "kind": "crash",
                         "target": ep.endpoint_id, "duration": _dur()})
        for t in self._poisson_times(silent_crash_rate, start, horizon):
            ep = self.rng.choice(eps)
            plan.append({"t": t, "kind": "silent-crash",
                         "target": ep.endpoint_id, "duration": _dur()})
        for t in self._poisson_times(hb_loss_rate, start, horizon):
            ep = self.rng.choice(eps)
            plan.append({"t": t, "kind": "hb-loss",
                         "target": ep.endpoint_id, "duration": _dur()})
        for t in self._poisson_times(latency_rate, start, horizon):
            ep = self.rng.choice(eps)
            plan.append({"t": t, "kind": "latency",
                         "target": ep.endpoint_id, "duration": _dur(),
                         "extra": latency_extra})
        for t in self._poisson_times(rack_rate, start, horizon):
            s = self.rng.choice(scheds)
            base = self.rng.randrange(max(s.num_nodes - rack_size, 1))
            plan.append({"t": t, "kind": "rack", "target": s.name,
                         "nodes": list(range(base, base + rack_size)),
                         "duration": _dur()})
        plan.sort(key=lambda e: e["t"])

        ep_by_id = {e.endpoint_id: e for e in eps}
        sched_by_name = {s.name: s for s in scheds}
        for ev in plan:
            if ev["kind"] == "node":
                self.fail_node_at(sched_by_name[ev["target"]], ev["node"],
                                  ev["t"], restore_after=ev["duration"])
            elif ev["kind"] == "instance":
                self.fail_instance_at(ep_by_id[ev["target"]], ev["model"],
                                      ev["t"])
            elif ev["kind"] == "crash":
                self.crash_endpoint(ep_by_id[ev["target"]], ev["t"],
                                    ev["duration"])
            elif ev["kind"] == "silent-crash":
                self.crash_endpoint(ep_by_id[ev["target"]], ev["t"],
                                    ev["duration"], silent=True)
            elif ev["kind"] == "hb-loss":
                self.heartbeat_loss(ep_by_id[ev["target"]], ev["t"],
                                    ev["duration"])
            elif ev["kind"] == "latency":
                self.latency_injection(ep_by_id[ev["target"]], ev["t"],
                                       ev["duration"], ev["extra"])
            elif ev["kind"] == "rack":
                self.rack_outage(sched_by_name[ev["target"]], ev["t"],
                                 ev["nodes"], restore_after=ev["duration"])
        return plan


class HealthMonitor:
    """Heartbeat-driven failure detector.

    Endpoints registered via ``watch()`` emit beats (``on_beat``); the
    periodic ``_tick`` marks an endpoint down only after
    ``miss_threshold`` beat intervals of silence, the next observed beat
    marks it up again, and the beat-latency EWMA over ``slow_latency``
    raises the router's straggler flag. All router updates are edge-
    triggered: the monitor never rewrites health it has no new evidence
    about, so externally injected outages persist (see
    ``FailureInjector.endpoint_outage``).

    ``mark_down``/``mark_up`` remain as manual operator overrides: a
    marked-down endpoint stays down in the router even while its beats
    flow."""

    def __init__(self, loop, router, interval: float = 15.0,
                 miss_threshold: float = 3.0, slow_latency: float = 1.0,
                 ewma_alpha: float = 0.3):
        self.loop = loop
        self.router = router
        self.interval = interval
        self.miss_threshold = miss_threshold
        self.slow_latency = slow_latency
        self.ewma_alpha = ewma_alpha
        self._beats: dict[str, dict] = {}   # ep -> belief state
        self._down: set[str] = set()        # manual overrides
        self.checks = 0
        # (t, endpoint, event) for event in down|up|slow|recovered-speed
        self.transitions: list[tuple[float, str, str]] = []
        self._tick()

    # -- wiring -----------------------------------------------------------------
    def watch(self, endpoint) -> None:
        """Subscribe to an endpoint's heartbeats (starts its beat loop)."""
        self._beats[endpoint.endpoint_id] = {
            "last": self.loop.now(),
            "interval": endpoint.heartbeat_interval,
            "ewma": None, "up": True, "slow": False}
        endpoint.attach_monitor(self)

    # -- observations ------------------------------------------------------------
    def on_beat(self, endpoint_id: str, sent_t: float) -> None:
        st = self._beats.get(endpoint_id)
        if st is None:
            return
        now = self.loop.now()
        st["last"] = now
        lat = now - sent_t
        a = self.ewma_alpha
        st["ewma"] = lat if st["ewma"] is None \
            else (1 - a) * st["ewma"] + a * lat
        if not st["up"]:
            st["up"] = True
            self.transitions.append((now, endpoint_id, "up"))
            if endpoint_id not in self._down:
                self.router.set_healthy(endpoint_id, True)
        slow = st["ewma"] > self.slow_latency
        if slow != st["slow"]:
            st["slow"] = slow
            self.transitions.append(
                (now, endpoint_id, "slow" if slow else "recovered-speed"))
            if hasattr(self.router, "set_slow"):
                self.router.set_slow(endpoint_id, slow)

    # -- manual overrides ---------------------------------------------------------
    def mark_down(self, endpoint_id: str):
        self._down.add(endpoint_id)
        self.router.set_healthy(endpoint_id, False)

    def mark_up(self, endpoint_id: str):
        self._down.discard(endpoint_id)
        st = self._beats.get(endpoint_id)
        if st is None or st["up"]:
            self.router.set_healthy(endpoint_id, True)

    # -- liveness from missed beats ------------------------------------------------
    def is_up(self, endpoint_id: str) -> bool:
        st = self._beats.get(endpoint_id)
        return bool(st and st["up"]) and endpoint_id not in self._down

    def _tick(self):
        self.checks += 1
        now = self.loop.now()
        for ep_id, st in self._beats.items():
            silent_for = now - st["last"]
            if st["up"] and silent_for > self.miss_threshold * st["interval"]:
                st["up"] = False
                self.transitions.append((now, ep_id, "down"))
                self.router.set_healthy(ep_id, False)
        self.loop.call_after(self.interval, self._tick, daemon=True)
