"""Federation layer: the §4.5 priority-based endpoint-selection algorithm.

  1. prefer an endpoint where the model is already running or queued/starting
     (low latency: hot instances exist);
  2. else an endpoint whose cluster has enough free nodes to start one;
  3. else the FIRST endpoint configured for the model (registry order).

Within rules 1 and 2 ties are broken by cluster load — shallowest
scheduler queue first, then most available nodes, then registry
(configuration) order — so a hot-but-drowning cluster no longer wins over
an equally hot idle one just by being listed first. Each decision records
``(model, endpoint, rule, detail)`` with the tie-break inputs (and the
request's QoS class when the caller supplies one) for the /jobs audit
trail.

Endpoint health (faults.py) filters dead endpoints out before the scan.

A copy of the JAX package's ``repro/core/federation.py``, unchanged in
behaviour.
"""
from __future__ import annotations

from repro_torch.api.errors import OverloadedError
from repro_torch.core.compute import ComputeEndpoint


class FederationError(OverloadedError):
    """No healthy endpoint can serve the model right now. Part of the /v1
    taxonomy as ``overloaded`` (HTTP 503): the model is configured, but the
    federation cannot place the request — clients should back off and
    retry. (A model missing from the registry entirely is the gateway's
    ``model_not_found``.)"""


class FederationRouter:
    def __init__(self, endpoints: dict[str, ComputeEndpoint],
                 registry: dict[str, list[str]]):
        """registry: model -> endpoint ids in priority (configuration) order."""
        self.endpoints = endpoints
        self.registry = registry
        self._healthy: dict[str, bool] = {e: True for e in endpoints}
        self._slow: dict[str, bool] = {}
        # (model, endpoint, rule, detail) — detail holds the tie-break
        # inputs (queue depth / free nodes) and the request's QoS class
        self.decisions: list[tuple[str, str, str, str]] = []

    # -- health feed (from HealthMonitor) ----------------------------------------
    def set_healthy(self, endpoint_id: str, healthy: bool):
        self._healthy[endpoint_id] = healthy

    def set_slow(self, endpoint_id: str, slow: bool):
        """Straggler flag (beat-latency EWMA over threshold): slow endpoints
        stay eligible but lose every tie-break, so traffic drains to prompt
        replicas whenever one exists."""
        self._slow[endpoint_id] = slow

    def healthy_fraction(self) -> float:
        """Share of registered endpoints currently believed healthy — one of
        the gateway's brownout pressure signals."""
        if not self.endpoints:
            return 1.0
        return sum(1 for e in self.endpoints
                   if self._healthy.get(e, False)) / len(self.endpoints)

    def _candidates(self, model: str) -> list[str]:
        eps = [e for e in self.registry.get(model, ())
               if self._healthy.get(e, False)
               and self.endpoints[e].hosts(model)]
        if not eps:
            raise FederationError(f"no healthy endpoint hosts {model!r}")
        return eps

    # -- disaggregated roles ------------------------------------------------------
    def _role_of(self, e: str, model: str) -> str:
        dep = getattr(self.endpoints[e], "deployments", {}).get(model)
        return getattr(dep, "role", "unified")

    def _filter_roles(self, eps: list[str], model: str,
                      role: str | None) -> list[str]:
        """Role filter for disaggregated pools: fresh dispatches
        (role=None) need prefill capability, so decode-heavy endpoints are
        skipped while an alternative exists; handoffs (role='decode')
        prefer a dedicated decode pool, fall back to unified, and avoid
        prefill-heavy endpoints. With every candidate filtered out the
        original list survives — serving degraded beats not serving."""
        if role == "decode":
            capable = [e for e in eps
                       if self._role_of(e, model) != "prefill-heavy"]
            dedicated = [e for e in capable
                         if self._role_of(e, model) == "decode-heavy"]
            return dedicated or capable or eps
        capable = [e for e in eps
                   if self._role_of(e, model) != "decode-heavy"]
        return capable or eps

    def _warm(self, e: str, model: str) -> bool:
        return "running" in self.endpoints[e].model_states(model)

    def _cold_penalty(self, e: str, model: str) -> float:
        """Cold-start latency a request pays when routed to ``e`` with no
        hot instance: the scheduler's job startup plus the weight load
        (``cost.load_time``). Zero for a warm pool."""
        if self._warm(e, model):
            return 0.0
        ep = self.endpoints[e]
        dep = getattr(ep, "deployments", {}).get(model)
        cost = getattr(dep, "cost", None)
        load = cost.load_time() if cost is not None else 0.0
        return getattr(ep.scheduler, "startup_delay", 0.0) + load

    def _load_key(self, e: str) -> tuple[bool, int, int]:
        sched = self.endpoints[e].scheduler
        return (self._slow.get(e, False), sched.queue_depth(),
                -sched.available_nodes())

    def _pick(self, cands: list[str]) -> tuple[str, str]:
        """Tie-break within a rule: non-straggler first, then shallowest
        scheduler queue, then most free nodes, then registry order (strict
        < keeps the scan stable)."""
        best = cands[0]
        for e in cands[1:]:
            if self._load_key(e) < self._load_key(best):
                best = e
        slow, qd, neg_free = self._load_key(best)
        detail = f"queue_depth={qd},free_nodes={-neg_free}"
        if slow:
            detail += ",slow=1"
        return best, detail

    def _record(self, model: str, ep: str, rule: str, detail: str,
                qos: str | None, role: str | None = None) -> str:
        parts = [detail] if detail else []
        if qos:
            parts.append(f"qos={qos}")
        if role:
            parts.append(f"role={role}")
        self.decisions.append((model, ep, rule, ",".join(parts)))
        return ep

    # -- the §4.5 algorithm ---------------------------------------------------------
    def select_endpoint(self, model: str, exclude=(),
                        qos: str | None = None,
                        role: str | None = None) -> str:
        """``role``: None for a fresh dispatch (needs prefill capability),
        'decode' when placing the decode leg of a prefill->decode
        handoff."""
        eps = self._candidates(model)
        if exclude:
            eps = [e for e in eps if e not in exclude] or eps
        eps = self._filter_roles(eps, model, role)
        # rule 1: model already running or queued somewhere; ties broken
        # by cluster load (queue depth, then free nodes)
        active = [e for e in eps
                  if any(s in ("running", "starting", "queued")
                         for s in self.endpoints[e].model_states(model))]
        if active:
            if qos == "interactive":
                # TTFT-sensitive traffic prefers a WARM pool: a merely
                # starting/queued instance still costs the cold-start tail
                warm = [e for e in active if self._warm(e, model)]
                if warm and len(warm) < len(active):
                    pick, detail = self._pick(warm)
                    return self._record(model, pick, "active-instance",
                                        detail + ",warm=1", qos, role)
            pick, detail = self._pick(active)
            return self._record(model, pick, "active-instance", detail,
                                qos, role)
        # rule 2: a cluster with available nodes, same tie-break —
        # interactive requests first narrow to the cheapest cold start
        # (startup + cost.load_time), which every rule-2 placement pays
        free = []
        for e in eps:
            ep = self.endpoints[e]
            need = ep.deployments[model].nodes_per_instance
            if ep.scheduler.available_nodes() >= need:
                free.append(e)
        if free:
            if qos == "interactive" and len(free) > 1:
                best = min(self._cold_penalty(e, model) for e in free)
                free = [e for e in free
                        if self._cold_penalty(e, model) <= best + 1e-9]
            pick, detail = self._pick(free)
            if qos == "interactive":
                detail += (f",cold_penalty="
                           f"{self._cold_penalty(pick, model):.0f}s")
            return self._record(model, pick, "free-nodes", detail, qos,
                                role)
        # rule 3: first configured endpoint
        return self._record(model, eps[0], "configured-order", "", qos, role)

    # -- /jobs view across the federation -----------------------------------------
    def jobs_status(self) -> dict:
        """Per-model instance states, each entry annotated with the
        tie-break signals the §4.5 selection actually uses (cluster queue
        depth / free nodes) plus the endpoint's health flag."""
        out = {}
        for model, eps in self.registry.items():
            entries = []
            for e in eps:
                if e in self.endpoints:
                    ep = self.endpoints[e]
                    _slow, qd, neg_free = self._load_key(e)
                    for s in ep.model_states(model):
                        entries.append({"endpoint": e, "state": s,
                                        "healthy": self._healthy.get(e,
                                                                     False),
                                        "queue_depth": qd,
                                        "free_nodes": -neg_free,
                                        "load": ep.load_for(model)})
            if not entries:
                # cold model: same shape as live entries (consumers index
                # these keys unconditionally), zeros where nothing runs
                e0 = eps[0] if eps else "?"
                if e0 in self.endpoints:
                    _slow, qd, neg_free = self._load_key(e0)
                else:
                    qd, neg_free = 0, 0
                entries = [{"endpoint": e0, "state": "cold",
                            "healthy": self._healthy.get(e0, False),
                            "queue_depth": qd, "free_nodes": -neg_free,
                            "load": 0}]
            out[model] = entries
        return out
