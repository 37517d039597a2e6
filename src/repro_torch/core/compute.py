"""Globus-Compute analogue: a FaaS layer between the gateway and clusters.

* ``ComputeEndpoint`` runs at a cluster: it executes ONLY pre-registered
  functions (paper §3.2.2 security), acquires nodes through the cluster's
  scheduler, manages model instances (cold start, hot nodes, auto-scaling,
  restart-on-failure) and distributes tasks across instances.
* ``ComputeClient`` is the cloud service: it relays tasks to endpoints and
  results back, with a network hop each way, a connection cache
  (paper Optimization 2), and futures instead of polling (Optimization 1).

A copy of the JAX package's ``repro/core/compute.py``, unchanged in
behaviour.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.api import schemas
from repro_torch.api.errors import RequestCancelled
from repro_torch.core.autoscale import AutoScaler, AutoScalePolicy
from repro_torch.core.clock import Future
from repro_torch.core.instances import InstanceState, ModelInstance, SimRequest
from repro_torch.serving.costmodel import InstanceCost


class ComputeError(Exception):
    pass


class StreamChannel:
    """The gateway's live back-channel for one task (the DES analogue of a
    held-open SSE connection): first-token notifications and incremental
    ``StreamDelta`` frames ride it back with one network-hop latency each,
    independent of the task's completion future."""

    def __init__(self, loop, latency: float, on_first_token=None,
                 on_delta=None):
        self.loop = loop
        self.latency = latency
        self.on_first_token = on_first_token
        self.on_delta = on_delta
        self._idx = 0

    def first_token(self, request_id: str, t: float):
        if self.on_first_token is not None:
            self.loop.call_after(self.latency, self.on_first_token,
                                 request_id, t)

    def delta(self, request_id: str, n_tokens: int, t: float,
              offset: int = 0, finished: bool = False,
              finish_reason: str = ""):
        if self.on_delta is None:
            return
        frame = schemas.StreamDelta(id=request_id, index=self._idx,
                                    n_tokens=n_tokens, offset=offset,
                                    created=t, finished=finished,
                                    finish_reason=finish_reason)
        self._idx += 1
        self.loop.call_after(self.latency, self.on_delta, frame)


@dataclass
class ModelDeployment:
    """Admin configuration of one model on one endpoint."""
    model: str
    cost: InstanceCost
    # disaggregated serving role: 'prefill-heavy' instances ingest prompts
    # and emit first tokens only, then hand sequences to a 'decode-heavy'
    # (or unified) pool elsewhere in the federation; 'unified' does both
    role: str = "unified"
    nodes_per_instance: int = 1
    model_shards: int = 1                  # TP width per instance (must match
    #                                        cost.model_shards; the real
    #                                        engine's EngineConfig.mesh mirror)
    max_slots: int = 48                    # max parallel tasks within a node
    idle_timeout: float = 7200.0           # paper: release after 2 h idle
    autoscale: AutoScalePolicy = field(default_factory=AutoScalePolicy)
    walltime: float | None = None
    result_cpu: float = 0.0                # per-instance result serialization
    # engine data-plane toggles (see repro_torch.core.instances.SimEngine)
    prefix_cache_hit_rate: float = 0.0     # warm-cache shared-prefix fraction
    chunked_prefill_budget: int | None = None  # prompt tokens per engine step
    decode_steps_per_sync: int = 1         # fused decode tokens per host sync
    spec_tokens: int = 0                   # draft tokens per speculative round
    spec_accept_rate: float = 0.8          # steady-state draft acceptance
    draft_cost: InstanceCost | None = None  # draft model (required for spec)
    # QoS scheduling mirror (see repro_torch.serving.scheduler)
    scheduling_policy: str = "fcfs"        # fcfs | priority | edf
    enable_preemption: bool = False        # evict batch for blocked urgent
    restore_hit_rate: float = 1.0          # prefix-cache share of a restore


class ComputeEndpoint:
    def __init__(self, loop, endpoint_id: str, scheduler,
                 deployments: dict[str, ModelDeployment],
                 heartbeat_interval: float = 5.0,
                 heartbeat_latency: float = 0.05):
        self.loop = loop
        self.endpoint_id = endpoint_id
        self.scheduler = scheduler
        self.deployments = deployments
        for m, d in deployments.items():
            if d.role not in ("unified", "prefill-heavy", "decode-heavy"):
                raise ValueError(f"unknown role {d.role!r} for {m!r} "
                                 f"on {endpoint_id}")
        self.instances: dict[str, list[ModelInstance]] = \
            {m: [] for m in deployments}
        self._functions: dict[str, object] = {}
        # request_id -> (model, sreq, fut, channel) while a task is here
        self._inflight: dict[str, tuple] = {}
        # request_id -> decode endpoint, after a prefill->decode handoff
        # moved the task there (aborts forward through this)
        self._handoffs: dict[str, ComputeEndpoint] = {}
        self._router = None           # federation, for handoff targeting
        self._autoscalers = {m: AutoScaler(loop, d.autoscale)
                             for m, d in deployments.items()}
        self.stats = {"tasks": 0, "restarts": 0, "requeued": 0,
                      "aborted": 0, "crashes": 0, "recoveries": 0,
                      "scale_ins": 0, "handoffs_out": 0, "handoffs_in": 0,
                      "handoff_fallbacks": 0}
        self.register_function("generate", self._fn_generate)
        self.register_function("embed", self._fn_embed)
        self.register_function("abort", self._fn_abort)
        self.autoscale_interval = 5.0
        # liveness: the endpoint process itself (not its instances). While
        # down it stops heartbeating, rejects work and drops events.
        self.up = True
        self.heartbeat_interval = heartbeat_interval
        self.heartbeat_latency = heartbeat_latency
        self._monitor = None
        self._hb_suppress_until = 0.0     # heartbeat-loss injection window
        self._slow_until = 0.0            # latency injection window ...
        self._slow_extra = 0.0            # ... and its added beat latency
        self._autoscale_tick()

    # -- security: pre-registered functions only ---------------------------------
    def register_function(self, name: str, fn):
        self._functions[name] = fn

    def execute(self, fn_name: str, payload: dict,
                channel: StreamChannel | None = None) -> Future:
        if not self.up:
            fut = Future()
            fut.set_error(ComputeError(
                f"endpoint {self.endpoint_id} is unreachable"))
            return fut
        fn = self._functions.get(fn_name)
        if fn is None:
            fut = Future()
            fut.set_error(ComputeError(
                f"function {fn_name!r} is not registered on {self.endpoint_id}"))
            return fut
        self.stats["tasks"] += 1
        return fn(payload, channel)

    # -- liveness: heartbeats + crash/recover ------------------------------------
    def attach_monitor(self, monitor) -> None:
        """Start emitting heartbeats to a ``HealthMonitor``. Each beat rides
        to the monitor with ``heartbeat_latency`` (plus any injected extra),
        so the monitor OBSERVES liveness and latency instead of being told."""
        self._monitor = monitor
        self._heartbeat_tick()

    def _heartbeat_tick(self):
        if self._monitor is None:
            return
        now = self.loop.now()
        if self.up and now >= self._hb_suppress_until:
            lat = self.heartbeat_latency
            if now < self._slow_until:
                lat += self._slow_extra
            self.loop.call_after(lat, self._monitor.on_beat,
                                 self.endpoint_id, now, daemon=True)
        self.loop.call_after(self.heartbeat_interval, self._heartbeat_tick,
                             daemon=True)

    def suppress_heartbeats(self, duration: float) -> None:
        """Heartbeat-loss injection: the endpoint stays up and keeps serving
        but its beats vanish — the detector must (wrongly) mark it down and
        recover it from the first beat after the window."""
        self._hb_suppress_until = max(self._hb_suppress_until,
                                      self.loop.now() + duration)

    def inject_latency(self, duration: float, extra: float) -> None:
        """Straggler injection: beats (and only beats — the detector's view)
        arrive ``extra`` seconds late for ``duration``."""
        self._slow_until = max(self._slow_until, self.loop.now() + duration)
        self._slow_extra = extra

    def crash(self, duration: float | None = None, silent: bool = False):
        """The endpoint process dies: heartbeats stop, new work is rejected,
        every in-flight task errors with a retryable ``ComputeError`` (or is
        silently dropped when ``silent`` — the caller's per-attempt timeout
        must catch that), instances are torn down WITHOUT local requeue (the
        gateway's retry layer re-routes), and their nodes are released.
        ``duration`` schedules ``recover`` automatically."""
        if not self.up:
            return
        self.up = False
        self.stats["crashes"] += 1
        inflight = list(self._inflight.values())
        self._inflight.clear()
        for model in self.instances:
            for inst in list(self.instances[model]):
                if inst.alive:
                    inst.fail()      # requeue no-ops: _inflight is cleared
            self.instances[model] = []
        # requests already handed to a decode endpoint keep running there;
        # only the abort-forwarding breadcrumbs die with this process
        self._handoffs.clear()
        if not silent:
            for _model, sreq, fut, _chan in inflight:
                if not fut.done():
                    fut.set_error(ComputeError(
                        f"endpoint {self.endpoint_id} crashed with "
                        f"{sreq.request_id} in flight"))
        if duration is not None:
            self.loop.call_after(duration, self.recover, daemon=True)

    def recover(self):
        if self.up:
            return
        self.up = True
        self.stats["recoveries"] += 1

    # -- status (for /jobs and federation) -----------------------------------------
    def model_states(self, model: str) -> list[str]:
        return [i.state.value for i in self.instances.get(model, [])
                if i.alive]

    def hosts(self, model: str) -> bool:
        return model in self.deployments

    def load_for(self, model: str) -> int:
        return sum(i.load for i in self.instances.get(model, []) if i.alive)

    # -- handlers --------------------------------------------------------------------
    def _fn_generate(self, payload: dict,
                     channel: StreamChannel | None = None) -> Future:
        fut = Future()
        req = schemas.from_wire(payload)     # typed /v1 request off the wire
        model = req.model
        if model not in self.deployments:
            fut.set_error(ComputeError(
                f"model {model!r} not deployed on {self.endpoint_id}"))
            return fut
        sreq = SimRequest(request_id=req.request_id,
                          prompt_tokens=req.prompt_token_count,
                          max_tokens=int(req.max_tokens),
                          user=req.user or "anonymous",
                          qos=req.qos,
                          priority=req.priority,
                          deadline=req.deadline,
                          stream=bool(req.stream),
                          resume_tokens=int(getattr(req, "resume_tokens",
                                                    0) or 0))
        self._inflight[sreq.request_id] = (model, sreq, fut, channel)
        self._dispatch(model, sreq, fut, channel)
        return fut

    def _fn_embed(self, payload: dict,
                  channel: StreamChannel | None = None) -> Future:
        """Embeddings are one-step tasks: modeled as generate with exactly
        ONE output token. The clamp lives at the pre-registered function
        (not only in schema validation) so any wire payload routed to
        'embed' is costed and slotted as an embedding, never as a full
        generation."""
        payload = dict(payload)
        if isinstance(payload.get("data"), dict):   # version-tagged envelope
            payload["data"] = dict(payload["data"], max_tokens=1)
        else:                                       # legacy untagged dict
            payload["max_tokens"] = 1
        return self._fn_generate(payload, channel)

    def _fn_abort(self, payload: dict,
                  channel: StreamChannel | None = None) -> Future:
        """Pre-registered cancellation: a client disconnect (or a losing
        hedge) propagates here and frees the engine slot immediately."""
        fut = Future()
        rid = payload.get("request_id", "")
        entry = self._inflight.pop(rid, None)
        if entry is None:
            # the sequence may have moved to a decode endpoint: forward
            target = self._handoffs.pop(rid, None)
            if target is not None and target.up:
                return target.execute("abort", payload)
            # already finished (or unknown)
            fut.set_result({"request_id": rid, "aborted": False})
            return fut
        model, sreq, task_fut, _chan = entry
        for inst in self.instances.get(model, []):
            if inst.alive and inst.abort(rid):
                break
        self.stats["aborted"] += 1
        if not task_fut.done():
            task_fut.set_error(RequestCancelled(
                f"request {rid} aborted on {self.endpoint_id}"))
        fut.set_result({"request_id": rid, "aborted": True})
        return fut

    # -- instance management ------------------------------------------------------
    def _autoscale_tick(self):
        """Periodic policy pass: hot-pool floor maintenance, demand
        scale-up, keepalive scale-in, then queue balancing. Scaling must
        also react while requests sit queued on saturated/loading
        instances (not only at dispatch time)."""
        for model in self.deployments:
            scaler = self._autoscalers[model]
            dep = self.deployments[model]
            # pinned floor: keep min_hot instances provisioned even with
            # zero demand, as far as the cluster's free nodes allow
            deficit = scaler.pool_deficit(
                model, self._alive_instances(model),
                self.scheduler.available_nodes(), dep.nodes_per_instance)
            for _ in range(deficit):
                self._spawn_instance(model)
            alive = self._alive_instances(model)
            if not alive:
                continue
            if scaler.should_scale_up(model, alive,
                                      self.scheduler.available_nodes(),
                                      dep.nodes_per_instance):
                self._spawn_instance(model)
            victim = scaler.pick_scale_in(model,
                                          self._alive_instances(model))
            if victim is not None:
                scaler.record_scale_in(
                    model, len(self._alive_instances(model)) - 1)
                self.stats["scale_ins"] += 1
                victim.release()       # idle: nothing to requeue
            self._balance_queues(model)
        self.loop.call_after(self.autoscale_interval, self._autoscale_tick,
                             daemon=True)

    def _on_instance_hot(self, inst: ModelInstance):
        self._balance_queues(inst.model_name)

    def _balance_queues(self, model: str):
        """Work stealing across HOT instances: queued work never sits on one
        saturated engine while another has spare capacity. (Work is never
        parked on cold instances — that would stall it for the whole cold
        start; cold instances pull work here once they turn hot.)"""
        hot = [i for i in self._alive_instances(model)
               if i.state == InstanceState.HOT]
        if len(hot) < 2 or not any(i.engine.queue_depth for i in hot):
            return
        entries = []
        for i in hot:
            # take_queued pops the robbed engine's _seq_of alongside its
            # queue (the receiver's submit re-issues arrival orders) —
            # clearing the queue alone leaks one map entry per steal
            entries.extend(i.engine.take_queued())
        for e in entries:               # round-robin by current effective load
            target = min(hot, key=lambda i: i.engine.load)
            target.engine.submit(*e)

    def _alive_instances(self, model: str) -> list[ModelInstance]:
        return [i for i in self.instances[model] if i.alive]

    def _spawn_instance(self, model: str) -> ModelInstance:
        dep = self.deployments[model]
        # with a pool keepalive configured, the POOL owns scale-in: the
        # instance's own flat idle timer is disabled
        idle_timeout = (None if dep.autoscale.keepalive is not None
                        else dep.idle_timeout)
        on_handoff = None
        if dep.role == "prefill-heavy":
            def on_handoff(sreq, produced, _m=model):
                return self._start_handoff(_m, sreq, produced)
        inst = ModelInstance(
            self.loop, model, dep.cost, self.scheduler,
            num_nodes=dep.nodes_per_instance, max_slots=dep.max_slots,
            idle_timeout=idle_timeout, walltime=dep.walltime,
            result_cpu=dep.result_cpu,
            role=dep.role, on_handoff=on_handoff,
            prefix_cache_hit_rate=dep.prefix_cache_hit_rate,
            chunked_prefill_budget=dep.chunked_prefill_budget,
            decode_steps_per_sync=dep.decode_steps_per_sync,
            spec_tokens=dep.spec_tokens,
            spec_accept_rate=dep.spec_accept_rate,
            draft_cost=dep.draft_cost,
            scheduling_policy=dep.scheduling_policy,
            enable_preemption=dep.enable_preemption,
            restore_hit_rate=dep.restore_hit_rate,
            on_released=self._on_instance_gone,
            on_failed=self._on_instance_failed,
            on_hot=self._on_instance_hot)
        self.instances[model].append(inst)
        # every spawn path stamps the scale: the cooldown window starts at
        # the spawn (cold starts in _dispatch included, which otherwise
        # let the next tick double-spawn behind them) and scale_events
        # records the first instance too
        self._autoscalers[model].record_scale(
            model, len(self._alive_instances(model)))
        return inst

    def _dispatch(self, model: str, sreq: SimRequest, fut: Future,
                  channel: StreamChannel | None = None):
        alive = self._alive_instances(model)
        if not alive:
            inst = self._spawn_instance(model)
        else:
            # least-loaded HOT instance; cold instances receive work only by
            # stealing once hot (or if nothing is hot yet)
            hot = [i for i in alive if i.state == InstanceState.HOT]
            pool = hot or alive
            inst = min(pool, key=lambda i: i.load)
            scaler = self._autoscalers[model]
            dep = self.deployments[model]
            if scaler.should_scale_up(model, alive,
                                      self.scheduler.available_nodes(),
                                      dep.nodes_per_instance):
                self._spawn_instance(model)

        first_holder = {}

        def on_first(t):
            first_holder["t"] = t
            sreq.first_token_at = t
            if channel is not None:
                channel.first_token(sreq.request_id, t)

        def on_done(result):
            self._inflight.pop(sreq.request_id, None)
            result = dict(result)
            # a resumed/handed-off request never re-fires on_first here:
            # its TTFT is the original first token the source stamped
            ft = first_holder.get("t", sreq.first_token_at)
            result["first_token_time"] = (ft if ft is not None
                                          else result["finish_time"])
            result["endpoint"] = self.endpoint_id
            if channel is not None and sreq.stream:
                channel.delta(sreq.request_id, 0, result["finish_time"],
                              offset=result.get("output_tokens", 0),
                              finished=True, finish_reason="length")
            if not fut.done():               # aborted tasks already errored
                fut.set_result(result)

        on_delta = None
        if channel is not None and sreq.stream:
            def on_delta(n, t, offset=0):
                channel.delta(sreq.request_id, n, t, offset=offset)

        inst.submit(sreq, on_first, on_done, on_delta)

    # -- disaggregated prefill/decode handoff ---------------------------------------
    def attach_federation(self, router) -> None:
        """Give the endpoint the federation router so prefill-role engines
        can target decode pools across clusters (testbed wiring)."""
        self._router = router

    def _start_handoff(self, model: str, sreq: SimRequest,
                       produced: int) -> bool:
        """Engine callback at the prefill/decode boundary: the sequence's
        prompt is ingested and its first token(s) streamed. Pick a
        decode-capable endpoint and move the sequence there, charging the
        KV-transfer hop. Returns False to keep decoding locally (unified
        fallback) when nothing can take it."""
        if self._router is None or sreq.request_id not in self._inflight:
            return False
        target = self._pick_decode_target(model, sreq)
        if target is None:
            self.stats["handoff_fallbacks"] += 1
            sreq.no_handoff = True
            return False
        self.stats["handoffs_out"] += 1
        dep = self.deployments[model]
        # the sequence's KV pages cross the inter-instance link; the
        # receiver then charges its restore prefill via resume admission.
        # The entry stays in _inflight during the hop so aborts/crashes
        # in the window resolve here and the delivery becomes a no-op.
        hop = dep.cost.handoff_time(sreq.prompt_tokens + produced)
        self.loop.call_after(hop, self._deliver_handoff, model, sreq, target)
        return True

    def _pick_decode_target(self, model: str, sreq: SimRequest):
        try:
            ep_id = self._router.select_endpoint(
                model, exclude=(self.endpoint_id,), qos=sreq.qos,
                role="decode")
        except Exception:              # noqa: BLE001 — no healthy target
            return None
        target = self._router.endpoints.get(ep_id)
        if target is None or target is self or not target.up:
            return None
        return target

    def _deliver_handoff(self, model: str, sreq: SimRequest, target):
        entry = self._inflight.pop(sreq.request_id, None)
        if entry is None:              # aborted / crashed mid-transfer
            return
        _, _, fut, channel = entry
        if fut.done():
            return
        if not target.up:
            # the decode target died mid-hop: the KV is still here, so
            # decode locally; no_handoff stops the engine from re-offering
            sreq.no_handoff = True
            self.stats["handoff_fallbacks"] += 1
            self._inflight[sreq.request_id] = entry
            self._dispatch(model, sreq, fut, channel)
            return
        self._handoffs[sreq.request_id] = target
        fut.add_done_callback(
            lambda _f, rid=sreq.request_id: self._handoffs.pop(rid, None))
        target.receive_handoff(model, sreq, fut, channel)

    def receive_handoff(self, model: str, sreq: SimRequest, fut: Future,
                        channel: StreamChannel | None) -> None:
        """Decode side of a prefill->decode handoff: adopt the in-flight
        entry (this endpoint's crash/requeue machinery covers it now) and
        admit via the resume path — a restore prefill of (prompt +
        produced), then decode continues from ``resume_tokens`` with
        contiguous stream offsets."""
        self.stats["handoffs_in"] += 1
        self._inflight[sreq.request_id] = (model, sreq, fut, channel)
        self._dispatch(model, sreq, fut, channel)

    # -- fault tolerance ------------------------------------------------------------
    def _on_instance_gone(self, inst: ModelInstance, inflight):
        self.instances[inst.model_name] = \
            [i for i in self.instances[inst.model_name] if i is not inst]
        self._requeue(inst.model_name, inflight)

    def _on_instance_failed(self, inst: ModelInstance, inflight):
        """Process-management restart (paper §3.2.2 fault tolerance): drop the
        failed instance and resubmit its in-flight requests; tasks resume
        from their last produced token (``SimRequest.resume_tokens``, stamped
        by ``SimEngine.halt``) so re-execution never regenerates — and never
        re-delivers — tokens the client already received."""
        if not self.up:              # endpoint-level crash: no local restart
            self.instances[inst.model_name] = \
                [i for i in self.instances[inst.model_name] if i is not inst]
            return
        self.stats["restarts"] += 1
        self._on_instance_gone(inst, inflight)

    def _requeue(self, model: str, inflight):
        for sreq in inflight:
            entry = self._inflight.get(sreq.request_id)
            if entry is None:
                continue
            self.stats["requeued"] += 1
            _, sreq, fut, channel = entry
            self.loop.call_after(0.0, self._dispatch, model, sreq, fut,
                                 channel)


class _Relay:
    """Serialized relay capacity of the cloud FaaS service: each task consumes
    ``cpu`` seconds on one of ``workers`` relay workers (both directions).
    Models the paper's §5.3.2 observation that overall scaling 'is currently
    limited by the ability of Globus Compute to scale and route requests'."""

    def __init__(self, loop, workers: int, cpu: float):
        self.loop = loop
        self.workers = workers
        self.cpu = cpu
        self.busy = 0
        self.queue: list = []

    def submit(self, fn):
        self.queue.append(fn)
        self._pump()

    def _pump(self):
        while self.busy < self.workers and self.queue:
            fn = self.queue.pop(0)
            self.busy += 1

            def _run(fn=fn):
                self.busy -= 1
                fn()
                self._pump()

            self.loop.call_after(self.cpu, _run)


class ComputeClient:
    """The cloud FaaS service: gateway -> (hop) -> endpoint -> (hop) -> gateway."""

    def __init__(self, loop, dispatch_latency: float = 0.15,
                 result_latency: float = 0.15,
                 connection_setup: float = 1.5,
                 connection_cache: bool = True,
                 relay_workers: int | None = None,
                 relay_cpu: float = 0.02):
        self.loop = loop
        self.dispatch_latency = dispatch_latency
        self.result_latency = result_latency
        self.connection_setup = connection_setup
        self.connection_cache = connection_cache
        self.relay = (_Relay(loop, relay_workers, relay_cpu)
                      if relay_workers else None)
        self._endpoints: dict[str, ComputeEndpoint] = {}
        self._connected: set[str] = set()
        self.tasks_in_cloud = 0
        self.max_tasks_in_cloud = 0

    def register_endpoint(self, endpoint: ComputeEndpoint):
        self._endpoints[endpoint.endpoint_id] = endpoint

    @property
    def endpoints(self) -> dict[str, ComputeEndpoint]:
        return self._endpoints

    def submit(self, endpoint_id: str, fn_name: str, payload: dict,
               on_first_token=None, on_delta=None) -> Future:
        """``on_first_token(request_id, t)`` / ``on_delta(StreamDelta)``:
        optional live back-channel callbacks; events ride back with one
        ``result_latency`` hop each, ahead of the completion future."""
        fut = Future()
        ep = self._endpoints.get(endpoint_id)
        if ep is None:
            fut.set_error(ComputeError(f"unknown endpoint {endpoint_id!r}"))
            return fut
        channel = None
        if on_first_token is not None or on_delta is not None:
            channel = StreamChannel(self.loop, self.result_latency,
                                    on_first_token, on_delta)
        hop = self.dispatch_latency
        if endpoint_id not in self._connected or not self.connection_cache:
            hop += self.connection_setup       # Optimization 2: cache this
            if self.connection_cache:
                self._connected.add(endpoint_id)
        self.tasks_in_cloud += 1
        self.max_tasks_in_cloud = max(self.max_tasks_in_cloud,
                                      self.tasks_in_cloud)

        def _deliver():
            inner = ep.execute(fn_name, payload, channel)

            def _back(f):
                def _resolve():
                    self.tasks_in_cloud -= 1
                    inner.chain(fut)

                def _hop_back():
                    self.loop.call_after(self.result_latency, _resolve)

                if self.relay is not None:
                    self.relay.submit(_hop_back)     # result leg also relays
                else:
                    _hop_back()

            inner.add_done_callback(_back)

        def _hop_out():
            self.loop.call_after(hop, _deliver)

        if self.relay is not None:
            self.relay.submit(_hop_out)
        else:
            _hop_out()
        return fut

    def cancel(self, endpoint_id: str, request_id: str) -> Future:
        """Propagate a client disconnect (or losing hedge) to the endpoint's
        pre-registered 'abort' function — one dispatch hop away."""
        fut = Future()
        ep = self._endpoints.get(endpoint_id)
        if ep is None:
            fut.set_error(ComputeError(f"unknown endpoint {endpoint_id!r}"))
            return fut

        def _deliver():
            ep.execute("abort", schemas.abort_wire(request_id)).chain(fut)

        self.loop.call_after(self.dispatch_latency, _deliver)
        return fut
