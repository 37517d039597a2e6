"""The port's control plane (``repro_torch.core``) against the JAX
package's (``repro.core``).

Each scenario mirrors one of the reference's DES tests (``test_core.py``,
``test_chaos.py``, ``test_hot_pool.py``, ``test_streaming.py`` and the
SimEngine toggles of the serving tests) and runs it in both packages in one
process. Before each run the module-level id counters of both packages are
reset, and both get the reference's cost constants (``default_deployment(hw=
...)`` or ``InstanceCost(...)``; the port's ``COLLECTIVE_LAUNCH`` is patched
to the reference's, since it is read at call time). The two traces --
every ``RequestRecord`` field, ``metrics.summary()``, ``router.decisions``,
each endpoint's instances, counters and autoscaler events, ``/jobs``, error
codes, HTTP statuses and ``retry_after``, stream frames, batch objects (in
wire form and field by field) and the final virtual time -- must be EXACTLY
equal: both packages do the same float arithmetic in the same order.
"""
import dataclasses
import enum
import importlib
import itertools
import math
import pathlib
import sys
import types

import pytest

import repro.serving.costmodel as ref_cost

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402  (the repo root, for phase 9c's scenario)

# the reference's constants, passed to both packages' InstanceCost
REF_HW = dict(peak_flops=ref_cost.PEAK_FLOPS, hbm_bw=ref_cost.HBM_BW,
              step_overhead=ref_cost.STEP_OVERHEAD,
              dispatch_overhead=ref_cost.DISPATCH_OVERHEAD,
              host_io_bw=ref_cost.HOST_IO_BW, ici_bw=ref_cost.ICI_BW,
              kv_transfer_bw=ref_cost.KV_TRANSFER_BW,
              handoff_overhead=ref_cost.HANDOFF_OVERHEAD)

# module-level id counters and their first values
COUNTERS = (("core.auth", "_tok_counter", 0), ("core.batch", "_batch_ids", 1),
            ("core.instances", "_inst_ids", 1),
            ("core.scheduler", "_job_ids", 1))


def _pkg(root):
    def m(name):
        return importlib.import_module(f"{root}.{name}")
    P = types.SimpleNamespace(
        root=root, core=m("core"), tb=m("core.testbed"), clock=m("core.clock"),
        inst=m("core.instances"), res=m("core.resilience"),
        gw=m("core.gateway"), auth=m("core.auth"), faults=m("core.faults"),
        cost=m("serving.costmodel"), api=m("api"), errors=m("api.errors"),
        schemas=m("api.schemas"), wl=m("data.workload"),
        configs=m("configs"))
    P.L70, P.L8 = P.tb.LLAMA70B, P.tb.LLAMA8B
    P.M70 = P.L70.name
    P.dep = lambda cfg, **kw: P.tb.default_deployment(cfg, hw=REF_HW, **kw)
    P.icost = lambda cfg, **kw: P.cost.InstanceCost(cfg=cfg, **REF_HW, **kw)
    return P


# ---------------------------------------------------------------------------
# traces: everything observable, in plain data
# ---------------------------------------------------------------------------

def canon(x):
    """Plain, comparable data: NaN as a string, enums by value, typed /v1
    objects in wire form AND field by field, errors by class, code,
    status, retry_after and message."""
    if isinstance(x, float):
        return "nan" if math.isnan(x) else x
    if isinstance(x, enum.Enum):
        return x.value
    if isinstance(x, BaseException):
        return {"error": type(x).__name__, "message": str(x),
                **{a: canon(getattr(x, a)) for a in
                   ("code", "status", "retry_after", "param")
                   if hasattr(x, a)},
                **({"wire": canon(x.to_dict())}
                   if hasattr(x, "to_dict") else {})}
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        out = {"type": type(x).__name__,
               "fields": canon({f.name: getattr(x, f.name)
                                for f in dataclasses.fields(x)})}
        if hasattr(x, "to_dict"):
            out["wire"] = canon(x.to_dict())
        return out
    if isinstance(x, dict):
        return {str(k): canon(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [canon(v) for v in x]
    if isinstance(x, (set, frozenset)):
        return sorted(canon(v) for v in x)
    return x


def fut_trace(f):
    if not f.done():
        return {"done": False}
    if f.error is not None:
        return {"done": True, "error": f.error}
    return {"done": True, "result": f.result()}


def engine_trace(eng):
    return {k: v for k, v in sorted(vars(eng).items())
            if k.startswith("total_")}


def endpoint_trace(ep):
    return {
        "up": ep.up, "stats": ep.stats,
        "instances": {m: [{"id": i.instance_id, "state": i.state,
                           "created": i.created, "hot_since": i.hot_since,
                           "idle_since": i.idle_since,
                           "engine": engine_trace(i.engine)}
                          for i in insts]
                      for m, insts in ep.instances.items()},
        "scale_events": {m: (a.scale_events, a.scale_in_events)
                         for m, a in ep._autoscalers.items()}}


def system_trace(sysd, **extra):
    return {
        "records": sysd.metrics.records, "summary": sysd.metrics.summary(),
        "decisions": sysd.router.decisions,
        "jobs": sysd.gateway.jobs_status(),
        "endpoints": {e: endpoint_trace(ep)
                      for e, ep in sysd.endpoints.items()},
        "schedulers": {c: s.status() for c, s in sysd.schedulers.items()},
        "health": sysd.health.transitions,
        "auth": (sysd.auth_service.introspections, sysd.auth.hits,
                 sysd.auth.misses),
        "tokens": sysd.tokens, "now": sysd.loop.now(), **extra}


def _hot(P, sysd, endpoint_id, model, settle=120.0):
    sysd.endpoints[endpoint_id]._spawn_instance(model)
    sysd.loop.run_until(sysd.loop.now() + settle)


def _one(P, **dep):
    """The testbed's default deployment (llama3.3-70b on sophia), with the
    reference's constants."""
    return {"sophia": {P.M70: P.dep(P.L70, **dep)}}


def _two(P, cfg=None, gw=None, dep=None, **kw):
    cfg = cfg or P.L70
    deps = {c: {cfg.name: P.dep(cfg, **(dep or {}))}
            for c in ("sophia", "polaris")}
    return P.tb.build_system(
        deps, gateway_config=P.gw.GatewayConfig(**(gw or {})), **kw)


# ---------------------------------------------------------------------------
# scenarios: each takes a package namespace and returns its trace
# ---------------------------------------------------------------------------

def s_auth(P):
    """test_core: token lifecycle, the introspection cache, coalescing of a
    burst, a bad token, RBAC."""
    loop = P.clock.EventLoop()
    svc = P.auth.AuthService(loop, introspection_latency=2.0,
                             rate_limit_per_s=10)
    svc.add_user("alice", groups=("users",))
    svc.add_user("eve", groups=("insiders",))
    tok, tok_e = svc.issue_token("alice"), svc.issue_token("eve")
    client = P.auth.CachingAuthClient(loop, svc)
    out = []
    client.validate(tok, out.append)
    loop.run_until_idle()
    t_first = loop.now()
    for _ in range(200):
        client.validate(tok, out.append)
    client.validate("bogus", out.append)
    client.validate(tok_e, out.append)
    loop.run_until_idle()
    uncached = P.auth.CachingAuthClient(loop, svc, enabled=False)
    for _ in range(30):
        uncached.validate(tok, out.append)
    loop.run_until_idle()
    pol = P.auth.AccessPolicy(model_groups={"secret": "insiders"})
    ids = [o for o in out if isinstance(o, P.auth.Identity)]
    return {"out": [(o.user, o.groups) if isinstance(o, P.auth.Identity)
                    else o for o in out],
            "tokens": (tok, tok_e), "t_first": t_first, "now": loop.now(),
            "introspections": svc.introspections,
            "hits": (client.hits, client.misses, uncached.hits,
                     uncached.misses),
            "rbac": [pol.allowed(i, m) for i in ids[-2:]
                     for m in ("secret", "open")]}


def s_scheduler(P):
    """test_core: FIFO queue and release, node failure kills the job."""
    loop = P.clock.EventLoop()
    sched = P.core.ClusterScheduler(loop, "c", num_nodes=3,
                                    startup_delay=10.0)
    log = []
    j1 = sched.submit(2, on_start=lambda j: log.append(("start", j.job_id,
                                                        loop.now())),
                      on_end=lambda j: log.append(("end", j.job_id,
                                                   j.state)))
    j2 = sched.submit(2, on_start=lambda j: log.append(("start", j.job_id,
                                                        loop.now())))
    j3 = sched.submit(1, on_start=lambda j: log.append(("start", j.job_id,
                                                        loop.now())))
    loop.run_until_idle()
    st0 = sched.status()
    sched.release(j1)
    loop.run_until_idle()
    victim = j2.nodes[0]
    sched.fail_node(victim)
    st1 = (sched.status(), sched.available_nodes())
    sched.restore_node(victim)
    return {"log": log, "jobs": [(j.job_id, j.state, j.queue_wait, j.nodes)
                                 for j in (j1, j2, j3)],
            "status": (st0, st1, sched.status()),
            "available": sched.available_nodes(), "now": loop.now()}


def s_federation_rules(P):
    """test_core: the three selection rules (free nodes, active instance,
    configured order) and an unhealthy endpoint skipped; test_hot_pool: the
    role filter."""
    sysd = _two(P, nodes_per_cluster=4)
    picks = [sysd.router.select_endpoint(P.M70)]
    sysd.endpoints["polaris-ep"]._spawn_instance(P.M70)
    sysd.loop.run_until_idle()
    picks.append(sysd.router.select_endpoint(P.M70))
    for s in sysd.schedulers.values():
        while s.available_nodes():
            s.submit(1, on_start=lambda j: None)
    sysd.loop.run_until_idle()
    picks.append(sysd.router.select_endpoint(P.M70, qos="batch"))
    sysd.health.mark_down("polaris-ep")
    sysd.loop.run_until(sysd.loop.now() + 20.0)
    picks.append(sysd.router.select_endpoint(P.M70))
    picks.append(sysd.router.select_endpoint(P.M70, role="decode"))
    try:
        sysd.router.select_endpoint("no-such-model")
    except Exception as e:                 # noqa: BLE001 -- traced
        picks.append(e)
    return system_trace(sysd, picks=picks)


def s_gateway_validation(P):
    """test_core: validation, the per-user rate limit (retry_after), the
    response cache; test_streaming: rate-limit errors carry retry_after."""
    sysd = P.tb.build_system(_one(P), gateway_config=P.gw.GatewayConfig(
        rate_limit_per_user=1.0, rate_burst=2.0))
    P.tb.warm_up(sysd, P.M70)
    tok = sysd.token_for("alice")
    futs = [sysd.gateway.submit(tok, {"model": P.M70, "prompt_tokens": 8,
                                      "max_tokens": 2}) for _ in range(5)]
    futs.append(sysd.gateway.submit(tok, {"model": P.M70,
                                          "prompt_tokens": -1,
                                          "max_tokens": 0}))
    futs.append(sysd.gateway.submit(tok, {"model": "nope",
                                          "prompt_tokens": 8,
                                          "max_tokens": 2}))
    futs.append(sysd.gateway.submit("bad-token", {"model": P.M70,
                                                  "prompt_tokens": 8,
                                                  "max_tokens": 2}))
    sysd.loop.run_until_idle()
    sysd.loop.run_until(sysd.loop.now() + 30.0)
    bob = sysd.token_for("bob")
    req = {"model": P.M70, "prompt_tokens": 64, "max_tokens": 16,
           "prompt_hash": "same-prompt", "temperature": 0.0}
    for _ in range(2):
        futs.append(sysd.gateway.submit(bob, dict(req)))
        sysd.loop.run_until_idle()
    return system_trace(sysd, futs=[fut_trace(f) for f in futs],
                        cache_hits=sysd.gateway.cache.hits)


def s_optimizations(P):
    """test_core: the three paper optimizations, each toggled off, under a
    60-request workload."""
    variants = {
        "optimized": dict(gateway_config=P.gw.GatewayConfig()),
        "polling": dict(gateway_config=P.gw.GatewayConfig(
            poll_interval=2.0)),
        "no_auth_cache": dict(gateway_config=P.gw.GatewayConfig(),
                              auth_cache=False, connection_cache=False),
        "sync_workers": dict(gateway_config=P.gw.GatewayConfig(
            workers=9, blocking_workers=True))}
    out = {}
    for name, kw in variants.items():
        sysd = P.tb.build_system(_one(P), **kw)
        P.tb.warm_up(sysd, P.M70)
        s = P.tb.drive_workload(sysd, P.wl.make_workload(60, rate=4.0,
                                                         seed=7), P.M70)
        out[name] = system_trace(sysd, drive=s)
    return out


def s_autoscale(P):
    """test_core: autoscale to the cap under a burst, throughput against
    one instance."""
    out = {}
    for cap in (1, 3):
        sysd = P.tb.build_system(
            {"sophia": {P.M70: P.dep(P.L70, max_instances=cap,
                                     storage_bw=40e9, scale_cooldown=8.0)}},
            startup_delay=5.0)
        P.tb.warm_up(sysd, P.M70)
        s = P.tb.drive_workload(sysd, P.wl.make_workload(
            300, rate=float("inf"), seed=3), P.M70)
        out[cap] = system_trace(sysd, drive=s)
    return out


def s_hot_node_cold_start(P):
    """test_core: the cold-start pipeline's states, hot-node reuse, idle
    release."""
    sysd = P.tb.build_system({"sophia": {P.M70: P.dep(
        P.L70, idle_timeout=100.0)}})
    tok = sysd.token_for("alice")
    f1 = sysd.gateway.submit(tok, {"model": P.M70, "prompt_tokens": 16,
                                   "max_tokens": 4})
    sysd.loop.run_until(25.0)
    during = sysd.gateway.jobs_status()
    sysd.loop.run_until_idle()
    states = [sysd.endpoints["sophia-ep"].model_states(P.M70)]
    f2 = sysd.gateway.submit(tok, {"model": P.M70, "prompt_tokens": 16,
                                   "max_tokens": 4})
    sysd.loop.run_until_idle()
    jobs = len(sysd.schedulers["sophia"].jobs)
    sysd.loop.run_until(sysd.loop.now() + 200.0)
    states.append(sysd.endpoints["sophia-ep"].model_states(P.M70))
    return system_trace(sysd, during=during, states=states, jobs_n=jobs,
                        futs=[fut_trace(f) for f in (f1, f2)])


def s_batch(P):
    """test_core: a dedicated batch job; the /v1/batches surface through
    FirstClient (create, status while loading, results, a bad line)."""
    sysd = P.tb.build_system(_one(P))
    job = sysd.batch.submit_batch(P.M70, [
        {"request_id": f"b{i}", "prompt_tokens": 128, "max_tokens": 128}
        for i in range(120)])
    sysd.loop.run_until_idle()
    legacy = (sysd.batch.status(job.batch_id), job.submit_time,
              job.finish_time)
    client = P.api.FirstClient(sysd.gateway, sysd.token_for("alice"))
    items = [{"custom_id": f"c{i}", "method": "POST",
              "url": "/v1/completions",
              "body": {"model": P.M70, "prompt_tokens": 16 + 7 * i,
                       "max_tokens": 8 + 3 * i}} for i in range(40)]
    items.append({"custom_id": "bad", "method": "POST",
                  "url": "/v1/completions",
                  "body": {"model": P.M70, "prompt_tokens": -3,
                           "max_tokens": 4}})
    fut = client.create_batch(items)
    sysd.loop.run_until(sysd.loop.now() + 60.0)
    bid = fut.result().id
    loading = client.batch_status(bid)
    sysd.loop.run_until_idle()
    return system_trace(sysd, legacy=legacy, created=fut_trace(fut),
                        loading=loading, done=client.batch_status(bid),
                        results=client.batch_results(bid),
                        jobs_view=client.jobs())


def s_instance_node_failure(P):
    """test_core: instance failure requeues in-flight work; node failure
    recovers through a new job."""
    out = {}
    sysd = P.tb.build_system(_one(P))
    P.tb.warm_up(sysd, P.M70)
    ep = sysd.endpoints["sophia-ep"]
    sysd.faults.fail_instance_at(ep, P.M70, t=sysd.loop.now() + 3.0)
    out["instance"] = system_trace(sysd, drive=P.tb.drive_workload(
        sysd, P.wl.make_workload(40, rate=float("inf"), seed=5), P.M70))
    sysd = P.tb.build_system(_one(P))
    P.tb.warm_up(sysd, P.M70)
    sched = sysd.schedulers["sophia"]
    job = next(j for j in sched.jobs.values()
               if j.state == P.core.JobState.RUNNING)
    sysd.faults.fail_node_at(sched, job.nodes[0], t=sysd.loop.now() + 20.0,
                             restore_after=300.0)
    out["node"] = system_trace(sysd, drive=P.tb.drive_workload(
        sysd, P.wl.make_workload(30, rate=float("inf"), seed=6), P.M70))
    return out


def s_outage_and_hedging(P):
    """test_core: an endpoint outage fails over to the federated cluster;
    a hedged request beats a straggler, and without hedging it waits."""
    out = {}
    sysd = _two(P)
    P.tb.warm_up(sysd, P.M70)
    sysd.health.mark_down("sophia-ep")
    sysd.loop.run_until(sysd.loop.now() + 20.0)
    f = sysd.gateway.submit(sysd.token_for("alice"), {
        "model": P.M70, "prompt_tokens": 16, "max_tokens": 4})
    sysd.loop.run_until_idle()
    out["outage"] = system_trace(sysd, fut=fut_trace(f))
    for hedge in (10.0, None):
        sysd = _two(P, gw=dict(hedge_after=hedge))
        P.tb.warm_up(sysd, P.M70)
        _hot(P, sysd, "polaris-ep", P.M70)
        soph = sysd.endpoints["sophia-ep"].instances[P.M70][0]
        for i in range(150):
            soph.submit(P.inst.SimRequest(f"bg{i}", 256, 256), None,
                        lambda r: None)
        f = sysd.gateway.submit(sysd.token_for("u"), {
            "model": P.M70, "prompt_tokens": 64, "max_tokens": 32})
        sysd.loop.run_until_idle()
        out[f"hedge {hedge}"] = system_trace(sysd, fut=fut_trace(f),
                                             hedges=sysd.gateway.hedges)
    return out


def s_heartbeats(P):
    """test_chaos: a crash and its recovery seen through heartbeats, a
    heartbeat-loss false positive, a latency straggler demoted, an
    injected outage the monitor does not override."""
    out = {}
    sysd = _two(P)
    P.tb.warm_up(sysd, P.M70)
    t0 = sysd.loop.now()
    sysd.faults.crash_endpoint(sysd.endpoints["sophia-ep"], t=t0 + 1.0,
                               duration=60.0)
    sysd.loop.run_until(t0 + 40.0)
    mid = (sysd.health.is_up("sophia-ep"), dict(sysd.router._healthy))
    sysd.loop.run_until(t0 + 80.0)
    out["crash"] = system_trace(sysd, mid=mid)
    sysd = _two(P)
    P.tb.warm_up(sysd, P.M70)
    t0 = sysd.loop.now()
    sysd.faults.heartbeat_loss(sysd.endpoints["sophia-ep"], t=t0 + 1.0,
                               duration=60.0)
    sysd.faults.endpoint_outage(sysd.router, "polaris-ep", t=t0 + 2.0,
                                duration=50.0)
    sysd.loop.run_until(t0 + 35.0)
    mid = (sysd.health.is_up("sophia-ep"), dict(sysd.router._healthy))
    sysd.loop.run_until(t0 + 80.0)
    out["loss"] = system_trace(sysd, mid=mid)
    sysd = _two(P)
    P.tb.warm_up(sysd, P.M70)
    _hot(P, sysd, "polaris-ep", P.M70)
    t0 = sysd.loop.now()
    sysd.faults.latency_injection(sysd.endpoints["sophia-ep"], t=t0 + 1.0,
                                  duration=60.0, extra=5.0)
    sysd.loop.run_until(t0 + 40.0)
    picks = [sysd.router.select_endpoint(P.M70), dict(sysd.router._slow)]
    sysd.loop.run_until(t0 + 150.0)
    picks += [sysd.router.select_endpoint(P.M70), dict(sysd.router._slow)]
    out["straggler"] = system_trace(sysd, picks=picks)
    return out


def s_resilience_units(P):
    """test_chaos: the breaker's state machine and timeout-rate trip, retry
    backoff with a seeded jitter and deadline timeouts, the retry budget,
    the brownout ladder."""
    r = P.res
    log = []
    b = r.CircuitBreaker("ep", r.BreakerPolicy(fail_threshold=3,
                                               cooldown=10.0,
                                               max_cooldown=40.0))
    for t, ev in ((0.0, "f"), (0.0, "f"), (0.0, "f"), (5.0, "a"),
                  (10.0, "a"), (10.0, "a"), (10.0, "f"), (25.0, "a"),
                  (30.0, "a"), (30.0, "s")):
        if ev == "f":
            b.on_failure(t)
        elif ev == "s":
            b.on_success(t)
        else:
            log.append(b.allow(t))
        log.append((b.state, b.opens, b.blocked(t), b.snapshot(t)))
    b2 = r.CircuitBreaker("ep", r.BreakerPolicy(
        fail_threshold=100, timeout_rate=0.5, min_samples=4, window=60.0))
    b2.on_success(0.0)
    for t in (1.0, 2.0, 3.0):
        b2.on_failure(t, timeout=True)
        log.append(b2.state)
    import random
    rng = random.Random(0)
    p = r.RetryPolicy(max_attempts=4, base_backoff=1.0, max_backoff=4.0)
    log.append([p.backoff(i % 6, rng) for i in range(40)])
    p = r.RetryPolicy(max_attempts=3, attempt_timeout=30.0,
                      min_attempt_timeout=0.25)
    log.append([p.timeout_for(a, now=n, deadline=d) for a, n, d in
                ((0, 0.0, 9.0), (2, 0.0, 9.0), (0, 0.0, None),
                 (0, 100.0, 100.3))])
    bud = r.RetryBudget(ratio=0.5, floor=1.0, cap=2.0)
    log.append([bud.try_withdraw(), bud.try_withdraw()])
    for _ in range(3):
        bud.on_request()
    log.append((bud.try_withdraw(), bud.balance, bud.denied,
                bud.withdrawals, bud.deposits))
    c = r.BrownoutController(r.BrownoutPolicy(enter_pressure=0.7,
                                              exit_pressure=0.3, dwell=10.0))
    for pr, t in ((0.9, 0.0), (0.9, 5.0), (0.9, 10.0), (0.5, 20.0),
                  (0.9, 30.0), (0.9, 45.0), (0.1, 55.0), (0.1, 65.0),
                  (0.1, 75.0)):
        log.append((c.observe(pr, t), c.shed_batch(), c.suppress_hedges(),
                    c.effective_attempts(4), c.admission_cap(64),
                    c.snapshot()))
    log.append(c.transitions)
    loop = P.clock.EventLoop()
    rl = P.gw.RateLimiter(loop, rate=0.0, burst=2.0)
    log.append([rl.acquire("u") for _ in range(4)])
    return log


def s_gateway_resilience(P):
    """test_chaos: breaker trips, fails fast and closes on its probe;
    brownout sheds batch then recovers; the retry layer's seeded jitter
    under a seeded chaos plan."""
    out = {}
    sysd = P.tb.build_system(
        _one(P),
        gateway_config=P.gw.GatewayConfig(
            retry=P.res.RetryPolicy(max_attempts=2, base_backoff=0.2,
                                    max_backoff=0.5, attempt_timeout=300.0),
            breaker=P.res.BreakerPolicy(fail_threshold=3, cooldown=30.0)))
    P.tb.warm_up(sysd, P.M70)
    client = P.api.FirstClient(sysd.gateway, sysd.token_for("alice"))
    t0 = sysd.loop.now()
    sysd.faults.crash_endpoint(sysd.endpoints["sophia-ep"], t=t0 + 1.0,
                               duration=120.0)
    futs = []
    for i in range(5):
        sysd.loop.call_at(t0 + 3.0 + i, lambda i=i: futs.append(
            client.chat(model=P.M70, prompt_tokens=8, max_tokens=2,
                        request_id=f"b{i}")))
    sysd.loop.run_until_idle()
    sysd.loop.run_until(t0 + 140.0)
    futs.append(client.chat(model=P.M70, prompt_tokens=8, max_tokens=2))
    sysd.loop.run_until_idle()
    out["breaker"] = system_trace(sysd, futs=[fut_trace(f) for f in futs])
    sysd = P.tb.build_system(
        _one(P),
        gateway_config=P.gw.GatewayConfig(brownout=P.res.BrownoutPolicy(
            enter_pressure=0.7, exit_pressure=0.3, dwell=10.0,
            eval_interval=5.0)))
    P.tb.warm_up(sysd, P.M70)
    client = P.api.FirstClient(sysd.gateway, sysd.token_for("alice"))
    t0 = sysd.loop.now()
    sysd.faults.crash_endpoint(sysd.endpoints["sophia-ep"], t=t0 + 1.0,
                               duration=120.0)
    sysd.loop.run_until(t0 + 70.0)
    shed = client.chat(model=P.M70, prompt_tokens=8, max_tokens=2,
                       qos="batch")
    sysd.loop.run_until_idle()
    mid = sysd.gateway.jobs_status()
    sysd.loop.run_until(t0 + 200.0)
    ok = client.chat(model=P.M70, prompt_tokens=8, max_tokens=2, qos="batch")
    sysd.loop.run_until_idle()
    out["brownout"] = system_trace(sysd, mid=mid, shed=fut_trace(shed),
                                   ok=fut_trace(ok))
    sysd = _two(P, gw=dict(retry=P.res.RetryPolicy(
        max_attempts=3, attempt_timeout=300.0, stall_timeout=10.0),
        breaker=P.res.BreakerPolicy(), retry_seed=11))
    sysd.faults = P.faults.FailureInjector(sysd.loop, seed=5)
    P.tb.warm_up(sysd, P.M70)
    _hot(P, sysd, "polaris-ep", P.M70)
    plan = sysd.faults.plan_chaos(
        sysd.endpoints, sysd.schedulers, horizon=300.0,
        start=sysd.loop.now(), instance_rate=0.01, crash_rate=0.008,
        silent_crash_rate=0.005, hb_loss_rate=0.005, latency_rate=0.005)
    wl = P.wl.make_workload(80, rate=0.3, seed=13)
    out["chaos"] = system_trace(sysd, plan=plan,
                                drive=P.tb.drive_workload(sysd, wl, P.M70))
    return out


def s_midstream_failover(P):
    """test_chaos: a noisy and a silent crash mid-stream; the stream
    resumes on the other cluster without a duplicate or a lost token."""
    out = {}
    for silent in (False, True):
        sysd = _two(P, gw=dict(retry=P.res.RetryPolicy(
            max_attempts=3, attempt_timeout=300.0, stall_timeout=10.0),
            breaker=P.res.BreakerPolicy()))
        P.tb.warm_up(sysd, P.M70)
        _hot(P, sysd, "polaris-ep", P.M70)
        client = P.api.FirstClient(sysd.gateway, sysd.token_for("alice"))
        fut, asm = client.stream(model=P.M70, prompt_tokens=64,
                                 max_tokens=200, request_id="x1")
        sysd.faults.crash_endpoint(sysd.endpoints["sophia-ep"],
                                   t=sysd.loop.now() + 4.0, duration=600.0,
                                   silent=silent)
        sysd.loop.run_until_idle()
        out[silent] = system_trace(
            sysd, fut=fut_trace(fut), frames=asm.deltas,
            asm=(asm.n_tokens, asm.finished, asm.finish_reason,
                 asm.arrivals))
    return out


def s_hot_pool(P):
    """test_hot_pool: the min_hot floor pre-spawns and refills, keepalive
    scale-in down to the floor, scale-in never evicts in-flight work."""
    M = P.L8.name
    out = {}
    sysd = P.tb.build_system({"sophia": {M: P.dep(
        P.L8, min_hot=2, max_instances=3, keepalive=300.0)}})
    ep = sysd.endpoints["sophia-ep"]
    sysd.loop.run_until(60.0)
    ep.instances[M][0].fail()
    sysd.loop.run_until(sysd.loop.now() + 60.0)
    out["floor"] = system_trace(sysd)
    sysd = P.tb.build_system({"sophia": {M: P.dep(
        P.L8, min_hot=1, max_instances=3, keepalive=40.0,
        scale_in_cooldown=10.0, storage_bw=40e9)}})
    ep = sysd.endpoints["sophia-ep"]
    for _ in range(3 - len(ep._alive_instances(M))):
        ep._spawn_instance(M)
    sysd.loop.run_until(sysd.loop.now() + 360.0)
    out["keepalive"] = system_trace(sysd)
    sysd = P.tb.build_system({"sophia": {M: P.dep(
        P.L8, min_hot=1, max_instances=2, keepalive=20.0,
        scale_in_cooldown=5.0, max_slots=4, storage_bw=40e9)}})
    ep = sysd.endpoints["sophia-ep"]
    for _ in range(2 - len(ep._alive_instances(M))):
        ep._spawn_instance(M)
    sysd.loop.run_until(sysd.loop.now() + 22.0)
    done = []
    ep.instances[M][0].engine.submit(P.inst.SimRequest(
        request_id="long", prompt_tokens=32, max_tokens=3000), None,
        done.append)
    sysd.loop.run_until(sysd.loop.now() + 60.0)
    mid = endpoint_trace(ep)
    sysd.loop.run_until_idle()
    out["inflight"] = system_trace(sysd, mid=mid, done=done)
    return out


def _disagg(P, **dep_kw):
    M = P.L8.name
    kw = dict(storage_bw=40e9, max_slots=8, **dep_kw)
    sysd = P.tb.build_system({
        "sophia": {M: P.dep(P.L8, role="prefill-heavy", **kw)},
        "polaris": {M: P.dep(P.L8, role="decode-heavy", **kw)}})
    for c in ("sophia", "polaris"):
        sysd.endpoints[f"{c}-ep"]._spawn_instance(M)
    sysd.loop.run_until(sysd.loop.now() + 60.0)
    return sysd


def s_handoff(P):
    """test_hot_pool: the role filter, a prefill->decode handoff end to end
    (streamed, contiguous offsets), an abort forwarded across the handoff,
    and the local-decode fallback."""
    M = P.L8.name
    out = {}
    sysd = _disagg(P)
    picks = [sysd.router.select_endpoint(M),
             sysd.router.select_endpoint(M, role="decode")]
    futs = [sysd.gateway.submit(sysd.token_for("bench"), {
        "request_id": f"h{i}", "model": M, "prompt_tokens": 64,
        "max_tokens": 64}) for i in range(6)]
    frames = []
    futs.append(sysd.gateway.submit(sysd.token_for("bench"), {
        "request_id": "st1", "model": M, "prompt_tokens": 64,
        "max_tokens": 32, "stream": True}, on_delta=frames.append))
    sysd.loop.run_until_idle()
    out["handoff"] = system_trace(sysd, picks=picks, frames=frames,
                                  futs=[fut_trace(f) for f in futs])
    sysd = _disagg(P)
    ep_p = sysd.endpoints["sophia-ep"]
    fut = ep_p.execute("generate", {"request_id": "ab1", "model": M,
                                    "prompt_tokens": 64,
                                    "max_tokens": 50000})
    sysd.loop.run_until(sysd.loop.now() + 10.0)
    ab = ep_p.execute("abort", {"request_id": "ab1"})
    sysd.loop.run_until_idle()
    out["abort"] = system_trace(sysd, futs=[fut_trace(fut), fut_trace(ab)])
    sysd = _disagg(P)
    sysd.endpoints["polaris-ep"].crash()
    sysd.router.set_healthy("polaris-ep", False)
    fut = sysd.gateway.submit(sysd.token_for("bench"), {
        "request_id": "fb1", "model": M, "prompt_tokens": 64,
        "max_tokens": 24})
    sysd.loop.run_until_idle()
    out["fallback"] = system_trace(sysd, fut=fut_trace(fut))
    return out


def s_placement(P):
    """test_hot_pool: interactive traffic prefers the warm pool; cold
    interactive placement charges the load time, batch keeps the free-node
    tie-break; test_qos_scheduler: qos tags through the whole path."""
    M = P.L8.name
    sysd = P.tb.build_system({c: {M: P.dep(P.L8)}
                              for c in ("sophia", "polaris")})
    sysd.endpoints["sophia-ep"]._spawn_instance(M)
    sysd.loop.run_until(sysd.loop.now() + 60.0)
    sysd.endpoints["polaris-ep"]._spawn_instance(M)
    sysd.loop.run_until(sysd.loop.now() + 1.0)
    picks = [sysd.router.select_endpoint(M, qos="interactive"),
             sysd.router.select_endpoint(M, qos="batch")]
    warm = system_trace(sysd, picks=picks)
    sysd = P.tb.build_system({
        "slowstore": {M: P.dep(P.L8, storage_bw=1e9)},
        "faststore": {M: P.dep(P.L8, storage_bw=40e9)}},
        nodes_per_cluster=24)
    sysd.schedulers["faststore"].fail_node(0)
    picks = [sysd.router.select_endpoint(M, qos="interactive"),
             sysd.router.select_endpoint(M, qos="batch")]
    client = P.api.FirstClient(sysd.gateway, sysd.token_for("q"))
    futs = [client.chat(model=M, prompt_tokens=128, max_tokens=64,
                        qos="batch" if i % 3 else "interactive",
                        priority=i % 2, request_id=f"q{i}")
            for i in range(12)]
    sysd.loop.run_until_idle()
    return {"warm": warm,
            "cold": system_trace(sysd, picks=picks,
                                 futs=[fut_trace(f) for f in futs])}


def s_streaming_gateway(P):
    """test_streaming: TTFT and ITL observed at the gateway, a cancel that
    reaches the engine, a stream that survives an instance failure without
    duplicates, a hedge loser cancelled on the first token."""
    out = {}
    sysd = _two(P)
    P.tb.warm_up(sysd, P.M70)
    client = P.api.FirstClient(sysd.gateway, sysd.token_for("alice"))
    fut, asm = client.stream(model=P.M70, prompt_tokens=64, max_tokens=24,
                             request_id="s1")
    ref = client.chat(model=P.M70, prompt_tokens=64, max_tokens=24)
    fc, asm_c = client.stream(model=P.M70, prompt_tokens=64,
                              max_tokens=5000, request_id="c1")
    sysd.loop.call_after(30.0, lambda: client.cancel("c1"))
    fcomp = client.complete(model=P.M70, prompt_tokens=32, max_tokens=8)
    femb = client.embed(model=P.M70, input=32)
    sysd.loop.run_until_idle()
    out["stream"] = system_trace(
        sysd, futs=[fut_trace(f) for f in (fut, ref, fc, fcomp, femb)],
        frames=(asm.deltas, asm_c.deltas),
        asm=(asm.n_tokens, asm.arrivals, asm_c.n_tokens))
    sysd = _two(P)
    P.tb.warm_up(sysd, P.M70)
    client = P.api.FirstClient(sysd.gateway, sysd.token_for("alice"))
    fut, asm = client.stream(model=P.M70, prompt_tokens=64, max_tokens=200,
                             request_id="f1")
    sysd.faults.fail_instance_at(sysd.endpoints["sophia-ep"], P.M70,
                                 t=sysd.loop.now() + 4.0)
    sysd.loop.run_until_idle()
    out["failure"] = system_trace(sysd, fut=fut_trace(fut),
                                  frames=asm.deltas)
    sysd = _two(P, gw=dict(hedge_after=10.0))
    P.tb.warm_up(sysd, P.M70)
    _hot(P, sysd, "polaris-ep", P.M70)
    soph = sysd.endpoints["sophia-ep"].instances[P.M70][0]
    for i in range(150):
        soph.submit(P.inst.SimRequest(f"bg{i}", 256, 256), None,
                    lambda r: None)
    client = P.api.FirstClient(sysd.gateway, sysd.token_for("u"))
    fut = client.chat(model=P.M70, prompt_tokens=64, max_tokens=4000,
                      request_id="h1")
    sysd.loop.run_until_idle()
    out["hedge"] = system_trace(sysd, fut=fut_trace(fut),
                                hedges=sysd.gateway.hedges)
    return out


def _sim(P, cost, reqs, **kw):
    loop = P.clock.EventLoop(P.clock.VirtualClock())
    eng = P.inst.SimEngine(loop, cost, **kw)
    log = []
    for sreq, t in reqs:
        def go(s=sreq):
            eng.submit(s, lambda ft, r=s.request_id: log.append(
                ("first", r, ft)), lambda res: log.append(("done", res)))
        loop.call_at(t, go)
    loop.run_until_idle()
    return {"log": log, "now": loop.now(), "engine": engine_trace(eng)}


def s_sim_engine_toggles(P):
    """The SimEngine toggles of test_qos_scheduler (fcfs / priority /
    preemption / edf), test_prefix_cache (hit rate, chunk budget),
    test_spec_decode (spec rounds) and test_decode_fastpath (K)."""
    out = {}
    c70 = P.icost(P.L70)
    qos = [(P.inst.SimRequest(f"b{j}", 256, 400, qos="batch"), 0.0)
           for j in range(6)]
    qos += [(P.inst.SimRequest(f"i{j}", 64, 16, qos="interactive"), 5.0 + j)
            for j in range(4)]
    for pol, pre in (("fcfs", False), ("priority", False),
                     ("priority", True)):
        out[f"qos {pol} {pre}"] = _sim(P, c70, qos, max_slots=2,
                                       scheduling_policy=pol,
                                       enable_preemption=pre,
                                       restore_hit_rate=0.9)
    out["edf"] = _sim(P, c70, [(P.inst.SimRequest(r, 64, 8, deadline=d), 0.0)
                               for r, d in (("dummy", None),
                                            ("loose", 500.0),
                                            ("none", None),
                                            ("tight", 50.0))],
                      max_slots=1, scheduling_policy="edf")
    long = [(P.inst.SimRequest(f"r{i}", 2048, 16), 0.0) for i in range(8)]
    for hit, budget in ((0.0, None), (0.9, None), (0.0, 512), (0.5, 256)):
        out[f"prefix {hit} {budget}"] = _sim(
            P, P.icost(P.L70, chips=8), long, max_slots=8,
            prefix_cache_hit_rate=hit, chunked_prefill_budget=budget)
    reg = P.configs.REGISTRY
    target = P.icost(reg["yi-34b"], chips=8)
    draft = P.icost(reg["llama3.2-3b"], chips=8)
    spec = [(P.inst.SimRequest(f"r{i}", 64, 48), 0.0) for i in range(4)]
    for k, a in ((0, 0.8), (4, 0.8), (4, 0.0)):
        out[f"spec {k} {a}"] = _sim(P, target, spec, max_slots=4,
                                    spec_tokens=k, spec_accept_rate=a,
                                    draft_cost=draft)
    try:
        P.inst.SimEngine(P.clock.EventLoop(), target, spec_tokens=4)
    except ValueError as e:
        out["spec no draft"] = str(e)
    c3 = P.icost(reg["llama3.2-3b"], chips=4)
    for k in (1, 16):
        out[f"K {k}"] = _sim(P, c3, [(P.inst.SimRequest(f"r{i}", 64, 40 + i),
                                      0.0) for i in range(4)],
                             max_slots=4, decode_steps_per_sync=k)
    return out


def s_tensor_parallel(P):
    """model_shards=4 deployments: the TP terms through the gateway, and
    HBM headroom per shard."""
    M = P.M70
    sysd = P.tb.build_system({
        "sophia": {M: P.dep(P.L70, model_shards=4, storage_bw=40e9)},
        "polaris": {M: P.dep(P.L70, model_shards=8, storage_bw=40e9)}},
        startup_delay=5.0)
    P.tb.warm_up(sysd, M)
    s = P.tb.drive_workload(sysd, P.wl.make_workload(120, rate=2.0, seed=4),
                            M)
    costs = [(ep.deployments[M].cost.hbm_bytes_per_shard(8, 2048),
              ep.deployments[M].cost.decode_step_time(8, 2048, 8))
             for ep in sysd.endpoints.values()]
    return system_trace(sysd, drive=s, costs=costs)


def s_federated_example(P):
    """examples/federated_serving.py and examples/batch_inference.py's
    control plane, as phase 9c of chip_smoke.py runs them (the same
    function, given each package's modules)."""
    return chip_smoke.federation_des(P.tb, P.gw, P.api, P.wl, hw=REF_HW)


SCENARIOS = {n[2:]: f for n, f in sorted(globals().items())
             if n.startswith("s_") and callable(f)}


@pytest.fixture
def run_in(monkeypatch):
    """Run a scenario in one package with its id counters reset; the
    port's COLLECTIVE_LAUNCH set to the reference's."""
    import repro_torch.serving.costmodel as port_cost
    monkeypatch.setattr(port_cost, "COLLECTIVE_LAUNCH",
                        ref_cost.COLLECTIVE_LAUNCH)

    def run(root, scenario):
        for mod, name, start in COUNTERS:
            monkeypatch.setattr(importlib.import_module(f"{root}.{mod}"),
                                name, itertools.count(start))
        return canon(scenario(_pkg(root)))
    return run


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_des_trace_equals_reference(run_in, name):
    ref = run_in("repro", SCENARIOS[name])
    port = run_in("repro_torch", SCENARIOS[name])
    assert port == ref


def test_scenarios_cover_the_reference_tests():
    assert len(SCENARIOS) >= 14


def test_id_counters_are_module_state(run_in):
    """The id counters run on across systems in one process, in both
    packages alike (the port keeps them as the reference does): the same
    system built twice gets other instance ids and tokens, which is why
    every scenario resets them first."""
    def ids(P):
        sysd = P.tb.build_system(_one(P))
        P.tb.warm_up(sysd, P.M70)
        inst = sysd.endpoints["sophia-ep"].instances[P.M70][0]
        return inst.instance_id, sysd.tokens["warm"]

    def twice(P):
        return ids(P), ids(P)

    ref = run_in("repro", twice)
    assert run_in("repro_torch", twice) == ref
    assert ref[0] != ref[1]
