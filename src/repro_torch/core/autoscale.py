"""Auto-scaling policy engine (paper §3.2.2 / Fig. 4): launch additional
instances of a model when existing ones are saturated, and manage the hot
pool on the way down — a pinned ``min_hot`` floor of warm instances plus a
per-model ``keepalive`` window that replaces the instances' flat idle
timeout. With ``keepalive`` unset, scale-in stays where it was before: the
instances' own ``idle_timeout`` timers.

A copy of the JAX package's ``repro/core/autoscale.py``, unchanged in
behaviour.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class AutoScalePolicy:
    max_instances: int = 1            # admin cap: max parallel jobs per model
    queue_threshold: int = 4          # queued reqs per instance that triggers scale-up
    cooldown: float = 30.0            # min seconds between scale-ups per model
    # hot-pool targets: a pinned floor of warm instances that survives zero
    # demand, and a per-model keepalive window after which idle instances
    # above the floor are released. keepalive=None leaves scale-in to the
    # instances' own flat idle_timeout (legacy behavior); when set, the
    # POOL owns scale-in and instances never self-release.
    min_hot: int = 0                  # pinned floor of provisioned instances
    keepalive: float | None = None    # idle seconds before scale-in
    scale_in_cooldown: float = 30.0   # min seconds between scale-ins per model


class AutoScaler:
    def __init__(self, loop, policy: AutoScalePolicy | None = None):
        self.loop = loop
        self.policy = policy or AutoScalePolicy()
        self._last_scale: dict[str, float] = {}
        self._last_scale_in: dict[str, float] = {}
        self.scale_events: list[tuple[float, str, int]] = []
        self.scale_in_events: list[tuple[float, str, int]] = []

    def should_scale_up(self, model: str, instances: list, cluster_free_nodes,
                        nodes_per_instance: int) -> bool:
        pol = self.policy
        alive = [i for i in instances if i.alive]
        if not alive or len(alive) >= pol.max_instances:
            return False
        if cluster_free_nodes < nodes_per_instance:
            return False
        now = self.loop.now()
        if now - self._last_scale.get(model, -1e18) < pol.cooldown:
            return False
        hot = [i for i in alive if i.state.value == "running"]
        if not hot:
            return False  # still cold-starting the first one
        queued = sum(i.engine.queue_depth for i in hot) + \
            sum(len(i._pending) for i in alive)
        saturated = all(i.engine.saturated() for i in hot)
        trigger = queued >= pol.queue_threshold * len(hot) or saturated
        return trigger

    def pool_deficit(self, model: str, instances: list, cluster_free_nodes,
                     nodes_per_instance: int) -> int:
        """Instances to spawn right now to restore the pinned ``min_hot``
        floor (bounded by the cluster's free nodes). The floor is demand-
        independent and not cooldown-gated: a pool hole left by a failure
        or release must refill promptly to keep TTFT flat."""
        pol = self.policy
        alive = [i for i in instances if i.alive]
        want = min(pol.min_hot, pol.max_instances) - len(alive)
        if want <= 0:
            return 0
        fit = int(cluster_free_nodes) // max(int(nodes_per_instance), 1)
        return max(min(want, fit), 0)

    def pick_scale_in(self, model: str, instances: list):
        """The instance to release now, or None: hot, zero in-flight work,
        idle past the keepalive window, longest-idle first — and only while
        the pool stays above the ``min_hot`` floor. Instances holding any
        queued/running work are never eviction candidates."""
        pol = self.policy
        if pol.keepalive is None:
            return None               # legacy: instances self-release
        alive = [i for i in instances if i.alive]
        if len(alive) <= max(pol.min_hot, 0):
            return None
        now = self.loop.now()
        if now - self._last_scale_in.get(model, -1e18) < pol.scale_in_cooldown:
            return None
        idle = [i for i in alive
                if i.state.value == "running" and i.load == 0
                and getattr(i, "idle_since", None) is not None
                and now - i.idle_since >= pol.keepalive]
        if not idle:
            return None
        return min(idle, key=lambda i: i.idle_since)   # longest idle

    def record_scale(self, model: str, n_instances: int):
        self._last_scale[model] = self.loop.now()
        self.scale_events.append((self.loop.now(), model, n_instances))

    def record_scale_in(self, model: str, n_instances: int):
        self._last_scale_in[model] = self.loop.now()
        self.scale_in_events.append((self.loop.now(), model, n_instances))
