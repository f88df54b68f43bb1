"""Stage-timing replica balancer: EWMA cost -> virtual-time dispatch
(port of ``repro.serve.balancer``).

``StageTimingBalancer`` routes micro-batches across N replica workers
using the wall-time the replicas actually report back — the per-launch
seconds (and, on staged launches, the per-stage breakdown that
``run_pipeline_staged`` exposes). Policy: deficit round-robin over
*virtual time*.

Every replica carries a virtual clock ``vtime``; ``pick()`` dispatches
to the replica with the smallest effective clock and advances that
clock by the replica's EWMA cost estimate (plus an in-flight penalty so
a replica whose slowness has not been *measured* yet cannot absorb the
whole backlog while its first report is pending). The result:

  * dispatch share is proportional to 1/cost — a replica 10x slower
    gets ~10x fewer batches;
  * never starvation — a slow replica's clock advances only when it is
    picked, so it is always picked again once the fast clocks catch up;
  * deterministic — no randomness; ties break on fewest dispatches,
    then lowest replica id.

The balancer is plain bookkeeping under one lock: no sleeping, no
threads of its own. ``snapshot()`` feeds the ``seismic_replica_*``
gauges.
"""
from __future__ import annotations

import threading


class StageTimingBalancer:
    """Virtual-time dispatch over ``n_replicas`` workers.

    Parameters
    ----------
    n_replicas  number of replica workers to balance over.
    alpha       EWMA smoothing for per-replica cost (0 < alpha <= 1);
                higher tracks drift faster, lower is steadier.
    prior_s     initial per-launch cost estimate. Equal priors mean the
                first dispatches round-robin until real timings arrive.
    """

    def __init__(self, n_replicas: int, *, alpha: float = 0.3,
                 prior_s: float = 1e-3):
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.n_replicas = n_replicas
        self.alpha = alpha
        self._lock = threading.Lock()
        self._cost = [float(prior_s)] * n_replicas      # EWMA s/launch
        self._stage_cost: list[dict[str, float]] = \
            [{} for _ in range(n_replicas)]             # EWMA s/stage
        self._vtime = [0.0] * n_replicas
        self._dispatches = [0] * n_replicas
        self._inflight = [0] * n_replicas
        self._recorded = [0] * n_replicas

    # ------------------------------------------------------------ policy

    def pick(self) -> int:
        """Choose the replica for the next dispatch and advance its
        virtual clock. Returns the replica id."""
        with self._lock:
            def effective(r: int) -> float:
                # un-acknowledged dispatches count at the current cost
                # estimate: backpressure on replicas that are behind
                return self._vtime[r] + self._inflight[r] * self._cost[r]
            rid = min(range(self.n_replicas),
                      key=lambda r: (effective(r), self._dispatches[r], r))
            self._vtime[rid] += self._cost[rid]
            self._dispatches[rid] += 1
            self._inflight[rid] += 1
            return rid

    def record(self, rid: int, seconds: float,
               stage_seconds: dict[str, float] | None = None) -> None:
        """Report one finished launch on ``rid``: ``seconds`` of wall
        time (on staged launches equal to the sum of the per-stage
        timings), plus the optional per-stage breakdown."""
        a = self.alpha
        with self._lock:
            self._inflight[rid] = max(0, self._inflight[rid] - 1)
            self._recorded[rid] += 1
            if self._recorded[rid] == 1:
                self._cost[rid] = float(seconds)   # drop the prior
            else:
                self._cost[rid] = (1 - a) * self._cost[rid] + a * seconds
            if stage_seconds:
                sc = self._stage_cost[rid]
                for name, dt in stage_seconds.items():
                    prev = sc.get(name)
                    sc[name] = float(dt) if prev is None \
                        else (1 - a) * prev + a * dt

    # ----------------------------------------------------- introspection

    def cost(self, rid: int) -> float:
        with self._lock:
            return self._cost[rid]

    def dispatches(self, rid: int) -> int:
        with self._lock:
            return self._dispatches[rid]

    def snapshot(self) -> dict:
        """Per-replica rollup for telemetry: cost EWMAs, dispatch
        counts/shares, in-flight depth, per-stage cost EWMAs."""
        with self._lock:
            total = max(1, sum(self._dispatches))
            return {
                "cost_ewma_s": list(self._cost),
                "dispatches": list(self._dispatches),
                "dispatch_share": [d / total for d in self._dispatches],
                "inflight": list(self._inflight),
                "stage_cost_ewma_s": [dict(sc) for sc in self._stage_cost],
            }
