"""Model catalog + cross-model replica trading: many models, one fleet
(port of ``tfmesos_tpu/fleet/catalog.py``).

* :class:`ModelSpec` / :class:`ModelCatalog` — the catalog: each entry
  names a ``model_id`` (the same validated charset as
  ``weights_version`` — it joins a ``shell=True`` Mode-B command line,
  so the charset is a security boundary, and it becomes a metric
  label), its build config (model seed), a priority ``floor`` (the
  replica count trading never shrinks an ACTIVE model below), and its
  scale-to-zero policy.  Requests without a ``model`` label ride the
  DEFAULT (first-listed) entry, so single-model fleets and old clients
  are unchanged.

* :class:`ModelTrader` — the :class:`~tfmesos_tpu_torch.fleet.
  autoscaler.FleetAutoscaler` generalized from per-tier to per-(model,
  tier) loops under ONE fleet-wide replica budget.  Each model scales
  on its own windowed queue-wait pressure (``queue_wait_ms_model_<id>``
  histograms the gateway feeds per dispatch); when the budget is tight
  the loop TRADES — drain-migrate-kill one replica of the coldest
  model and relaunch (or warm-pool-adopt) it as the hottest.  Idle
  models scale to ZERO (their sessions stay parked in the KV tier and
  resume on the next cold start), and a bounded WARM POOL of
  pre-warmed, undedicated replicas adopts a ``model_id`` at assignment
  time so a cold start costs a weight install, not a process launch
  plus a graph capture.  Victim tie-break feeds on the KV tier: among
  equally-cold models, prefer trading away replicas whose sessions are
  already parked on a shared DISK tier.

* :func:`pack_adapter` / :func:`unpack_adapter` — the adapter
  (weight-delta) wire format, byte for byte the JAX package's: how a
  LoRA-style delta of ``/``-joined param paths to arrays travels to a
  replica's ``swap_adapter`` op.  A raw frame carries it between
  processes: ``meta["adapter"]`` is the manifest (paths, shapes,
  dtypes, byte sizes; JSON, never pickle) and the body the arrays'
  bytes in path order; the frame's HMAC covers both.  The gateway hop
  carries the same manifest with the body in base64
  (:func:`encode_adapter_fields`), since the gateway's public port
  takes no raw frames.

A model of ``gang_size > 1`` serves as gang replicas: each costs
``gang_size`` slots of the replica budget, and the trader frees a whole
gang's slots or none.

Everything here is standard library only (numpy only inside the
pack/unpack helpers), like the rest of the control plane.
"""

from __future__ import annotations

import base64
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from tfmesos_tpu_torch.fleet.autoscaler import (AutoscalerConfig,
                                                FleetAutoscaler)
from tfmesos_tpu_torch.fleet.metrics import Histogram
from tfmesos_tpu_torch.fleet.registry import (ALIVE, MODEL_ID_RE, UNIFIED,
                                              validate_model_id)
from tfmesos_tpu_torch.utils.logging import get_logger

__all__ = ["ModelSpec", "ModelCatalog", "TraderConfig", "ModelTrader",
           "MODEL_ID_RE", "validate_model_id", "model_key", "split_key",
           "filter_members", "POOL", "POOL_KEY",
           "pack_adapter", "unpack_adapter", "encode_adapter_fields",
           "decode_adapter_fields"]


#: the warm pool's reserved pseudo-model id.  Starts with ``_`` so it
#: can NEVER collide with a real (validated) model_id, and never
#: appears on the wire as one — pool membership rides its own
#: ``warm_pool`` heartbeat flag.
POOL = "_pool"


def model_key(model_id: str, role: str = UNIFIED) -> str:
    """The per-(model, tier) target key: ``"<model_id>/<role>"``.
    ``/`` is outside the model-id charset, so the split is
    unambiguous."""
    return f"{model_id}/{role}"


POOL_KEY = model_key(POOL)


def split_key(key: str) -> Tuple[Optional[str], str]:
    """``"m/unified"`` -> ``("m", "unified")``; a plain role key (the
    model-less fleet) -> ``(None, role)``."""
    if "/" in key:
        m, _, role = key.rpartition("/")
        return m, role
    return None, key


def filter_members(members, key: str):
    """The subset of registry ``members`` belonging to one
    per-(model, tier) key: warm-pool members for :data:`POOL_KEY`,
    exact ``model_id`` matches for a model key, everything for a plain
    role key (whose role filtering the registry already did)."""
    model, _ = split_key(key)
    if model == POOL:
        return [r for r in members if getattr(r, "warm_pool", False)]
    if model is not None:
        return [r for r in members
                if getattr(r, "model_id", "") == model]
    return list(members)


@dataclasses.dataclass
class ModelSpec:
    """One catalog entry.

    ``seed`` selects the model's weights (the preset builders derive
    parameters from it — two entries with different seeds ARE two
    models); ``replicas`` is the boot count (0 = starts scaled to
    zero, cold-started through the warm pool on first demand);
    ``floor`` is the priority floor — trading never shrinks an ACTIVE
    (traffic-bearing) model below it; ``scale_to_zero`` allows an IDLE
    model to drop to zero replicas (its parked sessions stay in the KV
    tier); ``gang_size`` shards each replica of this model across N
    gang-member tasks (one pod slice presenting as one routable
    replica) — under the shared budget a gang replica costs N SLOTS,
    not one."""

    model_id: str
    replicas: int = 1
    seed: int = 0
    floor: int = 0
    scale_to_zero: bool = True
    gang_size: int = 1

    def __post_init__(self):
        self.model_id = validate_model_id(self.model_id)
        if self.replicas < 0:
            raise ValueError(f"model {self.model_id!r}: replicas must "
                             f"be >= 0, got {self.replicas}")
        if self.floor < 0:
            raise ValueError(f"model {self.model_id!r}: floor must be "
                             f">= 0, got {self.floor}")
        if self.replicas and self.floor > self.replicas:
            raise ValueError(
                f"model {self.model_id!r}: floor ({self.floor}) "
                f"exceeds its boot replicas ({self.replicas})")
        if self.gang_size < 1:
            raise ValueError(
                f"model {self.model_id!r}: gang_size must be >= 1, "
                f"got {self.gang_size}")


class ModelCatalog:
    """The fleet's model table.  Entries keep their listed order; the
    FIRST entry is the DEFAULT — requests without a ``model`` label
    ride it, which is what keeps model-less clients working unchanged
    against a catalog fleet."""

    def __init__(self, specs):
        specs = list(specs)
        if not specs:
            raise ValueError("a model catalog needs at least one entry")
        ids = [s.model_id for s in specs]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate model_id in catalog: {ids}")
        self._specs: Dict[str, ModelSpec] = {s.model_id: s for s in specs}
        self.default_id = specs[0].model_id

    def resolve(self, label: Optional[str]) -> str:
        """The model a request labeled ``label`` targets: the default
        entry for ``None``/empty; :class:`KeyError` for an UNKNOWN
        label — unlike priority classes, a typo'd model cannot be
        served "without special treatment": there are no weights for
        it, and billing it to the default would be silently wrong."""
        if not label:
            return self.default_id
        if label not in self._specs:
            raise KeyError(f"unknown model {label!r} (catalog has: "
                           f"{', '.join(self.ids())})")
        return label

    def get(self, model_id: str) -> ModelSpec:
        return self._specs[model_id]

    def ids(self) -> List[str]:
        return list(self._specs)

    def __len__(self) -> int:
        return len(self._specs)

    def __iter__(self):
        return iter(self._specs.values())


@dataclasses.dataclass
class TraderConfig:
    """Trading knobs on top of :class:`AutoscalerConfig`'s hysteresis
    band (which the per-model loops reuse), with the JAX package's
    defaults: ``trade_cooldown_s`` is the anti-thrash band that keeps a
    flapping hotness signal from churning one replica between two
    models every tick."""

    #: consecutive control ticks with ZERO traffic (no queue-wait
    #: samples, zero utilization) before an idle scale-to-zero model's
    #: target drops to its floor.
    zero_after_ticks: int = 8
    #: minimum seconds between TRADES (budget-tight reallocations) —
    #: the anti-thrash band: a flapping hotness signal must not churn
    #: the same replica between two models every tick.
    trade_cooldown_s: float = 5.0


class ModelTrader(FleetAutoscaler):
    """Per-(model, tier) autoscaling under one fleet replica budget.

    Inherits the whole convergence machinery (one launch per tick,
    pinned drain-migrate-kill scale-down, stuck-victim deadlines,
    dead-replica self-healing) from :class:`FleetAutoscaler` — the
    generalization is in the RETARGETING: targets are keyed
    ``"<model_id>/<role>"`` (plus the warm pool's :data:`POOL_KEY`),
    each model scales on its OWN windowed queue-wait pressure, and
    when ``sum(targets) == fleet.replica_budget`` a hot model can only
    grow by trading a cold model's replica away.  Scale-up prefers
    ADOPTING an alive warm-pool replica (``fleet.adopt_replica`` — a
    weight install on a pre-warmed process) over launching a cold one.

    The ``fleet`` surface extends the autoscaler's with
    ``replica_budget``, ``tier_members(key)``, ``catalog``, and
    optionally ``adopt_replica(addr, model_id)``.
    """

    def __init__(self, fleet, catalog: ModelCatalog,
                 config: Optional[AutoscalerConfig] = None,
                 trader_config: Optional[TraderConfig] = None,
                 signals: Optional[Callable] = None,
                 clock: Callable[[], float] = time.monotonic):
        super().__init__(fleet, config,
                         signals=signals or self._model_signals,
                         clock=clock)
        #: whether self._signals is the built-in windowed reader (its
        #: off-tick peek variant exists) or an injected source.
        self._own_signals = signals is None
        self.catalog = catalog
        self.tcfg = trader_config or TraderConfig()
        self.log = get_logger("tfmesos_tpu_torch.fleet.trader")
        #: consecutive zero-traffic ticks per model key.
        self._idle_ticks: Dict[str, int] = {}
        #: previous cumulative per-model queue-wait samples (windowed
        #: percentiles, the autoscaler discipline).
        self._prev_qw: Dict[str, tuple] = {}
        #: previous cumulative per-model KV-tier (hits, misses) sums —
        #: the windowed tier hit rate rides next to queue wait as a
        #: victim-pick input: a model actively resuming parked
        #: sessions is a costly trade victim even when its queue
        #: looks calm.
        self._prev_kv_model: Dict[str, Tuple[int, int]] = {}
        # The first TICK-driven trade waits out one cooldown from
        # construction: bring-up queue-wait spikes (everything queues
        # while the fleet warms) read as hotness on every model at
        # once, and trading on them would churn replicas before any
        # real signal exists.  demand() (a model with NO replica at
        # all) is deliberately not gated.
        self._last_trade = self._clock()

    # -- signals -----------------------------------------------------------

    def _model_signals(self, advance: bool = True
                       ) -> Dict[str, Dict[str, Any]]:
        """Per-key signal dicts: each model's WINDOWED queue-wait p99
        and sample count (from the ``queue_wait_ms_model_<id>``
        histogram the gateway observes per dispatch) plus utilization
        over its own alive members; the pool key reports its alive
        count only.  ``advance=False`` is the off-tick PEEK (the
        demand hook's victim pick): it must not consume the window —
        storing ``_prev_qw`` here would make the next periodic tick
        diff against an almost-empty interval and miss the very
        pressure the budget-tight situation produced."""
        out: Dict[str, Dict[str, Any]] = {}
        metrics = self.fleet.metrics
        for key in list(self.fleet.targets):
            model, _ = split_key(key)
            members = self._members(key)
            alive = [r for r in members if r.state == ALIVE]
            capacity = sum(r.capacity for r in alive)
            outstanding = sum(r.outstanding for r in alive)
            util = (outstanding / capacity) if capacity > 0 else 0.0
            sig: Dict[str, Any] = {
                "alive": len(alive), "util": util,
                "queue_wait_p99_ms": None, "samples": 0,
            }
            if model is not None and model != POOL:
                cur = metrics.hist_cumulative(
                    f"queue_wait_ms_model_{model}")
                if cur is not None:
                    prev = self._prev_qw.get(key)
                    sig["queue_wait_p99_ms"] = Histogram.delta_percentile(
                        prev, cur, 0.99)
                    sig["samples"] = cur[2] - (prev[2] if prev else 0)
                    if advance:
                        self._prev_qw[key] = cur
            # Windowed per-model KV-tier hit rate from the members'
            # heartbeat counter sums.  Deltas clamp at zero — a dying
            # member's counters leave the sum, which must not read as
            # negative tier traffic.
            sig["kv_hit_rate"] = None
            kv_hits = kv_misses = 0
            for r in members:
                kt = getattr(r, "kv_tier", None)
                if isinstance(kt, dict):
                    c = kt.get("counters")
                    if isinstance(c, dict):
                        kv_hits += int(c.get("hits", 0) or 0)
                        kv_misses += int(c.get("misses", 0) or 0)
            prev_kv = self._prev_kv_model.get(key)
            if prev_kv is not None:
                dh = max(0, kv_hits - prev_kv[0])
                dm = max(0, kv_misses - prev_kv[1])
                if dh + dm > 0:
                    sig["kv_hit_rate"] = dh / (dh + dm)
            if advance:
                self._prev_kv_model[key] = (kv_hits, kv_misses)
            out[key] = sig
        return out

    def _peek_signals(self) -> Dict[str, Dict[str, Any]]:
        """Signals for an off-tick decision: window-preserving for the
        built-in source, the injected callable as-is otherwise."""
        if self._own_signals:
            return self._model_signals(advance=False)
        return self._signals()

    # -- the generalized control tick --------------------------------------

    def step(self, now: Optional[float] = None) -> None:
        now = self._clock() if now is None else now
        with self.fleet.scale_lock:
            signals = self._signals()
            self._retarget_models(signals, now)
            for key in list(self.fleet.targets):
                self._converge(key, now)
            self._reap_drained(now)

    def _retarget_models(self, signals: Dict[str, Dict[str, Any]],
                         now: float) -> None:
        cfg, tcfg = self.config, self.tcfg
        fleet = self.fleet
        budget = getattr(fleet, "replica_budget", None)
        desired = dict(fleet.targets)
        model_keys = [k for k in desired
                      if split_key(k)[0] not in (None, POOL)]
        hot: List[Tuple[float, float, str]] = []
        for key in model_keys:
            model, _ = split_key(key)
            spec = self.catalog.get(model)
            sig = signals.get(key) or {}
            qw = sig.get("queue_wait_p99_ms")
            samples = sig.get("samples") or 0
            util = sig.get("util") or 0.0
            if samples or util > 0:
                self._idle_ticks[key] = 0
            else:
                self._idle_ticks[key] = self._idle_ticks.get(key, 0) + 1
            idle = self._idle_ticks[key] >= tcfg.zero_after_ticks
            if idle and spec.scale_to_zero \
                    and desired[key] > spec.floor:
                # Scale to zero: the model's replicas free their slots
                # for hotter peers; its parked sessions stay in the KV
                # tier and the next request cold-starts through the
                # warm pool (router demand -> adopt).
                self._last_action[key] = (
                    f"to_zero:{desired[key]}->{spec.floor}")
                self._last_down[key] = now
                desired[key] = spec.floor
                self.fleet.metrics.inc("model_scale_to_zero")
                self.log.info("trader: model %s idle %d ticks — scale "
                              "to %d (sessions stay parked)", model,
                              self._idle_ticks[key], spec.floor)
                continue
            up = ((qw is not None and qw > cfg.queue_wait_hi_ms)
                  or util > cfg.util_hi)
            down = ((not samples or qw is None
                     or qw < cfg.queue_wait_lo_ms)
                    and util < cfg.util_lo)
            if up and now - self._last_up.get(key, -1e18) \
                    >= cfg.scale_up_cooldown:
                hot.append((qw or 0.0, util, key))
            elif (down and not up
                  and desired[key] > max(1, spec.floor)
                  and now - self._last_down.get(key, -1e18)
                  >= cfg.scale_down_cooldown):
                desired[key] -= 1
                self._last_down[key] = now
                self._last_action[key] = "down"
                self.fleet.metrics.inc("autoscale_down")
        if hot:
            # One growth decision per tick, hottest model first — the
            # same one-step-per-tick convergence cadence as the base
            # loop, which is what bounds trade thrash.  Budget math is
            # in SLOTS (member tasks), not replicas: a gang replica of
            # size N costs N slots, so growing a gang model may need
            # SEVERAL victims' slots in one trade.
            hot.sort(reverse=True)
            _, _, key = hot[0]
            need = self._slot_cost(key)
            total = self._slots(desired)
            if budget is None or total + need <= budget:
                desired[key] += 1
                self._last_up[key] = now
                self._last_action[key] = "up"
                self.fleet.metrics.inc("autoscale_up")
            elif now - self._last_trade >= tcfg.trade_cooldown_s:
                victims = self._free_slots(desired, key, signals,
                                           need, budget)
                if victims is not None:
                    for victim in victims:
                        desired[victim] -= 1
                        self._last_down[victim] = now
                        self._last_action[victim] = f"trade_to:{key}"
                    desired[key] += 1
                    self._last_trade = now
                    self._last_up[key] = now
                    self._last_action[key] = \
                        f"trade_from:{','.join(victims)}"
                    self.fleet.metrics.inc("model_trades")
                    self.log.info(
                        "trader: budget tight (%d/%s) — trading %d "
                        "replica slot(s) %s -> %s", total, budget,
                        len(victims), victims, key)
                else:
                    self.fleet.metrics.inc("model_trade_blocked")
        for key, n in desired.items():
            if n != fleet.targets.get(key):
                fleet.set_target(key, n)

    def _slot_cost(self, key: str) -> int:
        """Budget slots ONE replica of ``key`` occupies: the model's
        gang size (a pod-slice replica is N member tasks), 1 for the
        warm pool and plain tiers."""
        model, _ = split_key(key)
        if model in (None, POOL):
            return 1
        return int(getattr(self.catalog.get(model),
                           "gang_size", 1) or 1)

    def _slots(self, desired: Dict[str, int]) -> int:
        return sum(n * self._slot_cost(k) for k, n in desired.items())

    def _free_slots(self, desired: Dict[str, int], hot_key: str,
                    signals: Dict[str, Dict[str, Any]], need: int,
                    budget: int) -> Optional[List[str]]:
        """Victim keys (one entry per shrunk replica, keys may repeat)
        whose freed slots make room for one more ``hot_key`` replica
        of ``need`` slots — or None when the fleet cannot free enough.
        All-or-nothing: a gang trade that frees only HALF its slots
        would shrink victims for no growth at all."""
        work = dict(desired)
        victims: List[str] = []
        while self._slots(work) + need > budget:
            victim = self._free_slot(work, hot_key, signals)
            if victim is None:
                return None
            work[victim] -= 1
            victims.append(victim)
        return victims

    def _free_slot(self, desired: Dict[str, int], hot_key: str,
                   signals: Dict[str, Dict[str, Any]]
                   ) -> Optional[str]:
        """The key whose budget slot a hot model claims: the WARM POOL
        first — an undedicated pre-warmed replica exists precisely to
        be handed to whichever model needs one, so its slot moves
        before any traffic-bearing model's replica drains — then the
        coldest model per :meth:`_pick_victim`."""
        if desired.get(POOL_KEY, 0) > 0:
            return POOL_KEY
        return self._pick_victim(desired, hot_key, signals)

    def _pick_victim(self, desired: Dict[str, int], hot_key: str,
                     signals: Dict[str, Dict[str, Any]]
                     ) -> Optional[str]:
        """The COLDEST model key a replica may be traded away from:
        relative windowed queue-wait pressure decides (no-traffic
        models first, then the lowest p99), the KV tier breaks ties —
        prefer victims whose sessions are already PARKED on a shared
        disk tier (the trade then loses nothing resumable).  Never the
        hot model; never below the victim's own live bound (its floor
        when idle, at least one replica while it still has traffic)."""
        tcfg = self.tcfg
        best = None
        for key, n in desired.items():
            model, _ = split_key(key)
            if key == hot_key or model in (None, POOL):
                continue
            spec = self.catalog.get(model)
            idle = self._idle_ticks.get(key, 0) >= tcfg.zero_after_ticks
            bound = spec.floor if (idle and spec.scale_to_zero) \
                else max(1, spec.floor)
            if n <= bound:
                continue
            sig = signals.get(key) or {}
            qw = sig.get("queue_wait_p99_ms")
            samples = sig.get("samples") or 0
            kv_hit = sig.get("kv_hit_rate")
            score = (
                0 if not samples else 1,    # traffic-less models first
                qw if qw is not None else 0.0,
                # Windowed tier hit rate: a model actively RESUMING
                # parked sessions pays real cold re-prefills if its
                # replica drains — prefer victims whose tier sits idle.
                kv_hit if kv_hit is not None else 0.0,
                -self._parked_disk_sessions(key),  # satellite: prefer
                key,                               # parked-on-disk
            )
            if best is None or score < best[0]:
                best = (score, key)
        return best[1] if best is not None else None

    def _parked_disk_sessions(self, key: str) -> int:
        """How many of this model's sessions are parked on a DISK
        (host-shared) KV tier: those
        conversations resume on any later replica of the host, so
        trading their parker away is the cheapest possible shrink."""
        total = 0
        for r in self._members(key):
            kt = getattr(r, "kv_tier", None)
            if isinstance(kt, dict) and kt.get("disk"):
                sess = kt.get("sessions")
                if isinstance(sess, (list, tuple)):
                    total += len(sess)
        return total

    # -- actuation hooks ---------------------------------------------------

    def _allow_zero(self, key: str) -> bool:
        model, _ = split_key(key)
        if model in (None, POOL):
            return model == POOL
        spec = self.catalog.get(model)
        return spec.scale_to_zero and spec.floor == 0

    def _scale_up(self, key: str) -> str:
        """Adopt an alive warm-pool replica when one exists (a weight
        install on a pre-warmed, pre-captured process — the cold-start
        TTFT cap), else launch a cold Mode-B task like the base
        loop."""
        model, role = split_key(key)
        adopt = getattr(self.fleet, "adopt_replica", None)
        if model not in (None, POOL) and role == UNIFIED \
                and adopt is not None:
            pool = [r for r in self._members(POOL_KEY)
                    if r.state == ALIVE]
            pool.sort(key=lambda r: r.addr)
            for r in pool:
                try:
                    ok = adopt(r.addr, model)
                except Exception:
                    self.log.exception("warm-pool adoption of %s for "
                                       "%s failed; launching cold",
                                       r.addr, model)
                    break
                if ok:
                    self.fleet.metrics.inc("model_adoptions")
                    self.log.info("trader: warm-pool replica %s "
                                  "adopted model %s", r.addr, model)
                    return f"adopt:{r.addr}"
        return self.fleet.launch_replica(key)

    def demand(self, model_id: str) -> bool:
        """Out-of-band cold-start signal (the router calls this when a
        request names a model with NO routable replica): raise the
        model's target to at least one — trading a cold model's slot
        away if the budget is full — and adopt-or-launch IMMEDIATELY
        instead of waiting for the next tick.  False when the model is
        unknown or nothing could be freed."""
        try:
            spec = self.catalog.get(model_id)
        except KeyError:
            return False
        key = model_key(model_id)
        with self.fleet.scale_lock:
            self._idle_ticks[key] = 0
            if self.fleet.targets.get(key, 0) < 1:
                budget = getattr(self.fleet, "replica_budget", None)
                need = self._slot_cost(key)
                total = self._slots(self.fleet.targets)
                if budget is not None and total + need > budget:
                    victims = self._free_slots(
                        dict(self.fleet.targets), key,
                        self._peek_signals(), need, budget)
                    if victims is None:
                        self.fleet.metrics.inc("model_trade_blocked")
                        return False
                    for victim in victims:
                        self.fleet.set_target(
                            victim, self.fleet.targets[victim] - 1)
                        self._last_down[victim] = self._clock()
                    self.fleet.metrics.inc("model_trades")
                self.fleet.set_target(key, max(1, spec.floor))
                self.fleet.metrics.inc("model_cold_starts")
                self.log.info("trader: cold-start demand for model %s",
                              model_id)
            members = self._members(key)
            if not any(r.state in (ALIVE, "warming") for r in members) \
                    and self.fleet.tier_actual(key) < 1:
                self._scale_up(key)
            return True

    # -- observability -----------------------------------------------------

    def describe(self) -> Dict[str, Dict[str, Any]]:
        out = super().describe()
        for key in out:
            out[key]["idle_ticks"] = self._idle_ticks.get(key, 0)
        return out


# -- adapter (weight-delta) wire format --------------------------------------


def pack_adapter(delta: Dict[str, Any]) -> Tuple[dict, bytes]:
    """A param-path -> numpy-array delta as the raw frame's ``(meta,
    body)``: the manifest in ``meta["adapter"]``, the arrays' raw bytes
    concatenated in sorted path order."""
    import numpy as np

    if not delta:
        raise ValueError("an adapter delta needs at least one entry")
    paths, shapes, dtypes, chunks = [], [], [], []
    for path in sorted(delta):
        arr = np.ascontiguousarray(delta[path])
        paths.append(str(path))
        shapes.append(list(arr.shape))
        dtypes.append(str(arr.dtype))
        chunks.append(arr.tobytes())
    meta = {"adapter": {"paths": paths, "shapes": shapes,
                        "dtypes": dtypes,
                        "sizes": [len(c) for c in chunks]}}
    return meta, b"".join(chunks)


def unpack_adapter(meta: dict, body: bytes) -> Dict[str, Any]:
    """Inverse of :func:`pack_adapter`; ``ValueError`` on a malformed
    manifest (sizes that do not tile the body, bad dtypes or shapes)."""
    import numpy as np

    man = meta.get("adapter")
    if not isinstance(man, dict):
        raise ValueError("adapter frame carries no manifest")
    paths = man.get("paths")
    shapes = man.get("shapes")
    dtypes = man.get("dtypes")
    sizes = man.get("sizes")
    if not (isinstance(paths, list) and isinstance(shapes, list)
            and isinstance(dtypes, list) and isinstance(sizes, list)
            and len(paths) == len(shapes) == len(dtypes) == len(sizes)
            and paths):
        raise ValueError("malformed adapter manifest")
    if sum(int(s) for s in sizes) != len(body):
        raise ValueError(
            f"adapter body ({len(body)} bytes) does not match its "
            f"manifest ({sum(int(s) for s in sizes)} bytes)")
    out: Dict[str, Any] = {}
    off = 0
    for path, shape, dtype, size in zip(paths, shapes, dtypes, sizes):
        size = int(size)
        try:
            dt = np.dtype(str(dtype))
            if dt.itemsize == 0:    # e.g. "V0" would divide by zero
                raise ValueError(f"zero-itemsize dtype {dtype!r}")
            arr = np.frombuffer(body, dtype=dt, count=size // dt.itemsize,
                                offset=off).reshape([int(d) for d in shape])
        except (TypeError, ValueError) as e:
            raise ValueError(f"bad adapter entry {path!r}: {e}") from e
        out[str(path)] = arr.copy()     # frombuffer views are read-only
        off += size
    return out


def encode_adapter_fields(delta: Dict[str, Any]) -> Dict[str, Any]:
    """The JSON-safe shape of a delta for the gateway hop: the manifest
    plus the body in base64 (``body_b64``)."""
    meta, body = pack_adapter(delta)
    out = dict(meta["adapter"])
    out["body_b64"] = base64.b64encode(body).decode("ascii")
    return out


def decode_adapter_fields(fields: Dict[str, Any]) -> Tuple[dict, bytes]:
    """Inverse of :func:`encode_adapter_fields`, standard library only:
    the raw frame's ``(meta, body)`` without building arrays (the
    manifest is checked structurally here, numerically by the
    replica)."""
    if not isinstance(fields, dict):
        raise ValueError("adapter delta must be an object")
    b64 = fields.get("body_b64")
    if not isinstance(b64, str) or not b64:
        raise ValueError("adapter delta needs body_b64")
    try:
        body = base64.b64decode(b64.encode("ascii"), validate=True)
    except Exception as e:
        raise ValueError(f"adapter body_b64 does not decode: {e}") from e
    man = {k: fields.get(k) for k in ("paths", "shapes", "dtypes",
                                      "sizes")}
    if not all(isinstance(v, list) and v for v in man.values()):
        raise ValueError("adapter delta needs paths/shapes/dtypes/sizes")
    sizes = man["sizes"]
    if not all(isinstance(s, int) and not isinstance(s, bool) and s > 0
               for s in sizes) or sum(sizes) != len(body):
        raise ValueError("adapter sizes do not tile the body")
    return {"adapter": man}, body
