"""The port's ``FleetAutoscaler`` against the JAX one.

Each case drives one package's autoscaler (``tfmesos_tpu.fleet`` or
``tfmesos_tpu_torch.fleet``) over the same fake fleet, registry, clock
and injected signals — the fakes of ``tests/test_autoscaler.py``, built
here over either package's ``FleetMetrics`` and ``ReplicaInfo`` — and
returns the action log: every target set, launch, kill, drain and drain
release, and after each tick the targets and the metrics counters.  The
two logs must be equal, and each case also checks its own expected
sequence, so that two equally wrong loops cannot pass.

One end-to-end case brings up a tiny port fleet on the CPU that grows to
two replicas under an injected surge and drains back to one, with no
failed request and the tokens of the port's in-process batcher.
"""

import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

SURGE = {"queue_wait_p99_ms": 5000.0, "util": 1.0, "kv_headroom": None}
CALM = {"queue_wait_p99_ms": 0.0, "util": 0.0, "kv_headroom": None}
MID = {"queue_wait_p99_ms": 200.0, "util": 0.5, "kv_headroom": None}


def package(side: str) -> SimpleNamespace:
    """The autoscaler, metrics and registry modules of one package."""
    if side == "jax":
        from tfmesos_tpu.fleet import autoscaler, metrics, registry
    else:
        from tfmesos_tpu_torch.fleet import autoscaler, metrics, registry
    return SimpleNamespace(autoscaler=autoscaler, metrics=metrics,
                           registry=registry)


# -- fakes (no sockets, no model) ---------------------------------------------


class FakeRegistry:
    """Just enough registry surface for the control loop; drains and
    releases land in the shared action log."""

    def __init__(self, pkg, log, reps=()):
        self.pkg, self.log = pkg, log
        self.reps = list(reps)
        self.drained = []
        self.targets = {}

    def members(self, role=None):
        return [r for r in self.reps
                if role is None or (r.role or "unified") == role]

    def role_summary(self):
        out = {}
        for r in self.reps:
            d = out.setdefault(r.role or "unified",
                               {"alive": 0, "warming": 0, "draining": 0,
                                "dead": 0, "outstanding": 0,
                                "kv_headroom": 0, "versions": {}})
            d[r.state] = d.get(r.state, 0) + 1
            if r.state == self.pkg.registry.ALIVE:
                d["outstanding"] += r.outstanding
                if r.kv_headroom > 0:
                    d["kv_headroom"] += r.kv_headroom
        return out

    def set_target(self, role, n):
        self.targets[role] = n

    def begin_drain(self, addr, pinned=True):
        for r in self.reps:
            if r.addr == addr:
                r.state = self.pkg.registry.DRAINING
                self.drained.append(addr)
                self.log.append(("drain", addr, pinned))
                return True
        return False

    def clear_drain(self, addr):
        self.log.append(("clear_drain", addr))
        self.drained = [a for a in self.drained if a != addr]
        for r in self.reps:
            if r.addr == addr:
                r.state = self.pkg.registry.ALIVE


class FakeFleet:
    """The launch/kill surface the autoscaler actuates against."""

    def __init__(self, pkg, log, registry, targets, bounds=(1, 4)):
        self.log = log
        self.registry = registry
        self.metrics = pkg.metrics.FleetMetrics()
        self.targets = dict(targets)
        self._bounds = tuple(bounds)
        self.scale_lock = threading.RLock()
        self.launched = []
        self.killed = []
        self.migrated = []
        self.dead_nodes = set()     # tasks already gone from the table
        self._actual = dict(targets)

    def set_target(self, role, n):
        self.log.append(("target", role, n))
        self.targets[role] = n
        self.registry.set_target(role, n)

    def bounds(self, role):
        return self._bounds

    def launch_replica(self, role, weights_version=None):
        node = f"{role}:{len(self.launched)}"
        self.log.append(("launch", role, node))
        self.launched.append((role, node))
        self._actual[role] = self._actual.get(role, 0) + 1
        return node

    def kill_replica(self, node):
        ok = node not in self.dead_nodes    # remove_task on a vanished task
        self.log.append(("kill", node, ok))
        if not ok:
            return False
        self.killed.append(node)
        role = node.split(":", 1)[0]
        self._actual[role] = self._actual.get(role, 1) - 1
        return True

    def request_migration(self, addr):
        self.log.append(("migrate", addr))
        self.migrated.append(addr)
        return True

    def tier_actual(self, role):
        return self._actual.get(role, 0)


class Case:
    """One case's package, action log and fakes."""

    def __init__(self, side):
        self.pkg = package(side)
        self.log = []

    def rep(self, addr, role="unified", state=None, outstanding=0,
            node="", capacity=4, weights_version=""):
        reg = self.pkg.registry
        return reg.ReplicaInfo(addr=addr, role=role,
                               state=state or reg.ALIVE,
                               outstanding=outstanding, node=node,
                               capacity=capacity,
                               weights_version=weights_version)

    def registry(self, reps=(), cls=FakeRegistry):
        return cls(self.pkg, self.log, reps)

    def fleet(self, registry, targets, bounds=(1, 4)):
        return FakeFleet(self.pkg, self.log, registry, targets, bounds)

    def auto(self, fleet, sig, clock, **cfg):
        a = self.pkg.autoscaler
        return a.FleetAutoscaler(fleet, a.AutoscalerConfig(**cfg),
                                 signals=lambda: {k: dict(v)
                                                  for k, v in sig.items()},
                                 clock=lambda: clock[0])

    def tick(self, auto, fleet):
        """One control tick, then the targets and counters into the log."""
        auto.step()
        self.log.append(("tick", dict(sorted(fleet.targets.items())),
                         dict(fleet.metrics.snapshot()["counters"])))


# -- the cases (the scenarios of tests/test_autoscaler.py) --------------------


def case_surge(c):
    reg = c.registry([c.rep("a:1")])
    fleet = c.fleet(reg, {"unified": 1}, bounds=(1, 4))
    sig = {"unified": dict(SURGE)}
    clock = [0.0]
    auto = c.auto(fleet, sig, clock, scale_up_cooldown=5.0,
                  scale_down_cooldown=30.0)
    c.tick(auto, fleet)                 # surge: target 1 -> 2, one launch
    assert fleet.targets["unified"] == 2
    assert [r for r, _ in fleet.launched] == ["unified"]
    c.tick(auto, fleet)                 # up-cooldown holds it
    assert fleet.targets["unified"] == 2 and len(fleet.launched) == 1
    clock[0] = 10.0
    c.tick(auto, fleet)                 # cooldown over, surge persists
    assert fleet.targets["unified"] == 3 and len(fleet.launched) == 2
    sig["unified"] = dict(MID)          # the hysteresis dead band
    clock[0] = 1000.0
    c.tick(auto, fleet)
    assert fleet.targets["unified"] == 3
    assert fleet.metrics.get("autoscale_up") == 2
    assert fleet.metrics.get("autoscale_down") == 0


def case_calm_drain(c):
    busy = c.rep("a:1", outstanding=3, node="replica:0")
    idle = c.rep("a:2", outstanding=0, node="replica:1")
    reg = c.registry([busy, idle])
    fleet = c.fleet(reg, {"unified": 2})
    clock = [100.0]
    auto = c.auto(fleet, {"unified": dict(CALM)}, clock,
                  scale_down_cooldown=0.0, drain_grace=1.0,
                  drain_timeout=60.0)
    c.tick(auto, fleet)                 # drain the LEAST-loaded
    assert fleet.targets["unified"] == 1 and reg.drained == ["a:2"]
    assert fleet.migrated == ["a:2"] and not fleet.killed
    clock[0] = 100.5
    c.tick(auto, fleet)                 # inside the grace window
    assert not fleet.killed
    idle.outstanding = 2                # work appears on a beat
    clock[0] = 105.0
    c.tick(auto, fleet)
    assert not fleet.killed
    idle.outstanding = 0
    clock[0] = 110.0
    c.tick(auto, fleet)                 # flushed + grace passed: reap
    assert fleet.killed == ["replica:1"]
    assert fleet.metrics.get("autoscale_kills") == 1
    c.tick(auto, fleet)
    assert reg.drained == ["a:2"]


def case_drain_timeout(c):
    reg = c.registry([c.rep("a:1", outstanding=9, node="replica:0"),
                      c.rep("a:2", outstanding=0, node="replica:1")])
    fleet = c.fleet(reg, {"unified": 2})
    clock = [0.0]
    auto = c.auto(fleet, {"unified": dict(CALM)}, clock,
                  scale_down_cooldown=0.0, drain_grace=0.5,
                  drain_timeout=30.0)
    c.tick(auto, fleet)
    assert reg.drained == ["a:2"]
    reg.reps[1].outstanding = 7         # the victim never flushes
    clock[0] = 29.0
    c.tick(auto, fleet)
    assert not fleet.killed
    clock[0] = 31.0
    c.tick(auto, fleet)                 # deadline passed: kill anyway
    assert fleet.killed == ["replica:1"]


def case_victim_death_mid_drain(c):
    a = c.rep("a:1", outstanding=0, node="replica:0")
    b = c.rep("a:2", outstanding=1, node="replica:1")
    reg = c.registry([a, b])
    fleet = c.fleet(reg, {"unified": 2})
    clock = [0.0]
    auto = c.auto(fleet, {"unified": dict(CALM)}, clock,
                  scale_down_cooldown=0.0, drain_grace=0.5)
    c.tick(auto, fleet)
    assert reg.drained == ["a:1"]
    a.state = c.pkg.registry.DEAD       # crashes mid-drain
    fleet._actual["unified"] = 1
    fleet.dead_nodes.add("replica:0")
    clock[0] = 10.0
    c.tick(auto, fleet)
    assert fleet.launched == []         # no spurious replacement
    assert fleet.metrics.get("autoscale_kills") == 1
    clock[0] = 20.0
    c.tick(auto, fleet)
    assert fleet.launched == [] and len(reg.drained) == 1


def case_unkillable_victim(c):
    noname = c.rep("a:1", outstanding=0, node="")
    reg = c.registry([noname, c.rep("a:2", outstanding=5,
                                    node="replica:1")])
    fleet = c.fleet(reg, {"unified": 2})
    clock = [0.0]
    auto = c.auto(fleet, {"unified": dict(CALM)}, clock,
                  scale_down_cooldown=0.0, drain_grace=0.5)
    c.tick(auto, fleet)
    assert reg.drained == ["a:1"]
    clock[0] = 10.0
    c.tick(auto, fleet)                 # flushed, but unkillable
    assert fleet.killed == [] and reg.drained == []
    assert noname.state == c.pkg.registry.ALIVE
    assert fleet.metrics.get("autoscale_kills") == 0
    assert fleet.metrics.get("autoscale_kill_failures") == 1


def case_bounds(c):
    reg = c.registry([c.rep("a:1")])
    fleet = c.fleet(reg, {"unified": 2}, bounds=(1, 2))
    clock = [0.0]
    auto = c.auto(fleet, {"unified": dict(SURGE)}, clock,
                  scale_up_cooldown=0.0, scale_down_cooldown=0.0)
    c.tick(auto, fleet)
    assert fleet.targets["unified"] == 2        # max bound holds
    warming = c.pkg.registry.WARMING
    fleet2 = c.fleet(c.registry([c.rep("b:1"), c.rep("b:2",
                                                      state=warming)]),
                     {"unified": 2})
    auto2 = c.auto(fleet2, {"unified": dict(CALM)}, clock,
                   scale_down_cooldown=0.0)
    c.tick(auto2, fleet2)
    assert fleet2.targets["unified"] == 1
    assert fleet2.registry.drained == []        # last alive never drains
    fleet3 = c.fleet(c.registry([c.rep("c:1")]), {"unified": 1})
    auto3 = c.auto(fleet3, {"unified": dict(CALM)}, clock,
                   scale_down_cooldown=0.0)
    c.tick(auto3, fleet3)
    assert fleet3.targets["unified"] == 1 and fleet3.registry.drained == []


def case_decode_headroom(c):
    reg = c.registry([c.rep("d:1", role="decode", node="decode:0"),
                      c.rep("d:2", role="decode", node="decode:1")])
    fleet = c.fleet(reg, {"decode": 2}, bounds=(1, 4))
    sig = {"decode": {"queue_wait_p99_ms": None, "util": 0.0,
                      "kv_headroom": 2.0}}
    clock = [0.0]
    auto = c.auto(fleet, sig, clock, scale_up_cooldown=0.0,
                  scale_down_cooldown=0.0, kv_headroom_lo=8.0,
                  kv_headroom_hi=64.0, drain_grace=0.0)
    c.tick(auto, fleet)                 # pages exhausted: scale up
    assert fleet.targets["decode"] == 3
    assert fleet.launched[0][0] == "decode"
    sig["decode"] = {"queue_wait_p99_ms": None, "util": 0.0,
                     "kv_headroom": 500.0}
    clock[0] = 100.0
    c.tick(auto, fleet)
    assert fleet.targets["decode"] == 2 and reg.drained


def case_converge_relaunch(c):
    reg = c.registry([c.rep("a:1")])
    fleet = c.fleet(reg, {"unified": 2})
    fleet._actual["unified"] = 1        # one task died
    auto = c.auto(fleet, {"unified": dict(MID)}, [0.0])
    c.tick(auto, fleet)
    assert fleet.targets["unified"] == 2 and len(fleet.launched) == 1
    assert fleet.metrics.get("autoscale_launches") == 1


def case_describe(c):
    reg = c.registry([c.rep("a:1"), c.rep("a:2",
                                          state=c.pkg.registry.WARMING)])
    fleet = c.fleet(reg, {"unified": 2}, bounds=(1, 8))
    auto = c.auto(fleet, {"unified": dict(MID)}, [0.0])
    d = auto.describe()["unified"]
    assert (d["target"], d["actual"], d["alive"], d["warming"], d["min"],
            d["max"]) == (2, 2, 1, 1, 1, 8)
    snap = fleet.metrics.snapshot()
    assert snap["gauges"]["autoscaler"]["unified"]["target"] == 2
    c.log.append(("describe", d, snap["gauges"]["autoscaler"]))


def case_default_signals(c):
    reg = c.registry([c.rep("a:1", outstanding=3, capacity=4),
                      c.rep("a:2", outstanding=1, capacity=4),
                      c.rep("d:1", role="decode", outstanding=0,
                            capacity=4)])
    reg.reps[2].kv_headroom = 40
    fleet = c.fleet(reg, {"unified": 2, "decode": 1})
    for _ in range(10):
        fleet.metrics.observe("queue_wait_ms", 4.0)
    a = c.pkg.autoscaler
    auto = a.FleetAutoscaler(fleet, a.AutoscalerConfig(), clock=lambda: 0.0)
    sig = auto._default_signals()
    assert sig["unified"]["queue_wait_p99_ms"] == 5.0   # bucket edge
    assert sig["unified"]["util"] == pytest.approx(0.5)
    assert sig["unified"]["alive"] == 2
    for _ in range(5):
        fleet.metrics.observe("queue_wait_ms", 700.0)
    sig2 = auto._default_signals()
    assert sig2["unified"]["queue_wait_p99_ms"] == 1000.0
    assert sig2["decode"]["kv_headroom"] == pytest.approx(40.0)
    assert sig2["decode"]["util"] == 0.0
    c.log.append(("signals", sig, sig2))


def case_kv_tier_pressure(c):
    reg = c.registry([c.rep("a:1"), c.rep("a:2")])
    fleet = c.fleet(reg, {"unified": 2}, bounds=(1, 4))
    sig = {"unified": dict(CALM, kv_occupancy=0.95, kv_hit_rate=0.6)}
    clock = [100.0]
    auto = c.auto(fleet, sig, clock, scale_up_cooldown=0.0,
                  scale_down_cooldown=0.0)
    c.tick(auto, fleet)                 # calm, but the tier is full
    assert fleet.targets["unified"] == 2 and not reg.drained
    sig["unified"]["kv_hit_rate"] = 0.05        # and thrashing
    clock[0] = 200.0
    c.tick(auto, fleet)
    assert fleet.targets["unified"] == 3
    sig["unified"] = dict(CALM, kv_occupancy=0.1, kv_hit_rate=0.9)
    clock[0] = 300.0
    c.tick(auto, fleet)
    assert fleet.targets["unified"] == 2
    sig["unified"] = dict(CALM, kv_occupancy=None, kv_hit_rate=None)
    clock[0] = 400.0
    c.tick(auto, fleet)
    assert fleet.targets["unified"] == 1


def case_kv_role_pinned(c):
    reg = c.registry([c.rep("k:1", role="kv"), c.rep("a:1")])
    fleet = c.fleet(reg, {"kv": 1, "m/kv": 1, "unified": 1}, bounds=(1, 4))
    sig = {"kv": dict(CALM), "m/kv": dict(SURGE), "unified": dict(MID)}
    clock = [100.0]
    auto = c.auto(fleet, sig, clock, scale_up_cooldown=0.0,
                  scale_down_cooldown=0.0)
    c.tick(auto, fleet)
    assert fleet.targets["kv"] == 1 and fleet.targets["m/kv"] == 1
    assert not reg.drained
    fleet._actual["kv"] = 0             # a crashed holder relaunches
    clock[0] = 200.0
    c.tick(auto, fleet)
    assert ("kv", "kv:0") in fleet.launched and fleet.targets["kv"] == 1


def case_default_signals_kv_tier(c):
    agg = {"replicas": 2, "sessions": 4, "ram_bytes_used": 900,
           "ram_bytes": 1000, "hits": 100, "misses": 100}

    class KvRegistry(FakeRegistry):
        def kv_tier_summary(self):
            return dict(agg)

    reg = c.registry([c.rep("a:1"), c.rep("a:2")], cls=KvRegistry)
    fleet = c.fleet(reg, {"unified": 2})
    a = c.pkg.autoscaler
    auto = a.FleetAutoscaler(fleet, a.AutoscalerConfig(), clock=lambda: 0.0)
    seen = [auto._default_signals()["unified"]]
    assert seen[-1]["kv_occupancy"] == pytest.approx(0.9)
    assert seen[-1]["kv_hit_rate"] == pytest.approx(0.5)
    agg.update(hits=130, misses=170)
    seen.append(auto._default_signals()["unified"])
    assert seen[-1]["kv_hit_rate"] == pytest.approx(0.3)
    agg.update(replicas=1, hits=60, misses=80, ram_bytes_used=400,
               ram_bytes=500)                   # a replica left
    seen.append(auto._default_signals()["unified"])
    assert seen[-1]["kv_hit_rate"] is None
    assert seen[-1]["kv_occupancy"] == pytest.approx(0.8)
    agg.update(replicas=0)
    seen.append(auto._default_signals()["unified"])
    assert seen[-1]["kv_occupancy"] is None \
        and seen[-1]["kv_hit_rate"] is None
    c.log.append(("signals", seen))


CASES = [case_surge, case_calm_drain, case_drain_timeout,
         case_victim_death_mid_drain, case_unkillable_victim, case_bounds,
         case_decode_headroom, case_converge_relaunch, case_describe,
         case_default_signals, case_kv_tier_pressure, case_kv_role_pinned,
         case_default_signals_kv_tier]


def run_case(case, side):
    c = Case(side)
    case(c)
    return c.log


@pytest.mark.parametrize("case", CASES, ids=lambda f: f.__name__[5:])
def test_port_autoscaler_decides_as_jax(case):
    port = run_case(case, "port")
    assert port, "the case logged no action"
    assert port == run_case(case, "jax")


def test_autoscaler_gauge_and_loop_thread():
    """``start`` runs ``step`` on the loop's own thread at the configured
    cadence, a failing tick does not end the loop, and ``stop`` joins."""
    c = Case("port")
    reg = c.registry([c.rep("a:1")])
    fleet = c.fleet(reg, {"unified": 1}, bounds=(1, 2))
    calls = []

    def signals():
        calls.append(time.monotonic())
        if len(calls) == 2:
            raise RuntimeError("one broken tick")
        return {"unified": dict(SURGE)}

    a = c.pkg.autoscaler
    auto = a.FleetAutoscaler(fleet, a.AutoscalerConfig(interval=0.02),
                             signals=signals).start()
    try:
        deadline = time.monotonic() + 5.0
        while len(calls) < 4 and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        auto.stop()
    assert len(calls) >= 4 and auto._thread is None
    assert fleet.targets["unified"] == 2 and len(fleet.launched) == 1


# -- end to end on the CPU ----------------------------------------------------


NEW = 4
SHAPE = dict(tiny=True, max_len=64, page_size=16, prefill_bucket=16,
             device="cpu", request_timeout=120.0, start_timeout=120.0,
             heartbeat_interval=0.1)


def _prompts(n=8, seed=5):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 97, rng.randint(3, 30)).tolist()
            for _ in range(n)]


def _in_process(prompts):
    """The port's ContinuousBatcher in this process, built as a replica
    builds it."""
    from tfmesos_tpu_torch.fleet import replica
    from tfmesos_tpu_torch.serving import Request

    args = replica.build_parser().parse_args(
        ["--tiny", "--device", "cpu", "--rows", "2", "--max-len", "64",
         "--page-size", "16", "--prefill-bucket", "16"])
    batcher = replica.build_batcher(args)
    done = {c.rid: list(c.tokens) for c in batcher.run(
        [Request(np.asarray(p, np.int32), NEW) for p in prompts])}
    return [done[rid] for rid in sorted(done)]


def test_cpu_fleet_grows_under_a_surge_and_drains_back():
    """A tiny port fleet (``autoscale=True``, bounds [1, 2]) with an
    injected surge: the loop launches one replica, which registers
    warming (never routed), goes alive and serves; on the calm the loop
    drains, migrates and kills back to one replica.  No request fails
    and every completion equals the in-process batcher's."""
    from tfmesos_tpu_torch.fleet import AutoscalerConfig, FleetServer

    prompts = _prompts()
    want = _in_process(prompts)
    sig = {"unified": dict(CALM)}
    fleet = FleetServer(replicas=1, rows=2, warmup=True, autoscale=True,
                        min_replicas=1, max_replicas=2,
                        autoscale_config=AutoscalerConfig(
                            interval=0.05, scale_up_cooldown=0.0,
                            scale_down_cooldown=0.0, drain_grace=0.3),
                        **SHAPE).start()
    try:
        auto = fleet.autoscaler
        assert isinstance(auto._signals(), dict)   # the windowed source
        auto._signals = lambda: {k: dict(v) for k, v in sig.items()}
        (first,) = [r.addr for r in fleet.registry.alive()]
        client = fleet.client(timeout=120.0)
        assert client.generate(prompts[0], NEW)["tokens"] == want[0]
        sig["unified"] = dict(SURGE)
        deadline = time.monotonic() + 60.0
        while not fleet.registry.warming() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert fleet.targets["unified"] == 2
        assert fleet.tier_actual("unified") == 2
        while len(fleet.registry.alive()) < 2 \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        alive = {r.addr for r in fleet.registry.alive()}
        assert len(alive) == 2 and first in alive
        got, errors = [None] * len(prompts), []

        def one(i):
            try:
                got[i] = client.generate(prompts[i], NEW)["tokens"]
            except Exception as e:     # noqa: BLE001 - asserted below
                errors.append(e)

        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120.0)
        assert not errors and got == want
        sig["unified"] = dict(CALM)
        deadline = time.monotonic() + 60.0
        while (fleet.tier_actual("unified") > 1
               or len(fleet.registry.alive()) > 1) \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        assert fleet.tier_actual("unified") == 1
        assert len(fleet.registry.alive()) == 1
        assert client.generate(prompts[1], NEW)["tokens"] == want[1]
        snap = client.metrics()
        client.close()
    finally:
        fleet.stop()
    c = snap["counters"]
    assert (c.get("autoscale_up"), c.get("autoscale_launches"),
            c.get("autoscale_drains"), c.get("autoscale_kills")) \
        == (1, 1, 1, 1)
    assert c.get("migrations_requested") == 1
    assert c.get("failed", 0) == 0 and c.get("shed_queue", 0) == 0
    gauge = snap["gauges"]["autoscaler"]["unified"]
    assert (gauge["target"], gauge["actual"], gauge["min"],
            gauge["max"]) == (1, 1, 1, 2)
    assert fleet.autoscaler is None
