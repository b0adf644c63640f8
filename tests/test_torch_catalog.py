"""The port's model catalog, trader, cold-start wait and catalog gateway
against the JAX package's.

* Catalog validation and key round trips: the same inputs through both
  packages' ``ModelSpec`` / ``ModelCatalog`` / ``model_key`` /
  ``split_key`` give the same results or the same errors.
* ``ModelTrader`` on the stub trade fleet of ``tests/test_catalog.py``
  (fake clock and signals): each case returns the action log (targets,
  launches, adoptions, kills, drains, and after each tick the targets
  and counters); the two logs must be equal and each case checks its
  own expected sequence.
* The router's cold-start wait, the gateway's catalog resolve, the
  ``swap_adapter`` op and a warm-pool adoption over stub replicas (the
  port's ``ReplicaServer`` with a scripted handler serves both
  packages' control planes: the wire is shared): replies and counters
  equal.
* One tiny CPU catalog fleet of real processes: the cold model's first
  request is served by the warm-pool replica after adoption, with the
  tokens of the port's in-process batcher of that preset.
"""

import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from test_torch_front_door import Env, _wait, control_plane, failed

from tfmesos_tpu_torch import wire
from tfmesos_tpu_torch.fleet.replica import ReplicaServer


def package(side: str) -> SimpleNamespace:
    if side == "jax":
        from tfmesos_tpu.fleet import autoscaler, catalog, metrics, registry
    else:
        from tfmesos_tpu_torch.fleet import (autoscaler, catalog, metrics,
                                             registry)
    return SimpleNamespace(autoscaler=autoscaler, catalog=catalog,
                           metrics=metrics, registry=registry)


def outcome(fn):
    """What ``fn`` returned, or the class and message of what it
    raised."""
    try:
        return ("ok", fn())
    except Exception as e:     # noqa: BLE001 - the error is the result
        return ("raised", type(e).__name__, str(e))


# -- catalog validation and keys ----------------------------------------------


SPECS = [
    dict(model_id="chat-7b.v2"), dict(model_id="A" * 64),
    dict(model_id=""), dict(model_id="a" * 65), dict(model_id="-lead"),
    dict(model_id="has space"), dict(model_id="a;rm -rf"),
    dict(model_id="v1\n"), dict(model_id="a/b"), dict(model_id=None),
    dict(model_id=7), dict(model_id="ok", replicas=-1),
    dict(model_id="ok", floor=-1), dict(model_id="ok", replicas=2, floor=3),
    dict(model_id="ok", replicas=0, floor=3),
    dict(model_id="ok", gang_size=0), dict(model_id="ok", replicas=0),
    dict(model_id="ok", seed=7, scale_to_zero=False, floor=1)]


@pytest.mark.parametrize("kw", SPECS, ids=lambda kw: repr(kw)[:40])
def test_model_spec_validation_matches_jax(kw):
    def build(side):
        spec = package(side).catalog.ModelSpec(**kw)
        return {f: getattr(spec, f) for f in (
            "model_id", "replicas", "seed", "floor", "scale_to_zero",
            "gang_size")}

    mine = outcome(lambda: build("port"))
    assert mine == outcome(lambda: build("jax"))


def test_catalog_resolve_and_keys_match_jax():
    def run(side):
        cat = package(side).catalog
        out = []
        c = cat.ModelCatalog([cat.ModelSpec("chat", replicas=2, seed=0),
                              cat.ModelSpec("code", replicas=1, seed=1)])
        out.append((c.default_id, c.ids(), len(c),
                    [s.model_id for s in c]))
        for label in (None, "", "code", "chat", "nope"):
            out.append(outcome(lambda label=label: c.resolve(label)))
        out.append(outcome(lambda: cat.ModelCatalog([])))
        out.append(outcome(lambda: cat.ModelCatalog(
            [cat.ModelSpec("a"), cat.ModelSpec("a")])))
        for key in (cat.model_key("m1"), "unified", "m.v2/decode",
                    cat.POOL_KEY, cat.model_key("m", "prefill")):
            out.append((key, cat.split_key(key)))
        out.append((cat.POOL, cat.POOL_KEY))
        reg = package(side).registry
        reps = [reg.ReplicaInfo(addr="a", model_id="m1"),
                reg.ReplicaInfo(addr="b", model_id="m2"),
                reg.ReplicaInfo(addr="p", warm_pool=True)]
        for key in (cat.model_key("m1"), cat.POOL_KEY, "unified"):
            out.append([r.addr for r in cat.filter_members(reps, key)])
        for v in ("chat-7b.v2", "", "a\nb", None, "x" * 64):
            out.append(outcome(lambda v=v: cat.validate_model_id(v)))
        return out

    mine = run("port")
    assert mine[0] == ("chat", ["chat", "code"], 2, ["chat", "code"])
    assert mine[1:4] == [("ok", "chat"), ("ok", "chat"), ("ok", "code")]
    assert mine[5][:2] == ("raised", "KeyError")
    assert mine == run("jax")


def test_gang_replicas_are_refused_naming_their_item():
    """A catalog entry of ``gang_size > 1`` waits for gang replicas
    (ROADMAP A.9): refused with ``NotPorted`` by the spec and so by the
    fleet; JAX takes it."""
    from tfmesos_tpu.fleet.catalog import ModelSpec as JaxSpec
    from tfmesos_tpu_torch.fleet.catalog import ModelSpec, NotPorted
    from tfmesos_tpu_torch.fleet.launcher import FleetServer

    assert JaxSpec("a", gang_size=2).gang_size == 2
    with pytest.raises(NotPorted, match=r"gang replicas \(ROADMAP A\.9\)"):
        ModelSpec("a", gang_size=2)
    with pytest.raises(NotPorted, match=r"ROADMAP A\.9"):
        FleetServer(models=[ModelSpec("a"), ModelSpec("b", gang_size=3)])
    assert ModelSpec("a", gang_size=1).gang_size == 1


# -- the trader on a stub fleet -----------------------------------------------


class TradeRegistry:
    def __init__(self, log, reps=()):
        self.log = log
        self.reps = list(reps)
        self.drained = []

    def members(self, role=None, model=None):
        return [r for r in self.reps
                if (role is None or (r.role or "unified") == role)
                and (model is None or r.model_id == model)]

    def begin_drain(self, addr, pinned=True):
        for r in self.reps:
            if r.addr == addr:
                r.state = "draining"
                self.drained.append(addr)
                self.log.append(("drain", addr))
                return True
        return False

    def clear_drain(self, addr):
        self.log.append(("clear_drain", addr))

    def set_target(self, key, n):
        pass

    def role_summary(self):
        return {}


class TradeFleet:
    """The trader's fleet surface over an in-memory registry."""

    def __init__(self, pkg, log, reg, targets, budget):
        self.pkg, self.log = pkg, log
        self.registry = reg
        self.metrics = pkg.metrics.FleetMetrics()
        self.targets = dict(targets)
        self.replica_budget = budget
        self.scale_lock = threading.RLock()
        self.launched, self.adopted, self.killed = [], [], []
        self._actual = dict(targets)
        self.adopt_ok = True

    def set_target(self, key, n):
        self.log.append(("target", key, n))
        self.targets[key] = n

    def bounds(self, key):
        return (0, self.replica_budget)

    def tier_members(self, key):
        cat = self.pkg.catalog
        _, role = cat.split_key(key)
        return cat.filter_members(self.registry.members(role), key)

    def launch_replica(self, key, weights_version=None):
        node = f"{key}:{len(self.launched)}"
        self.log.append(("launch", key, node))
        self.launched.append(key)
        self._actual[key] = self._actual.get(key, 0) + 1
        return node

    def adopt_replica(self, addr, model_id):
        self.log.append(("adopt", addr, model_id, self.adopt_ok))
        if not self.adopt_ok:
            return False
        cat = self.pkg.catalog
        self.adopted.append((addr, model_id))
        key = cat.model_key(model_id)
        self._actual[key] = self._actual.get(key, 0) + 1
        self._actual[cat.POOL_KEY] = self._actual.get(cat.POOL_KEY, 1) - 1
        for r in self.registry.reps:
            if r.addr == addr:
                r.warm_pool = False
                r.model_id = model_id
        return True

    def kill_replica(self, node):
        self.log.append(("kill", node))
        self.killed.append(node)
        return True

    def tier_actual(self, key):
        return self._actual.get(key, 0)


HOT = {"queue_wait_p99_ms": 5000.0, "util": 1.0, "samples": 50}
WARM = {"queue_wait_p99_ms": 100.0, "util": 0.4, "samples": 5}
IDLE = {"queue_wait_p99_ms": None, "util": 0.0, "samples": 0}


class TradeCase:
    def __init__(self, side):
        self.pkg = package(side)
        self.cat = self.pkg.catalog
        self.log = []

    def rep(self, addr, model_id="", pool=False, kv_tier=None):
        reg = self.pkg.registry
        return reg.ReplicaInfo(addr=addr, state=reg.ALIVE, outstanding=0,
                               capacity=4, model_id=model_id, warm_pool=pool,
                               node=addr, kv_tier=kv_tier)

    def fleet(self, reps, targets, budget):
        reg = TradeRegistry(self.log, reps)
        return reg, TradeFleet(self.pkg, self.log, reg, targets, budget)

    def trader(self, fleet, specs, sig, clock, **tcfg):
        cfg = self.pkg.autoscaler.AutoscalerConfig(scale_up_cooldown=0.0,
                                                   scale_down_cooldown=0.0)
        return self.cat.ModelTrader(
            fleet, self.cat.ModelCatalog(specs), cfg,
            trader_config=self.cat.TraderConfig(**tcfg),
            signals=lambda: {k: dict(v) for k, v in sig.items()},
            clock=lambda: clock[0])

    def tick(self, tr, fleet):
        tr.step()
        self.log.append(("tick", dict(sorted(fleet.targets.items())),
                         dict(fleet.metrics.snapshot()["counters"])))


def trade_at_budget(c):
    cat = c.cat
    ka, kb = cat.model_key("a"), cat.model_key("b")
    reg, fleet = c.fleet([c.rep(f"a:{i}", "a") for i in range(3)]
                         + [c.rep("b:0", "b")], {ka: 3, kb: 1}, 4)
    clock = [100.0]
    tr = c.trader(fleet, [cat.ModelSpec("a", replicas=3),
                          cat.ModelSpec("b", replicas=1)],
                  {ka: dict(WARM), kb: dict(HOT)}, clock,
                  trade_cooldown_s=5.0)
    clock[0] += 10.0
    c.tick(tr, fleet)
    assert fleet.targets == {ka: 2, kb: 2}
    assert fleet.metrics.get("model_trades") == 1
    assert len(reg.drained) == 1 and reg.drained[0].startswith("a:")
    assert kb in fleet.launched
    c.tick(tr, fleet)                   # the trade cooldown holds
    assert fleet.metrics.get("model_trades") == 1
    clock[0] += 10.0
    c.tick(tr, fleet)
    assert fleet.targets == {ka: 1, kb: 3}
    clock[0] += 10.0
    c.tick(tr, fleet)                   # a at its live bound: blocked
    assert fleet.targets == {ka: 1, kb: 3}
    assert fleet.metrics.get("model_trade_blocked") >= 1
    c.log.append(("describe", tr.describe()))


def scale_to_zero_then_adopt(c):
    cat = c.cat
    ka = cat.model_key("a")
    reg, fleet = c.fleet([c.rep("a:0", "a"), c.rep("p:0", pool=True)],
                         {ka: 1, cat.POOL_KEY: 1}, 2)
    clock = [0.0]
    tr = c.trader(fleet, [cat.ModelSpec("a", replicas=1,
                                        scale_to_zero=True)],
                  {ka: dict(IDLE), cat.POOL_KEY: {"alive": 1}}, clock,
                  zero_after_ticks=3)
    for _ in range(2):
        clock[0] += 1.0
        c.tick(tr, fleet)
    assert fleet.targets[ka] == 1
    clock[0] += 1.0
    c.tick(tr, fleet)                   # the third idle tick
    assert fleet.targets[ka] == 0 and reg.drained == ["a:0"]
    assert fleet.metrics.get("model_scale_to_zero") == 1
    fleet._actual[ka] = 0               # reaped
    reg.reps = [r for r in reg.reps if r.addr != "a:0"]
    assert tr.demand("a")               # the router's cold-start hook
    assert fleet.targets[ka] == 1 and fleet.adopted == [("p:0", "a")]
    assert fleet.launched == []
    assert fleet.metrics.get("model_cold_starts") == 1
    assert fleet.metrics.get("model_adoptions") == 1
    assert tr.demand("unknown-model") is False
    c.log.append(("describe", tr.describe()))


def demand_launches_when_adoption_fails(c):
    cat = c.cat
    ka = cat.model_key("a")
    reg, fleet = c.fleet([c.rep("b:0", "b"), c.rep("p:0", pool=True)],
                         {ka: 0, cat.model_key("b"): 1, cat.POOL_KEY: 1}, 2)
    fleet.adopt_ok = False
    tr = c.trader(fleet, [cat.ModelSpec("b"), cat.ModelSpec("a", replicas=0)],
                  {}, [0.0])
    assert tr.demand("a")               # the pool slot is traded
    assert fleet.targets[cat.POOL_KEY] == 0 and fleet.targets[ka] == 1
    assert fleet.launched == [ka]       # the adoption refused: cold launch


def tiebreak_parked_disk(c):
    cat = c.cat
    ka, kb, kc = (cat.model_key(m) for m in "abc")
    disk = {"disk": True, "sessions": ["s1", "s2", "s3"]}
    ram = {"disk": False, "sessions": ["s4", "s5", "s6"]}
    reg, fleet = c.fleet([c.rep("a:0", "a"),
                          c.rep("b:0", "b", kv_tier=ram), c.rep("b:1", "b"),
                          c.rep("c:0", "c", kv_tier=disk),
                          c.rep("c:1", "c")], {ka: 1, kb: 2, kc: 2}, 5)
    clock = [100.0]
    tr = c.trader(fleet, [cat.ModelSpec("a", replicas=1),
                          cat.ModelSpec("b", replicas=2),
                          cat.ModelSpec("c", replicas=2)],
                  {ka: dict(HOT), kb: dict(WARM), kc: dict(WARM)}, clock)
    clock[0] += 10.0
    c.tick(tr, fleet)
    assert (fleet.targets[ka], fleet.targets[kb], fleet.targets[kc]) \
        == (2, 2, 1)


def tiebreak_resuming_tier(c):
    cat = c.cat
    ka, kb, kc = (cat.model_key(m) for m in "abc")
    reg, fleet = c.fleet([c.rep("a:0", "a"), c.rep("b:0", "b"),
                          c.rep("b:1", "b"), c.rep("c:0", "c"),
                          c.rep("c:1", "c")], {ka: 1, kb: 2, kc: 2}, 5)
    clock = [100.0]
    tr = c.trader(fleet, [cat.ModelSpec("a", replicas=1),
                          cat.ModelSpec("b", replicas=2),
                          cat.ModelSpec("c", replicas=2)],
                  {ka: dict(HOT), kb: dict(WARM, kv_hit_rate=0.9),
                   kc: dict(WARM, kv_hit_rate=0.0)}, clock)
    clock[0] += 10.0
    c.tick(tr, fleet)
    assert (fleet.targets[ka], fleet.targets[kb], fleet.targets[kc]) \
        == (2, 2, 1)


def windowed_signals(c):
    cat = c.cat
    ka = cat.model_key("a")
    tier0 = {"counters": {"hits": 10, "misses": 30}}
    tier1 = {"counters": {"hits": 5, "misses": 5}}
    reg, fleet = c.fleet([c.rep("a:0", "a", kv_tier=tier0),
                          c.rep("a:1", "a", kv_tier=tier1)], {ka: 2}, 3)
    for ms in (4.0, 4.0, 700.0):
        fleet.metrics.observe("queue_wait_ms_model_a", ms)
    tr = cat.ModelTrader(fleet, cat.ModelCatalog([cat.ModelSpec("a", 2)]),
                         c.pkg.autoscaler.AutoscalerConfig(),
                         trader_config=cat.TraderConfig(),
                         clock=lambda: 0.0)
    seen = [tr._model_signals()[ka]]
    assert seen[-1]["kv_hit_rate"] is None and seen[-1]["samples"] == 3
    tier0["counters"] = {"hits": 10, "misses": 70}
    fleet.metrics.observe("queue_wait_ms_model_a", 4.0)
    seen.append(tr._model_signals(advance=False)[ka])   # the peek
    assert seen[-1]["kv_hit_rate"] == pytest.approx(0.0)
    seen.append(tr._model_signals()[ka])
    assert seen[-1]["kv_hit_rate"] == pytest.approx(0.0)
    assert seen[-1]["samples"] == 1
    reg.reps = [r for r in reg.reps if r.addr != "a:0"]
    seen.append(tr._model_signals()[ka])
    assert seen[-1]["kv_hit_rate"] is None
    tier1["counters"] = {"hits": 25, "misses": 5}
    seen.append(tr._model_signals()[ka])
    assert seen[-1]["kv_hit_rate"] == pytest.approx(1.0)
    c.log.append(("signals", seen))


TRADE_CASES = [trade_at_budget, scale_to_zero_then_adopt,
               demand_launches_when_adoption_fails, tiebreak_parked_disk,
               tiebreak_resuming_tier, windowed_signals]


@pytest.mark.parametrize("case", TRADE_CASES, ids=lambda f: f.__name__)
def test_port_trader_decides_as_jax(case):
    def run(side):
        c = TradeCase(side)
        case(c)
        return c.log

    port = run("port")
    assert port, "the case logged no action"
    assert port == run("jax")


# -- router, gateway and adoption over stub replicas --------------------------


def model_stub(env, model_id, tokens, pool=False):
    """A stub replica advertising ``model_id`` (and optionally warm-pool
    membership): canned completions, ``adopt`` flips its advertised
    identity, ``swap_adapter`` raw frames are kept and acked."""
    state = {"model_id": model_id, "pool": pool, "adapter_version": "",
             "swaps": []}

    def handler(msg, reply):
        raw = isinstance(msg, wire.RawFrame)
        head = msg.meta if raw else msg
        op = head.get("op")
        if op == "adopt":
            state.update(model_id=head.get("model_id"), pool=False)
            reply({"op": "adopted", "id": head.get("id"),
                   "model_id": state["model_id"]})
            return
        if op == "swap_adapter":
            state["swaps"].append(bytes(msg.body))
            state["adapter_version"] = head.get("adapter_version")
            reply({"op": "adapter_swapped", "id": head.get("id"),
                   "adapter_version": state["adapter_version"]})
            return
        want = head.get("model")
        if isinstance(want, str) and want and want != state["model_id"]:
            reply({"op": "error", "id": head.get("id"),
                   "kind": "wrong_model",
                   "error": f"serving {state['model_id']}"})
            return
        reply({"op": "completion", "id": head.get("id"),
               "tokens": list(tokens), "ttft_ms": 1.0, "total_ms": 2.0})

    def extra():
        beat = {"adapter_version": state["adapter_version"],
                "warm_pool": state["pool"]}
        if state["model_id"]:
            beat["model_id"] = state["model_id"]
        return beat

    server = ReplicaServer(handler, token=env.token, capacity=4,
                           registry_addr=env.reg.addr,
                           heartbeat_interval=0.05, extra_info=extra)
    server.model_state = state
    return env.serve(server)


def catalog_of(env, *specs):
    cat = package(env.cp.side).catalog
    return cat.ModelCatalog([cat.ModelSpec(*s) for s in specs])


def case_await_model(env):
    """A request for a model with no replica fires the demand hook once
    and waits for the replica it brings, instead of failing."""
    router = env.router()
    demands = []

    def demand(model):
        demands.append(model)
        model_stub(env, "m9", (4, 2))
        return True

    router.on_model_demand = demand
    router.model_wait_s = 10.0
    out = router.route({"op": "generate", "prompt": [1], "_model": "m9"})
    assert out["tokens"] == [4, 2] and demands == ["m9"]
    # An unknown model (the hook says no) fails at once, naming it.
    router.on_model_demand = lambda model: demands.append(model) or False
    lost = failed(lambda: router.route({"op": "generate", "prompt": [1],
                                        "_model": "m0"}))
    assert lost["raised"] == "RoutingError" and demands == ["m9", "m0"]
    counters = env.counters()
    assert counters["model_cold_waits"] == 2
    return {"tokens": out["tokens"], "lost": lost, "demands": demands,
            "counters": counters}


def case_gateway_catalog_resolve(env):
    """Labels resolve against the catalog: absent rides the default,
    unknown and malformed are ``bad_request``; each model's requests
    land on its replicas; the per-tenant x model meters count."""
    model_stub(env, "chat", (1, 1))
    model_stub(env, "code", (2, 2))
    assert _wait(lambda: len(env.reg.alive()) == 2
                 and all(r.model_id for r in env.reg.alive()))
    gw = env.gateway(env.router())
    gw.catalog = catalog_of(env, ("chat", 1), ("code", 1, 1))
    client = env.client(gw)
    got = [client.generate([5, 6, 7], 2)["tokens"],
           client.generate([5, 6], 2, model="code",
                           priority="tenantX")["tokens"],
           client.generate([5], 2, model="chat")["tokens"]]
    assert got == [[1, 1], [2, 2], [1, 1]]
    bad = [failed(lambda m=m: client.generate([5], 2, model=m))
           for m in ("never-listed", "bad;id")]
    assert [b["kind"] for b in bad] == ["bad_request", "bad_request"]
    counters = env.counters()
    assert counters["metering_prompt_tokens_default_chat"] == 4
    assert counters["metering_decode_tokens_default_code"] == 2
    return {"got": got, "bad": bad, "counters": counters}


def case_gateway_swap_adapter(env):
    """The ``swap_adapter`` op: refused without a catalog control plane,
    malformed ids and deltas are ``bad_request`` before anything runs,
    an unknown model (KeyError) ``bad_request``, a failing control plane
    ``swap_failed``; a good one ships the delta as one raw frame a
    replica, byte for byte, and answers with the control plane's
    summary."""
    cat = package(env.cp.side).catalog
    a = model_stub(env, "chat", (1,))
    b = model_stub(env, "chat", (1,))
    assert _wait(lambda: len(env.reg.alive()) == 2)
    router = env.router()
    gw = env.gateway(router)
    client = env.client(gw)
    delta = {"layers/wq": np.arange(12, dtype=np.float32).reshape(3, 4),
             "embed": np.ones((2, 2), np.float16)}
    out = [failed(lambda: client.swap_adapter("chat", "d1", delta))]
    gw.catalog = catalog_of(env, ("chat", 2))
    calls = []

    def swap_fn(model_id, version, meta, body):
        calls.append((model_id, version, sorted(meta["adapter"]), len(body)))
        gw.catalog.get(model_id)              # KeyError on unknown
        if version == "boom":
            raise RuntimeError("a replica refused the fold")
        for r in sorted(env.reg.members(model=model_id),
                        key=lambda r: r.addr):
            call = dict(meta, op="swap_adapter", model_id=model_id,
                        adapter_version=version)
            reply = router.control_raw(r.addr, call, body, timeout=10.0)
            assert reply["op"] == "adapter_swapped"
        return {"model_id": model_id, "adapter_version": version,
                "replicas": 2}

    gw.swap_adapter_fn = swap_fn
    for model, version in (("bad;id", "d1"), ("chat", "bad version"),
                           ("nope", "d1"), ("chat", "boom")):
        out.append(failed(lambda m=model, v=version:
                          client.swap_adapter(m, v, delta)))
    link = client._connection()
    for bad in ({"paths": ["p"]}, "not a dict",
                dict(cat.encode_adapter_fields(delta), sizes=[1])):
        reply = link.call({"op": "swap_adapter", "model_id": "chat",
                           "adapter_version": "d1", "delta": bad},
                          timeout=10.0)
        out.append((reply.get("op"), reply.get("kind")))
    ok = client.swap_adapter("chat", "d1", delta)
    ok = {k: v for k, v in ok.items() if k != "id"}
    assert ok["ok"] and ok["replicas"] == 2
    body = cat.pack_adapter(delta)[1]
    assert a.model_state["swaps"] == [body] == b.model_state["swaps"]
    assert [o["kind"] for o in out[:5]] == [
        "bad_request", "bad_request", "bad_request", "bad_request",
        "swap_failed"]
    assert [o[1] for o in out[5:]] == ["bad_request"] * 3
    assert [c[:2] for c in calls] == [("nope", "d1"), ("chat", "boom"),
                                      ("chat", "d1")]
    return {"out": out, "ok": ok, "calls": calls}


def case_warm_pool_adoption(env):
    """A request for a scaled-to-zero model: the router's demand hook
    runs the trader, which adopts the warm-pool stub; the request
    completes there, and the hot model's replica never serves it."""
    pkg = package(env.cp.side)
    cat = pkg.catalog
    model_stub(env, "hot", (3,))
    pool = model_stub(env, "", (9,), pool=True)
    assert _wait(lambda: len(env.reg.alive()) == 2 and env.reg.has_pool())
    router = env.router()
    catalog = catalog_of(env, ("hot", 1), ("cold", 0, 1))
    reg = env.reg
    metrics = env.metrics

    class Fleet:
        registry = reg
        scale_lock = threading.RLock()
        targets = {cat.model_key("hot"): 1, cat.POOL_KEY: 1}
        replica_budget = 2

        def __init__(self):
            self.metrics = metrics

        def set_target(self, key, n):
            self.targets[key] = n

        def bounds(self, key):
            return (0, 2)

        def tier_members(self, key):
            _, role = cat.split_key(key)
            return cat.filter_members(reg.members(role), key)

        def tier_actual(self, key):
            return len([r for r in self.tier_members(key)
                        if r.state != "dead"])

        def adopt_replica(self, addr, model_id):
            spec = catalog.get(model_id)
            reply = router.control(addr, {"op": "adopt",
                                          "model_id": spec.model_id,
                                          "seed": spec.seed}, timeout=10.0)
            return reply.get("op") == "adopted"

        def launch_replica(self, key, weights_version=None):
            raise AssertionError("a cold start must adopt, not launch")

        def kill_replica(self, node):
            return True

    fleet = Fleet()
    trader = cat.ModelTrader(fleet, catalog)
    router.on_model_demand = trader.demand
    router.model_wait_s = 10.0
    gw = env.gateway(router)
    gw.catalog = catalog
    client = env.client(gw, timeout=30.0)
    got = [client.generate([1, 2], 1, model="cold")["tokens"],
           client.generate([1], 1, model="hot")["tokens"],
           client.generate([1], 1, model="cold")["tokens"]]
    assert got == [[9], [3], [9]]
    assert pool.model_state["model_id"] == "cold"
    counters = env.counters()
    assert counters["model_cold_waits"] == 1
    assert counters["model_cold_starts"] == 1
    assert counters["model_adoptions"] == 1
    return {"got": got, "targets": dict(sorted(fleet.targets.items())),
            "counters": {k: v for k, v in counters.items()
                         if k != "breaker_probe"}}


STUB_CASES = [case_await_model, case_gateway_catalog_resolve,
              case_gateway_swap_adapter, case_warm_pool_adoption]


def run_stub_case(case, side):
    env = Env(control_plane(side))
    try:
        return case(env)
    finally:
        env.close()


@pytest.mark.parametrize("case", STUB_CASES, ids=lambda c: c.__name__[5:])
def test_port_catalog_control_plane_equals_jax(case):
    assert run_stub_case(case, "port") == run_stub_case(case, "jax")


# -- a catalog fleet of real processes on the CPU -----------------------------


SHAPE = dict(tiny=True, max_len=64, page_size=16, prefill_bucket=16,
             device="cpu", request_timeout=120.0, start_timeout=120.0,
             heartbeat_interval=0.1)


def _in_process(prompts, seed, new):
    from tfmesos_tpu_torch.models.presets import tiny_model
    from tfmesos_tpu_torch.serving import ContinuousBatcher, Request

    cfg, params = tiny_model(seed)
    batcher = ContinuousBatcher(cfg, params, rows=2, max_len=64,
                                page_size=16, prefill_bucket=16,
                                device="cpu")
    done = {c.rid: list(c.tokens) for c in batcher.run(
        [Request(np.asarray(p, np.int32), new) for p in prompts])}
    return [done[rid] for rid in sorted(done)]


def test_cpu_catalog_fleet_adopts_the_cold_model():
    """``FleetServer(models=[chat seed 0 on 1, code seed 7 on 0],
    warm_pool=1, model_budget=2)``: unlabeled and ``chat`` requests give
    the seed-0 batcher's tokens; the first ``code`` request waits while
    the trader adopts the pool replica (no launch), then it and the next
    give the seed-7 batcher's tokens; a ``swap_adapter`` through the
    gateway folds into ``chat`` and nothing else."""
    from tfmesos_tpu_torch.fleet import FleetServer, ModelSpec

    rng = np.random.RandomState(11)
    prompts = [rng.randint(0, 97, rng.randint(3, 30)).tolist()
               for _ in range(3)]
    chat = _in_process(prompts, 0, 4)
    code = _in_process(prompts, 7, 4)
    assert chat != code
    fleet = FleetServer(models=[ModelSpec("chat", replicas=1, seed=0),
                                ModelSpec("code", replicas=0, seed=7)],
                        warm_pool=1, model_budget=2, rows=2, warmup=True,
                        **SHAPE).start()
    try:
        assert fleet.targets == {"chat/unified": 1, "code/unified": 0,
                                 "_pool/unified": 1}
        assert fleet.tier_actual("_pool/unified") == 1
        launched = []
        launch = fleet.launch_replica
        fleet.launch_replica = lambda *a, **k: launched.append(a) or \
            launch(*a, **k)
        client = fleet.client(timeout=120.0)
        got_chat = [client.generate(prompts[0], 4)["tokens"],
                    client.generate(prompts[1], 4, model="chat")["tokens"]]
        got_code = [client.generate(p, 4, model="code")["tokens"]
                    for p in prompts]
        assert got_chat == chat[:2] and got_code == code
        assert not launched
        assert fleet.targets["code/unified"] == 1
        assert fleet.targets["_pool/unified"] == 0
        assert fleet.tier_actual("code/unified") == 1
        assert fleet.tier_actual("_pool/unified") == 0
        delta = {"embed": np.full((97, 32), 0.5, np.float32)}
        out = client.swap_adapter("chat", "a1", delta)
        assert out["replicas"] == 1 and out["adapter_version"] == "a1"
        with pytest.raises(Exception) as e:
            client.swap_adapter("nope", "a1", delta)
        assert getattr(e.value, "kind", None) == "bad_request"
        assert client.generate(prompts[0], 4, model="code")["tokens"] \
            == code[0]
        assert _wait(lambda: [r.adapter_version for r in
                              fleet.registry.members(model="chat")]
                     == ["a1"])
        snap = client.metrics()
        client.close()
    finally:
        fleet.stop()
    c = snap["counters"]
    assert (c["model_cold_waits"], c["model_cold_starts"],
            c["model_adoptions"], c["adapter_swaps"]) == (1, 1, 1, 1)
    assert c["metering_decode_tokens_default_code"] == 16
    models = snap["gauges"]["models"]
    assert models["chat"]["adapters"] == {"a1": 1}
    assert models["code"]["adapters"] == {"": 1}
