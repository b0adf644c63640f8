"""The port's control plane against the JAX one, over stub replicas.

Each case builds a registry, a router and (where the case needs one) a
gateway from one package — the JAX package's ``tfmesos_tpu.fleet`` or
the port's ``tfmesos_tpu_torch.fleet`` — in front of the same stub
replicas (the port's ``ReplicaServer`` with a scripted handler: the wire
is byte-compatible, so one stub type serves both), and returns what a
client saw: replies, error kinds, picks and the metrics counters.  The
two runs must be equal, and each case also checks its own expectations
so that two equally wrong runs cannot pass.
"""

import threading
import time
from types import SimpleNamespace

import pytest

from tfmesos_tpu_torch import wire
from tfmesos_tpu_torch.fleet.replica import ReplicaServer


def _wait(cond, timeout=5.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return cond()


def control_plane(side: str) -> SimpleNamespace:
    """The fleet modules of one package."""
    if side == "jax":
        from tfmesos_tpu import prefixhash
        from tfmesos_tpu.fleet import (admission, client, gateway, metrics,
                                       registry, router)
    else:
        from tfmesos_tpu_torch import prefixhash
        from tfmesos_tpu_torch.fleet import (admission, client, gateway,
                                             metrics, registry, router)
    return SimpleNamespace(side=side, admission=admission, client=client,
                           gateway=gateway, metrics=metrics,
                           registry=registry, router=router,
                           prefixhash=prefixhash)


class Env:
    """One case's registry, servers, routers and gateways, torn down in
    reverse order of creation."""

    def __init__(self, cp):
        self.cp = cp
        self.token = wire.new_token()
        self.reg = cp.registry.ReplicaRegistry(
            token=self.token, suspect_after=0.5, dead_after=1.0,
            evict_after=5.0, sweep_interval=0.05).start()
        self.metrics = cp.metrics.FleetMetrics()
        self._undo = []

    def router(self, **kw):
        r = self.cp.router.Router(self.reg, self.metrics, token=self.token,
                                  **kw)
        self._undo.append(r.close)
        return r

    def gateway(self, router, max_queue=8, workers=2, **adm):
        gw = self.cp.gateway.Gateway(
            router, self.cp.admission.AdmissionController(
                max_queue=max_queue, **adm),
            self.metrics, token=self.token, workers=workers).start()
        self._undo.append(gw.stop)
        return gw

    def client(self, gw, **kw):
        c = self.cp.client.FleetClient(gw.addr, self.token, **kw)
        self._undo.append(c.close)
        return c

    def serve(self, server):
        self._undo.append(server.stop)
        return server.start()

    def feeder(self, addr, **fields):
        """Register ``addr`` with the registry by hand (a hello on a
        socket this test holds open)."""
        sock = wire.connect(self.reg.addr)
        wire.send_msg(sock, dict({"op": "hello", "addr": addr}, **fields),
                      self.token)
        self._undo.append(sock.close)
        return sock

    def counters(self):
        return dict(self.metrics.snapshot()["counters"])

    def close(self):
        for undo in reversed(self._undo):
            undo()
        self.reg.stop()


# -- stub replicas ------------------------------------------------------------


def stub(env, tokens, delay=0.0, calls=None):
    """A replica that answers every request with canned tokens."""

    def handler(msg, reply):
        if calls is not None:
            calls.append(msg.get("op"))

        def work():
            if delay:
                time.sleep(delay)
            reply({"op": "completion", "id": msg.get("id"),
                   "tokens": list(tokens), "ttft_ms": 1.0,
                   "total_ms": 2.0})

        threading.Thread(target=work, daemon=True).start()

    return env.serve(ReplicaServer(handler, token=env.token, capacity=4,
                                   registry_addr=env.reg.addr,
                                   heartbeat_interval=0.05))


def summary_stub(env, summary):
    return env.serve(ReplicaServer(
        lambda m, r: r({}), token=env.token, capacity=4,
        registry_addr=env.reg.addr, heartbeat_interval=0.05,
        extra_info=lambda: {"prefix_cache": summary}))


def prefill_stub(env, first_token=7, body=b"\xaa" * 2048):
    """Answers ``prefill`` with one raw KV frame, refuses the rest."""

    def handler(msg, reply):
        if isinstance(msg, wire.RawFrame) or msg.get("op") != "prefill":
            head = msg.meta if isinstance(msg, wire.RawFrame) else msg
            reply({"op": "error", "id": head.get("id"),
                   "kind": "bad_request", "error": "prefill role"})
            return
        reply(wire.RawFrame(
            {"op": "prefilled", "id": msg.get("id"),
             "first_token": first_token, "pos": len(msg["prompt"]),
             "prefill_ms": 1.0}, body))

    return env.serve(ReplicaServer(
        handler, token=env.token, capacity=4, registry_addr=env.reg.addr,
        heartbeat_interval=0.05,
        extra_info=lambda: {"role": "prefill", "kv_headroom": 100}))


def decode_stub(env, bodies):
    """Accepts only raw generate frames (the KV import) and echoes the
    artifact's first token."""

    def handler(msg, reply):
        if not isinstance(msg, wire.RawFrame):
            reply({"op": "error", "id": msg.get("id"),
                   "kind": "bad_request",
                   "error": "decode stub wants raw frames"})
            return
        bodies.append(msg.body)
        reply({"op": "completion", "id": msg.meta.get("id"),
               "tokens": [msg.meta["first_token"], 2, 3],
               "ttft_ms": 0.5, "total_ms": 9.5})

    return env.serve(ReplicaServer(
        handler, token=env.token, capacity=4, registry_addr=env.reg.addr,
        heartbeat_interval=0.05,
        extra_info=lambda: {"role": "decode", "kv_headroom": 50}))


def dead_addr():
    sock = wire.bind_ephemeral("127.0.0.1")
    addr = wire.sock_addr(sock, advertise_host="127.0.0.1")
    sock.close()
    return addr


def failed(fn):
    """The class name and kind of what ``fn`` raised, or its result."""
    try:
        return fn()
    except Exception as e:    # noqa: BLE001 - the kind is the result
        return {"raised": type(e).__name__,
                "kind": getattr(e, "kind", None)}


# -- the cases ----------------------------------------------------------------


def case_balance(env):
    stub(env, (1,), delay=0.2)
    stub(env, (2,), delay=0.2)
    assert env.reg.wait_for(2, timeout=5.0)
    router = env.router()
    results = [None] * 6

    def one(i):
        results[i] = router.route({"op": "generate", "prompt": [i]})

    threads = [threading.Thread(target=one, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
        time.sleep(0.02)    # each call registers its slot before the next
    for t in threads:
        t.join(timeout=10.0)
    served = sorted({tuple(r["tokens"]) for r in results})
    assert served == [(1,), (2,)]
    return {"served": served, "counters": env.counters()}


def case_retry_dead_then_give_up(env):
    gone = dead_addr()
    env.feeder(gone)
    assert _wait(lambda: len(env.reg.alive()) == 1)
    survivor = stub(env, (9,))
    assert env.reg.wait_for(2, timeout=5.0)
    router = env.router(backoff_s=0.01)
    first = router.route({"op": "generate", "prompt": [1]})
    assert first["tokens"] == [9]
    assert _wait(lambda: [r["state"] for r in env.reg.snapshot()
                          if r["addr"] == gone] == ["dead"])
    survivor.stop()
    env.reg.mark_dead(survivor.addr)
    second = failed(lambda: router.route({"op": "generate",
                                          "prompt": [2]}))
    assert second["raised"] == "RoutingError"
    return {"first": first["tokens"], "second": second,
            "counters": env.counters()}


def case_retry_mid_request_eof(env):
    listen = wire.bind_ephemeral("127.0.0.1")
    flaky = wire.sock_addr(listen, advertise_host="127.0.0.1")

    def slam():     # accept, read the request, close: a death mid-stream
        while True:
            try:
                conn, _ = listen.accept()
            except OSError:
                return
            try:
                conn.recv(65536)
                conn.close()
            except OSError:
                pass

    threading.Thread(target=slam, daemon=True).start()
    env._undo.append(listen.close)
    env.feeder(flaky)
    assert _wait(lambda: len(env.reg.alive()) == 1)
    stub(env, (5,))
    assert env.reg.wait_for(2, timeout=5.0)
    router = env.router(backoff_s=0.01)
    reply = router.route({"op": "generate", "prompt": [1]})
    assert reply["tokens"] == [5]
    assert env.metrics.get("retries") >= 1
    return {"tokens": reply["tokens"], "counters": env.counters()}


def case_queue_bound_sheds_overloaded(env):
    stub(env, (4,), delay=0.6)
    assert env.reg.wait_for(1, timeout=5.0)
    gw = env.gateway(env.router(), max_queue=1, workers=1)
    client = env.client(gw, timeout=30.0)
    out = {}

    def send(key):
        out[key] = failed(lambda: client.generate([1, 2], 1)["tokens"])

    a = threading.Thread(target=send, args=("a",))
    a.start()
    # The one worker took a: the queue is empty again.
    assert _wait(lambda: env.metrics.get("admitted") == 1
                 and gw.admission.depth() == 0)
    b = threading.Thread(target=send, args=("b",))
    b.start()
    assert _wait(lambda: env.metrics.get("admitted") == 2)
    send("c")       # the queue holds b: c is shed at once
    a.join(timeout=10.0)
    b.join(timeout=10.0)
    assert out == {"a": [4], "b": [4],
                   "c": {"raised": "Overloaded", "kind": "overloaded"}}
    return {"out": out, "counters": env.counters()}


def case_rate_limit_kind(env):
    stub(env, (3,))
    assert env.reg.wait_for(1, timeout=5.0)
    gw = env.gateway(env.router(), rate=0.001, burst=1)
    client = env.client(gw)
    first = client.generate([1], 1)["tokens"]
    second = failed(lambda: client.generate([1], 1))
    assert first == [3]
    assert second == {"raised": "RateLimited", "kind": "rate_limited"}
    return {"first": first, "second": second, "counters": env.counters()}


def case_deadline_exceeded_is_final(env):
    calls = []
    stub(env, (7,), delay=0.6, calls=calls)
    assert env.reg.wait_for(1, timeout=5.0)
    gw = env.gateway(env.router(backoff_s=0.01))
    client = env.client(gw)
    served = client.generate([1, 2], 2, deadline_ms=5000.0)["tokens"]
    t0 = time.perf_counter()
    late = failed(lambda: client.generate([1, 2], 2, deadline_ms=120.0))
    took = time.perf_counter() - t0
    assert served == [7]
    assert late == {"raised": "RequestFailed", "kind": "deadline_exceeded"}
    assert took < 0.55
    time.sleep(0.7)     # the slow replica's late answer lands nowhere
    assert calls == ["generate", "generate"]    # never retried
    return {"served": served, "late": late, "calls": calls,
            "counters": env.counters()}


def case_prefix_affinity(env):
    ph = env.cp.prefixhash

    def summary(prompt, page=16):
        return {"page": page, "first": page, "seed": "",
                "hashes": [d.hex() for d in ph.prompt_digests(prompt,
                                                              page)]}

    prompt_a = list(range(100, 148))            # 3 chunks of 16
    prompt_b = list(range(500, 532))            # a disjoint prefix
    deep = summary_stub(env, summary(prompt_a))
    shallow = summary_stub(env, summary(prompt_a[:16]))
    assert _wait(lambda: len([r for r in env.reg.alive()
                              if r.prefix is not None]) == 2)
    router = env.router()
    names = {deep.addr: "deep", shallow.addr: "shallow"}
    picks = [names[router.pick(prompt=prompt_a)] for _ in range(6)]
    assert picks == ["deep"] * 6
    misses = env.metrics.get("affinity_misses")
    fallback = names[router.pick(prompt=prompt_b)]
    assert env.metrics.get("affinity_misses") == misses + 1
    real = router.outstanding
    router.outstanding = lambda addr: 4 if addr == deep.addr else 0
    saturated = names[router.pick(prompt=prompt_a)]
    router.outstanding = real
    excluded = names[router.pick(exclude=[deep.addr], prompt=prompt_a)]
    assert saturated == excluded == "shallow"
    return {"picks": picks, "fallback_is_a_replica": fallback in names.values(),
            "saturated": saturated, "excluded": excluded,
            "counters": env.counters()}


def case_disagg_round_trip(env):
    prefill_stub(env)
    bodies = []
    decode_stub(env, bodies)
    assert _wait(lambda: sorted(r.role for r in env.reg.alive())
                 == ["decode", "prefill"])
    gw = env.gateway(env.router())
    client = env.client(gw)
    out = client.generate([1, 2, 3], max_new_tokens=3)
    assert out["tokens"] == [7, 2, 3]
    assert out["decode_ms"] == pytest.approx(9.0)
    assert bodies == [b"\xaa" * 2048]
    snap = client.metrics()
    roles = snap["gauges"]["roles"]
    counters = snap["counters"]
    assert counters["kv_transfer_bytes"] == 2048
    assert counters["disagg_requests"] == 1
    return {"tokens": out["tokens"], "decode_ms": out["decode_ms"],
            "alive": {k: roles[k]["alive"] for k in ("prefill", "decode")},
            "counters": counters}


def case_disagg_falls_back_to_unified(env):
    prefill_stub(env)
    stub(env, (5,))
    assert _wait(lambda: len(env.reg.alive()) == 2)
    router = env.router()
    out = router.route({"op": "generate", "prompt": [1, 2],
                        "max_new_tokens": 1})
    assert out["tokens"] == [5]
    assert env.metrics.get("disagg_fallback") == 1
    return {"tokens": out["tokens"], "counters": env.counters()}


def case_misdirected_raw_frame(env):
    gw = env.gateway(env.router(), workers=1)
    mux = env.cp.client.MuxConnection(gw.addr, env.token)
    env._undo.append(mux.close)
    got = failed(lambda: mux.call_raw({"op": "generate", "prompt": [1, 2]},
                                      b"\x00" * 64, timeout=5.0))
    assert got == {"raised": "ConnectionLost", "kind": None}
    return {"got": got, "counters": env.counters()}


def case_plain_generate_avoids_role_replicas(env):
    pre = prefill_stub(env)
    dec = decode_stub(env, [])
    uni = stub(env, (8,))
    assert _wait(lambda: len(env.reg.alive()) == 3)
    router = env.router()
    names = {pre.addr: "prefill", dec.addr: "decode", uni.addr: "unified"}
    picks = [names[router.pick()] for _ in range(8)]
    assert picks == ["unified"] * 8
    assert names[router.pick_prefill()] == "prefill"
    assert names[router.pick_decode()] == "decode"
    return {"picks": picks, "counters": env.counters()}


CASES = [case_balance, case_retry_dead_then_give_up,
         case_retry_mid_request_eof, case_queue_bound_sheds_overloaded,
         case_rate_limit_kind, case_deadline_exceeded_is_final,
         case_prefix_affinity, case_disagg_round_trip,
         case_disagg_falls_back_to_unified, case_misdirected_raw_frame,
         case_plain_generate_avoids_role_replicas]


def run_case(case, side):
    env = Env(control_plane(side))
    try:
        return case(env)
    finally:
        env.close()


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__[5:])
def test_port_control_plane_equals_jax(case):
    assert run_case(case, "port") == run_case(case, "jax")
