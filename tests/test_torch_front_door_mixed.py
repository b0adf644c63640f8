"""Mixed fleets across the two frameworks' control planes.

The port's registry, router and gateway front one JAX replica
(``tfmesos_tpu.fleet.replica``, assembled in process) and one port
replica serving the same tiny weights on the CPU; the JAX registry,
router and gateway front another port replica.  Greedy completions
through either front door, pinned to each replica or mixed, equal the
JAX package's offline ``generate``; each framework's ``FleetClient``
works against the other's gateway; and the port fleet's
``request_migration`` moves a streamed request from the JAX replica to
the port one token-identically, through the port router's relay."""

import threading

import numpy as np
import pytest
from torch_parity import (JaxFleet, jax_compile_cache_off,  # noqa: F401
                          jax_replica, offline_generate, port_replica,
                          slow_streams, stop_replica, tiny_models,
                          wait_for)

TOKEN = "front-door-mixed-token"
ARGV = ["--tiny", "--rows", "4", "--heartbeat-interval", "0.05"]
NEW = 8
LONG = 80


def _prompts(n=6, seed=23):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 97, rng.randint(3, 33)).tolist()
            for _ in range(n)]


@pytest.fixture(scope="module")
def fleets():
    jcfg, jparams, _, tparams = tiny_models()
    port = JaxFleet(TOKEN, side="port")
    jax_fleet = JaxFleet(TOKEN)
    reps = {"jax": jax_replica(ARGV + ["--registry", port.addr], TOKEN),
            "port": port_replica(ARGV + ["--registry", port.addr], TOKEN,
                                 params=tparams),
            "behind_jax": port_replica(ARGV + ["--registry",
                                               jax_fleet.addr],
                                       TOKEN, params=tparams)}
    port.reps = reps
    port.addrs = {k: r[0].addr for k, r in reps.items()}
    port.wait_routable(port.addrs["jax"], port.addrs["port"])
    jax_fleet.wait_routable(port.addrs["behind_jax"])
    port.prompts = _prompts()
    port.want = offline_generate(jcfg, jparams, port.prompts, NEW)
    port.long_prompt = _prompts(1, seed=5)[0][:9]
    port.long_want = offline_generate(jcfg, jparams, [port.long_prompt],
                                      LONG)[0]
    port.jax_fleet = jax_fleet
    yield port
    for r in reps.values():
        stop_replica(r)
    jax_fleet.close()
    port.close()


def _concurrently(fns):
    out, errors = [None] * len(fns), []

    def run(i):
        try:
            out[i] = fns[i]()
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(fns))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120.0)
    assert not errors, errors
    return out


@pytest.mark.parametrize("which", ["jax", "port"])
def test_port_router_pinned_to_each_framework(fleets, which):
    """The port router, with the other replica held unroutable
    (``warming``), serves every prompt from ``which`` replica: the
    offline stream, token for token."""
    other = "port" if which == "jax" else "jax"
    osrv = fleets.reps[other][0]
    osrv.set_status("warming")
    try:
        wait_for(lambda: fleets.info(fleets.addrs[other]).state
                 == "warming", what=f"{other} replica warming")
        got = _concurrently(
            [lambda p=p: fleets.router.route(
                {"op": "generate", "prompt": p, "max_new_tokens": NEW,
                 "stop_token": None, "priority": 0})["tokens"]
             for p in fleets.prompts])
    finally:
        osrv.set_status(None)
    assert got == fleets.want
    fleets.wait_routable(fleets.addrs["jax"], fleets.addrs["port"])


def test_port_gateway_mixed_traffic_equals_the_jax_gateway(fleets):
    """Concurrent traffic through the port gateway (over a JAX and a
    port replica) and through the JAX gateway (over a port replica)
    gives the same completions, the offline ones."""
    before = dict(fleets.metrics.snapshot()["counters"])
    batchers = [fleets.reps[k][2] for k in ("jax", "port")]
    rids = [b._next_rid for b in batchers]
    port_client = fleets.client()
    jax_client = fleets.jax_fleet.client()
    through_port = _concurrently(
        [lambda p=p: port_client.generate(p, NEW)["tokens"]
         for p in fleets.prompts])
    through_jax = _concurrently(
        [lambda p=p: jax_client.generate(p, NEW)["tokens"]
         for p in fleets.prompts])
    assert through_port == through_jax == fleets.want
    after = fleets.metrics.snapshot()["counters"]
    n = len(fleets.prompts)
    for key in ("received", "admitted", "completed"):
        assert after[key] - before.get(key, 0) == n
    assert all(b._next_rid > r for b, r in zip(batchers, rids)), \
        "one replica behind the port gateway served nothing"


def test_each_client_against_the_other_gateway(fleets):
    """The JAX ``FleetClient`` on the port gateway and the port's
    ``FleetClient`` on the JAX gateway: completions, streamed partials
    and the metrics op all work across the frameworks."""
    from tfmesos_tpu.fleet import client as jax_client_mod
    from tfmesos_tpu_torch.fleet import client as port_client_mod

    prompt, want = fleets.prompts[0], fleets.want[0]
    jc = fleets.client(client_mod=jax_client_mod)
    streamed = []
    out = jc.generate(prompt, NEW, on_tokens=streamed.extend)
    assert out["tokens"] == streamed == want
    assert jc.metrics()["counters"]["completed"] >= 1
    assert jc.gateways() == [fleets.gateway.addr]
    pc = fleets.jax_fleet.client(client_mod=port_client_mod)
    streamed = []
    out = pc.generate(prompt, NEW, on_tokens=streamed.extend)
    assert out["tokens"] == streamed == want
    assert pc.metrics()["counters"]["completed"] >= 1
    assert pc.gateways() == [fleets.jax_fleet.gateway.addr]


def test_request_migration_moves_jax_to_port(fleets):
    """A streamed request on the JAX replica (the port replica held
    unroutable until its first tokens), then the port fleet's
    ``request_migration`` on the JAX replica: the port router resumes
    the suspended artifact on the port replica, and the stream and the
    completion are the offline ``generate``'s."""
    from tfmesos_tpu_torch.fleet.launcher import FleetServer

    launcher = FleetServer(replicas=1, device="cpu")
    launcher.router, launcher.metrics = fleets.router, fleets.metrics
    vsrv, ssrv = fleets.reps["jax"][0], fleets.reps["port"][0]
    saddr = fleets.addrs["port"]
    before = dict(fleets.metrics.snapshot()["counters"])
    inner = slow_streams(vsrv, 0.02)
    ssrv.set_status("warming")
    try:
        wait_for(lambda: fleets.info(saddr).state == "warming",
                 what="port replica warming")
        first, streamed, out = threading.Event(), [], {}

        def on_tokens(toks):
            streamed.extend(toks)
            first.set()

        def call():
            out["reply"] = fleets.client().generate(
                fleets.long_prompt, LONG, on_tokens=on_tokens)

        t = threading.Thread(target=call)
        t.start()
        assert first.wait(60.0), "no token streamed"
        ssrv.set_status(None)
        fleets.wait_routable(saddr)
        assert launcher.request_migration(fleets.addrs["jax"])
        t.join(timeout=120.0)
    finally:
        vsrv.handler = inner
        ssrv.set_status(None)
    assert out["reply"]["tokens"] == fleets.long_want
    assert streamed == fleets.long_want
    after = fleets.metrics.snapshot()["counters"]
    assert after["migrations_requested"] \
        == before.get("migrations_requested", 0) + 1
    assert after.get("migration_resumes", 0) \
        == before.get("migration_resumes", 0) + 1
    assert after.get("migration_reruns", 0) \
        == before.get("migration_reruns", 0)
    fleets.wait_routable(fleets.addrs["jax"], fleets.addrs["port"])
