"""The port's multi-process front door: gateway processes (``python -m
tfmesos_tpu_torch.fleet.gateway``) over registry sidecars.

- The JAX ``tests/test_fleet.py`` case of two gateway processes runs on
  the port: discovery through the central registry's leases, and a
  SIGKILL of the serving process that the client's failover survives
  with every streamed token exactly once.
- ``RegistrySidecar`` replays one central view into a local table equal
  to the JAX sidecar's (ALIVE, WARMING, DRAINING, DEAD), on the same
  clock, as entries come, change and leave.
- ``Gateway(reuseport=True)``: two gateways share one port and both
  serve.
- A CPU ``FleetServer(gateway_processes=2, http_port=P)``: JSON and SSE
  completions through gateway process 0's HTTP edge, and wire requests
  through the shared port, equal the JAX batcher's greedy streams on the
  same weights; the launcher's fleet snapshot folds both processes'
  counters in."""

import http.client
import json
import socket
import threading
import time

import numpy as np
import pytest

from torch_jax_cases import port_module
from torch_parity import jax_compile_cache_off  # noqa: F401

_fleet_cases = port_module("test_fleet.py")
stub_fleet = _fleet_cases.stub_fleet
test_gateway_processes_discovery_and_sigkill_failover = \
    _fleet_cases.test_gateway_processes_discovery_and_sigkill_failover

NEW = 6


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _central_view(registry_mod, clock, step):
    """A central registry's ``registry_view`` at ``step``: replicas alive
    and warming, then one warmed up, one draining, one dead, one gone."""
    reg = registry_mod.ReplicaRegistry(token="t", clock=clock)
    beats = {"10.0.0.1:1": {}, "10.0.0.2:1": {"status": "warming"},
             "10.0.0.3:1": {}, "10.0.0.4:1": {},
             "10.0.0.5:1": {"weights_version": "v2", "gen": 3,
                            "capacity": 8}}
    if step == 1:
        beats.pop("10.0.0.1:1")                 # evicted centrally
        beats["10.0.0.2:1"] = {}                # warmed up
    for addr, extra in beats.items():
        reg.observe(dict({"op": "hello", "addr": addr, "capacity": 4},
                         **extra))
    if step == 1:
        reg.observe({"op": "drain", "addr": "10.0.0.3:1"})
        reg.mark_dead("10.0.0.4:1", why="test")
    reg.register_gateway("127.0.0.1:7001", ttl=30.0)
    reg.set_gateways(["127.0.0.1:7001", "127.0.0.1:7002"])
    return reg.registry_view()


def _mirror(gateway_mod, registry_mod):
    clock = _Clock()
    side = gateway_mod.RegistrySidecar("127.0.0.1:1", token="t",
                                       poll_interval=0.25, clock=clock)
    tables = []
    for step, advance in ((0, 0.0), (1, 0.5), (1, 4.0), (1, 40.0)):
        clock.t += advance
        side._apply(_central_view(registry_mod, clock, step))
        side.local.sweep()
        view = side.local.registry_view()
        tables.append({"replicas": sorted(
            (json.dumps(d, sort_keys=True) for d in view["replicas"])),
            "gateways": sorted(view["gateways"]),
            "alive": sorted(r.addr for r in side.local.alive())})
    return tables


def test_sidecar_tables_equal_jax_sidecar():
    from tfmesos_tpu.fleet import gateway as jax_gateway
    from tfmesos_tpu.fleet import registry as jax_registry
    from tfmesos_tpu_torch.fleet import gateway, registry

    mine = _mirror(gateway, registry)
    assert mine == _mirror(jax_gateway, jax_registry)
    def states(table):
        return {json.loads(d)["addr"]: json.loads(d)["state"]
                for d in table["replicas"]}

    assert states(mine[0]) == {"10.0.0.1:1": "alive",
                               "10.0.0.2:1": "warming",
                               "10.0.0.3:1": "alive", "10.0.0.4:1": "alive",
                               "10.0.0.5:1": "alive"}
    assert states(mine[1]) == {"10.0.0.1:1": "alive", "10.0.0.2:1": "alive",
                               "10.0.0.3:1": "draining",
                               "10.0.0.4:1": "dead", "10.0.0.5:1": "alive"}
    assert mine[1]["alive"] == ["10.0.0.1:1", "10.0.0.2:1", "10.0.0.5:1"]
    # What the central view stopped listing ages out on local clocks.
    assert states(mine[2])["10.0.0.1:1"] != "alive"
    assert "10.0.0.1:1" not in states(mine[-1])
    assert mine[0]["gateways"] == ["127.0.0.1:7001", "127.0.0.1:7002"]


def test_gateways_share_one_port_with_reuseport(stub_fleet):
    from tfmesos_tpu_torch import wire
    from tfmesos_tpu_torch.fleet.admission import AdmissionController
    from tfmesos_tpu_torch.fleet.client import FleetClient
    from tfmesos_tpu_torch.fleet.gateway import Gateway
    from tfmesos_tpu_torch.fleet.metrics import FleetMetrics
    from tfmesos_tpu_torch.fleet.router import Router

    assert wire.reuseport_available()
    token, reg, servers = stub_fleet
    servers.append(_fleet_cases._stub_replica(token, reg.addr,
                                              tokens=(4, 2)))
    assert reg.wait_for(1, timeout=5.0)
    probe = wire.bind_ephemeral("127.0.0.1", 0, reuseport=True)
    port = probe.getsockname()[1]
    probe.close()
    gws, books = [], []
    try:
        for _ in range(2):
            metrics = FleetMetrics()
            router = Router(reg, metrics, token=token)
            gws.append(Gateway(router, AdmissionController(max_queue=8),
                               metrics, token=token, port=port, workers=1,
                               registry=reg, reuseport=True).start())
            books.append(metrics)
        assert gws[0].addr == gws[1].addr == f"127.0.0.1:{port}"
        for _ in range(24):
            client = FleetClient(gws[0].addr, token)
            try:
                assert client.generate([1], 2)["tokens"] == [4, 2]
            finally:
                client.close()
        served = [m.snapshot()["counters"].get("completed", 0)
                  for m in books]
        assert sum(served) == 24 and min(served) >= 1, served
        with pytest.raises(OSError):          # without the option: taken
            wire.bind_ephemeral("127.0.0.1", port)
    finally:
        for g in gws:
            g.stop()


def _prompts(n=6, seed=20):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 97, rng.randint(3, 30)).tolist()
            for _ in range(n)]


def _jax_streams(prompts):
    """The JAX batcher's greedy streams on the port preset's weights
    (``convert.params_to_numpy``) under the JAX tiny config."""
    from tfmesos_tpu import serving as js
    from tfmesos_tpu.fleet.replica import tiny_model as jax_tiny_model
    from tfmesos_tpu_torch import convert
    from tfmesos_tpu_torch.models import presets

    jcfg, _ = jax_tiny_model(seed=0)
    params = convert.params_to_numpy(presets.tiny_model(0)[1])
    b = js.ContinuousBatcher(jcfg, params, rows=2, max_len=64, page_size=16,
                             prefill_bucket=16)
    done = {c.rid: list(c.tokens) for c in b.run(
        [js.Request(prompt=np.asarray(p, np.int32), max_new_tokens=NEW)
         for p in prompts])}
    return [done[r] for r in sorted(done)]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _http_completion(port, prompt, stream):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120.0)
    try:
        conn.request("POST", "/v1/completions",
                     body=json.dumps({"prompt": prompt, "max_tokens": NEW,
                                      "stream": stream}),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        raw = resp.read()
        assert resp.status == 200, raw
    finally:
        conn.close()
    if not stream:
        return json.loads(raw)["tokens"]
    events = [e[len("data: "):] for e in raw.decode().split("\n\n")
              if e.startswith("data: ")]
    assert events[-1] == "[DONE]"
    done = json.loads(events[-2])
    toks = [t for e in events[:-2] for t in json.loads(e)["tokens"]]
    assert done["done"] is True and done["n_tokens"] == len(toks)
    return toks


def test_cpu_fleet_http_through_gateway_process_equals_jax_streams():
    from tfmesos_tpu_torch.fleet.launcher import FleetServer

    prompts = _prompts()
    want = _jax_streams(prompts)
    port = _free_port()
    fleet = FleetServer(replicas=1, tiny=True, max_len=64, page_size=16,
                        prefill_bucket=16, rows=2, device="cpu",
                        request_timeout=120.0, start_timeout=120.0,
                        heartbeat_interval=0.1, gateway_processes=2,
                        http_port=port).start()
    try:
        assert fleet.gateways == [] and len(fleet._gateway_procs) == 2
        assert fleet.http_addr == f"127.0.0.1:{port}"
        assert len(fleet.registry.gateway_leases()) == 2
        got = {}

        def one(i, stream):
            got[(i, stream)] = _http_completion(port, prompts[i], stream)

        threads = [threading.Thread(target=one, args=(i, s))
                   for i in range(len(prompts)) for s in (False, True)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120.0)
        client = fleet.client(timeout=120.0)
        try:
            wire_out = [client.generate(p, NEW)["tokens"] for p in prompts]
            assert sorted(client.gateways()) == fleet.addrs
        finally:
            client.close()
        for i, w in enumerate(want):
            assert got[(i, False)] == got[(i, True)] == wire_out[i] == w
        counters = fleet.fleet_snapshot()["counters"]
        assert counters["http_requests"] == 2 * len(prompts)
        assert counters["completed"] == 3 * len(prompts)
    finally:
        procs = list(fleet._gateway_procs)
        fleet.stop()
    assert all(p.poll() is not None for p in procs)
