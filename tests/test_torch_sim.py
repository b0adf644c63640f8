"""The port's fleet simulator (``tfmesos_tpu_torch.fleet.sim``), its
workloads (``fleet.workload``) and ``tfserve simulate``.

- Every case of the JAX ``tests/test_sim.py`` runs on the port, the
  soak-replay fidelity gate among them, under its ``sleep_trap``: no
  real ``time.sleep`` may run during a simulation.
- Each of the ten scenarios, run through ``tfserve simulate --json``
  with the same seed and ``--set`` on the JAX CLI and on the port's,
  gives the same results dict, key for key, but for the keys read off
  the wall clock (``wall_s``, ``*per_sec*``,
  ``sim_replicas_per_wallclock_sec``).  So do a ``--sweep`` and a
  ``--replay`` of a trace export that the port's own ``tfserve trace
  --json`` wrote from a port gateway.
- The ``simulate`` cases of the JAX ``tests/test_cli.py`` run on the
  port's ``serve_main``.
"""

import json
import threading

import pytest

from torch_jax_cases import port_cases, port_module, timeless

from tfmesos_tpu import cli as jax_cli
from tfmesos_tpu_torch import cli

globals().update(port_cases("test_sim.py"))

_cli_cases = port_module("test_cli.py")
test_simulate_multi_gateway_scenario = \
    _cli_cases.test_simulate_multi_gateway_scenario
test_simulate_subcommand = _cli_cases.test_simulate_subcommand
test_simulate_replay_round_trip = _cli_cases.test_simulate_replay_round_trip

#: each scenario's size: small enough for tier-1, with every scenario's
#: own default where it is already small.
SIZES = {"steady": ["--requests", "300"], "surge": ["--requests", "300"],
         "gang": ["--requests", "300"], "diurnal": ["--requests", "2000"],
         "scale": ["--requests", "2000"], "soak-replay": [],
         "sessions": [], "offline-lane": ["--requests", "300"],
         "multi-gateway": ["--requests", "400"],
         "multi-model": ["--requests", "2000"]}


def _simulate(main, argv, capsys):
    assert main(["simulate", *argv, "--json"]) == 0
    return timeless(json.loads(capsys.readouterr().out))


def _both(argv, capsys):
    return (_simulate(jax_cli.serve_main, argv, capsys),
            _simulate(cli.serve_main, argv, capsys))


def test_sizes_cover_every_scenario():
    from tfmesos_tpu.fleet.sim import SCENARIOS as JAX_SCENARIOS
    from tfmesos_tpu_torch.fleet.sim import SCENARIOS

    assert sorted(SIZES) == sorted(SCENARIOS) == sorted(JAX_SCENARIOS)


@pytest.mark.parametrize("name", sorted(SIZES))
def test_scenario_matches_jax_key_for_key(name, sleep_trap, capsys):
    jax_res, mine = _both([name, *SIZES[name], "--seed", "7",
                           "--set", "breaker.latency_factor=4"], capsys)
    assert mine == jax_res
    assert mine["lost"] == 0


def test_sweep_matches_jax(sleep_trap, capsys):
    """``--sweep kv_placement=...`` prices the port's ``KVFabric`` rule
    in the sessions scenario."""
    jax_rows, mine = _both(["sessions", "--requests", "300", "--replicas",
                            "3", "--seed", "8", "--set", "kv_replication=2",
                            "--sweep", "kv_placement=rendezvous,loaded"],
                           capsys)
    assert sorted(mine) == ["loaded", "rendezvous"]
    assert [mine[v]["kv_placement"] for v in sorted(mine)] == sorted(mine)
    assert mine == jax_rows


def _port_trace_export(tmp_path, monkeypatch, capsys):
    """A ``tfserve trace --json`` export written by the port's CLI from
    a port gateway that served 40 requests over two stub replicas."""
    from tfmesos_tpu_torch import wire
    from tfmesos_tpu_torch.fleet.admission import AdmissionController
    from tfmesos_tpu_torch.fleet.client import FleetClient
    from tfmesos_tpu_torch.fleet.gateway import Gateway
    from tfmesos_tpu_torch.fleet.metrics import FleetMetrics
    from tfmesos_tpu_torch.fleet.registry import ReplicaRegistry
    from tfmesos_tpu_torch.fleet.replica import ReplicaServer
    from tfmesos_tpu_torch.fleet.router import Router
    from tfmesos_tpu_torch.fleet.tracing import TraceBook

    def handler(msg, reply):
        n = int(msg.get("max_new_tokens") or 1)

        def work():
            reply({"op": "completion", "id": msg.get("id"),
                   "tokens": list(range(n)), "ttft_ms": 1.0,
                   "total_ms": 1.0 + n})

        threading.Thread(target=work, daemon=True).start()

    token = wire.new_token()
    reg = ReplicaRegistry(token=token, sweep_interval=0.05).start()
    servers = [ReplicaServer(handler, token=token, capacity=8,
                             registry_addr=reg.addr,
                             heartbeat_interval=0.05).start()
               for _ in range(2)]
    router = gw = None
    try:
        assert reg.wait_for(2, timeout=10.0)
        router = Router(reg, FleetMetrics(), token=token)
        gw = Gateway(router, AdmissionController(max_queue=64),
                     FleetMetrics(), token=token, workers=4,
                     tracebook=TraceBook(sample=1.0)).start()
        client = FleetClient(gw.addr, token, timeout=30.0)
        for i in range(40):
            out = client.generate([1, 2, 3], 2 + i % 7, timeout=30.0)
            assert out["tokens"] == list(range(2 + i % 7))
        client.close()
        monkeypatch.setenv(wire.TOKEN_ENV, token)
        capsys.readouterr()
        assert cli.trace_main(["-g", gw.addr, "--json", "--limit",
                               "100"]) == 0
        export = capsys.readouterr().out
    finally:
        if gw is not None:
            gw.stop()
        if router is not None:
            router.close()
        for s in servers:
            s.stop()
        reg.stop()
    records = json.loads(export)
    assert len(records) == 40
    path = tmp_path / "export.json"
    path.write_text(export)
    return path


def test_replay_of_a_port_trace_export_matches_jax(tmp_path, monkeypatch,
                                                   capsys):
    path = _port_trace_export(tmp_path, monkeypatch, capsys)
    jax_res, mine = _both(["steady", "--replicas", "2", "--seed", "5",
                           "--replay", str(path)], capsys)
    assert mine == jax_res
    assert mine["requests"] == 40 and mine["lost"] == 0
