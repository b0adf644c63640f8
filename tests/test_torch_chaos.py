"""The port's fault injection (``tfmesos_tpu_torch.chaos``) and its hooks.

- Every case of the JAX ``tests/test_chaos.py`` runs on the port: the
  plan's counters, target filter and seeded delays; the wire's sever,
  truncate, drop and delay; the registry's heartbeat drops (a ``drain``
  never counts); the elastic policy under a ``FaultPlan`` on the
  scheduler and ``LocalBackend``; migration KV transfers cut by a fault.
  Its ``FakeBackend`` and stub replicas come from port copies of
  ``tests/test_scheduler.py`` and ``tests/test_fleet.py``.
- The chaos cases of ``tests/test_containment.py`` (``slow_task``),
  ``tests/test_kvfabric.py`` (``partition``) and ``tests/test_tracing.py``
  (a firing recorded into the active trace) run on the port too.
- The same plan drives the JAX and the port ``FaultPlan`` to the same
  firings and seeded delays.
"""

import pytest

from torch_jax_cases import port_cases, port_module

from tfmesos_tpu import chaos as jchaos
from tfmesos_tpu_torch import chaos as tchaos
from tfmesos_tpu_torch import wire as twire
from tfmesos_tpu_torch.backends.local import LocalBackend
from tfmesos_tpu_torch.fleet.registry import ReplicaRegistry
from tfmesos_tpu_torch.scheduler import TPUMesosScheduler
from tfmesos_tpu_torch.spec import Job

globals().update(port_cases("test_chaos.py",
                            deps=("test_scheduler.py", "test_fleet.py")))

_containment = port_module("test_containment.py")
test_chaos_slow_task_deterministic_per_seed_and_persistent = \
    _containment.test_chaos_slow_task_deterministic_per_seed_and_persistent
test_chaos_slow_task_sleeps_per_matching_event = \
    _containment.test_chaos_slow_task_sleeps_per_matching_event

_kvfabric = port_module("test_kvfabric.py")
test_partition_fault_drops_frames_between_one_peer_pair = \
    _kvfabric.test_partition_fault_drops_frames_between_one_peer_pair
test_partition_fault_degrades_parks_without_losing_the_primary = \
    _kvfabric.test_partition_fault_degrades_parks_without_losing_the_primary

_tracing = port_module("test_tracing.py")
stub_fleet = _tracing.stub_fleet
test_chaos_fault_records_into_active_trace = \
    _tracing.test_chaos_fault_records_into_active_trace


def _events(mod):
    """One event script through a plan of every counted action: the
    fired list, the per-event due actions and the seeded delays."""
    F = mod.Fault
    plan = mod.FaultPlan([
        F("drop", "wire.send", nth=2, count=2, target="a:1"),
        F("sever", "wire.recv", nth=3),
        F("delay", "registry.heartbeat", nth=1, delay_s=None),
        F("slow_task", "wire.send", nth=3, target="b:", delay_s=None),
        F("partition", "wire.send", target="a:1|c:1"),
        F("drop", "registry.heartbeat", nth=2, count=3, target="r:"),
    ], seed=5)
    plan._execute = lambda f, site, key: None      # count, never sleep
    script = [("wire.send", "a:1"), ("wire.send", "b:2"),
              ("wire.send", "x|a:1"), ("wire.send", "a:1|c:1"),
              ("wire.recv", "a:1"), ("wire.recv", ""), ("wire.recv", "q"),
              ("wire.send", "b:1"), ("wire.send", "b:3"),
              ("registry.heartbeat", "r:1"), ("registry.heartbeat", "r:2"),
              ("registry.heartbeat", "s:1"), ("registry.heartbeat", "r:1"),
              ("registry.heartbeat", "r:3"), ("registry.heartbeat", "r:1"),
              ("wire.send", "c:1|a:1"), ("wire.send", "a:1")]
    due = [[f.action for f in plan.event(site, key=key)]
           for site, key in script]
    return plan.fired, due, [f.delay_s for f in plan.faults]


def test_fault_plan_fires_as_the_reference():
    assert _events(tchaos) == _events(jchaos)
    with pytest.raises(ValueError):
        tchaos.Fault("explode", "wire.send")
    with pytest.raises(ValueError):
        tchaos.Fault("drop", "wire.send", nth=0)


def test_install_arms_the_port_wire_hooks_only():
    """``install`` arms the port's wire (``wire.set_chaos``), not the
    JAX package's; ``uninstall`` disarms it."""
    from tfmesos_tpu import wire as jwire

    plan = tchaos.FaultPlan([tchaos.Fault("drop", "wire.send")])
    with plan.installed():
        assert twire._chaos_send == plan.on_wire_send
        assert twire._chaos_recv == plan.on_wire_recv
        assert jwire._chaos_send is None
    assert twire._chaos_send is None and twire._chaos_recv is None


def test_components_take_the_plan():
    """``chaos=`` on the scheduler, ``LocalBackend`` and the registry,
    and the registry's heartbeat drop through ``observe``."""
    plan = tchaos.FaultPlan([tchaos.Fault(
        "drop", "registry.heartbeat", nth=1, count=1, target="h:1")])
    sched = TPUMesosScheduler([Job(name="worker", num=1)], chaos=plan,
                              quiet=True)
    assert sched.chaos is plan
    assert LocalBackend(chaos=plan).chaos is plan
    reg = ReplicaRegistry(token="t", chaos=plan)
    assert reg.observe({"op": "hello", "addr": "h:1", "capacity": 2}) \
        is None
    assert "h:1" not in {r.addr for r in reg.alive()}
    reg.observe({"op": "hello", "addr": "h:1", "capacity": 2})
    assert "h:1" in {r.addr for r in reg.alive()}
    assert plan.fired == [("registry.heartbeat", "h:1", "drop", 1)]
