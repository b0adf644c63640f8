"""The port's ``FleetServer`` end to end on the CPU (``device="cpu"``):
two tiny port replicas run as subprocesses through the port's scheduler,
``LocalBackend`` and node runtime (``python -m tfmesos_tpu_torch.server``
execs ``python -m tfmesos_tpu_torch.fleet.replica``).  Completions equal
the port's in-process ``ContinuousBatcher`` over the port preset of the
same seed, unified and disaggregated; the gateway's books balance; a
killed replica is routed around; ``stop()`` leaves no process of the
fleet behind; and the backend pins no platform in a child's
environment."""

import dataclasses
import json
import os
import threading
import time

import numpy as np
import pytest

from tfmesos_tpu_torch.fleet.launcher import FleetServer

NEW = 6
SHAPE = dict(tiny=True, max_len=64, page_size=16, prefill_bucket=16,
             device="cpu", request_timeout=120.0, start_timeout=120.0,
             heartbeat_interval=0.1)


def _prompts(n=8, seed=3):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 97, rng.randint(3, 30)).tolist()
            for _ in range(n)]


def _in_process(prompts, rows=4):
    """The port's ContinuousBatcher in this process, built as a replica
    builds it (``build_batcher`` from the replica's own flags)."""
    from tfmesos_tpu_torch.fleet import replica
    from tfmesos_tpu_torch.serving import Request

    args = replica.build_parser().parse_args(
        ["--tiny", "--device", "cpu", "--rows", str(rows), "--max-len",
         "64", "--page-size", "16", "--prefill-bucket", "16"])
    batcher = replica.build_batcher(args)
    done = {c.rid: list(c.tokens) for c in batcher.run(
        [Request(np.asarray(p, np.int32), NEW) for p in prompts])}
    return [done[rid] for rid in sorted(done)]


def _session_pids(sids):
    """Live processes whose session id is one of ``sids`` (LocalBackend
    starts every task as a session leader: the node runtime, its shell
    and the replica all share the session)."""
    out = []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if fields[0] != "Z" and int(fields[3]) in sids:
            out.append(int(name))
    return out


def _sessions(fleet):
    return {p.pid for p in fleet.scheduler.backend._procs.values()}


def _generate_all(client, prompts, stream_every=2):
    out, streamed, errors = [None] * len(prompts), {}, []

    def one(i):
        try:
            kw = {}
            if i % stream_every == 0:
                streamed[i] = []
                kw["on_tokens"] = streamed[i].extend
            out[i] = client.generate(prompts[i], NEW, **kw)["tokens"]
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120.0)
    assert not errors, errors
    for i, toks in streamed.items():
        assert toks == out[i], i
    return out


@pytest.fixture(scope="module")
def want():
    return _in_process(_prompts())


@pytest.fixture(scope="module")
def fleet():
    f = FleetServer(replicas=2, **SHAPE).start()
    try:
        yield f
    finally:
        f.stop()


def test_unified_fleet_serves_the_in_process_tokens(fleet, want):
    client = fleet.client(timeout=120.0)
    try:
        assert _generate_all(client, _prompts()) == want
        counters = client.metrics()["counters"]
    finally:
        client.close()
    assert counters["received"] == counters["admitted"] \
        == counters["completed"] == len(want)
    roles = fleet.snapshot()["gauges"]["roles"]["unified"]
    assert roles["alive"] == 2 and roles["target"] == 2


def test_replica_commands_name_the_port(fleet):
    cmds = [t.cmd for t in fleet.scheduler.tasks_of("replica")]
    assert len(cmds) == 2
    for cmd in cmds:
        assert " -m tfmesos_tpu_torch.fleet.replica " in cmd
        assert "--device cpu" in cmd and "--tiny" in cmd


def test_replica_stats_name_each_process_and_its_work(fleet, want):
    """The ``stats`` op of each replica: its own pid (a process of the
    fleet), its device, and dispatch counters that count this test's
    requests.  On the CPU the wrappers run their plain versions, so no
    kernel launch is counted."""
    from tfmesos_tpu_torch.fleet.client import MuxConnection

    addrs = sorted(r.addr for r in fleet.registry.alive())
    assert len(addrs) == 2
    links = [MuxConnection(a, fleet.token) for a in addrs]
    client = fleet.client(timeout=120.0)
    try:
        before = [link.call({"op": "stats", "reset_launches": True},
                            timeout=30.0) for link in links]
        assert _generate_all(client, _prompts()[:4]) == want[:4]
        after = [link.call({"op": "stats"}, timeout=30.0) for link in links]
    finally:
        client.close()
        for link in links:
            link.close()
    pids = _session_pids(_sessions(fleet))
    assert sorted(s["pid"] for s in after) == sorted(
        {s["pid"] for s in after}) and all(s["pid"] in pids for s in after)
    for s in after:
        assert s["op"] == "stats" and s["device"] == "cpu"
        assert s["memory_allocated"] == 0 and s["multi_step"] == 1
        assert set(s["launches"].values()) == {0}
    prefills = sum(a["counters"]["prefills"] - b["counters"]["prefills"]
                   for a, b in zip(after, before))
    ticks = sum(a["counters"]["decode_ticks"] - b["counters"]["decode_ticks"]
                for a, b in zip(after, before))
    assert prefills == 4 and ticks >= NEW - 1


def test_killed_replica_is_routed_around(fleet, want):
    nodes = [f"replica:{t.task_index}"
             for t in fleet.scheduler.tasks_of("replica")]
    assert fleet.kill_replica(nodes[0])
    assert not fleet.kill_replica(nodes[0])        # already gone
    assert fleet.tier_actual("unified") == 1
    client = fleet.client(timeout=120.0)
    try:
        assert _generate_all(client, _prompts()[:4]) == want[:4]
    finally:
        client.close()


def test_disaggregated_fleet_gives_the_unified_tokens(want):
    prompts = _prompts()[:4]
    with FleetServer(replicas=0, prefill_replicas=1, decode_replicas=1,
                     **SHAPE) as f:
        client = f.client(timeout=120.0)
        try:
            got = _generate_all(client, prompts)
            counters = client.metrics()["counters"]
        finally:
            client.close()
    assert got == want[:4]
    assert counters["disagg_requests"] == len(prompts)
    assert counters["kv_transfer_bytes"] > 0


def test_stop_leaves_no_process_of_the_fleet():
    f = FleetServer(replicas=1, **SHAPE).start()
    try:
        sids = _sessions(f)
        assert len(sids) == 1
        # The node runtime and the replica under it.
        assert len(_session_pids(sids)) >= 2
    finally:
        f.stop()
    deadline = time.monotonic() + 10.0
    while _session_pids(sids) and time.monotonic() < deadline:
        time.sleep(0.05)
    assert _session_pids(sids) == []


def test_no_card_no_fallback(capfd):
    """Without ``device="cpu"`` the replicas ask for the card; with none
    here each exits at bring-up with the replica's own error (pumped to
    the fleet's output by the node runtime) and the fleet fails instead
    of serving from the CPU."""
    from tfmesos_tpu_torch.scheduler import ClusterError

    f = FleetServer(replicas=1, tiny=True, start_timeout=120.0,
                    heartbeat_interval=0.1)
    with pytest.raises(ClusterError, match="failed 3 times"):
        f.start()
    assert f.registry is None and f.scheduler is None
    out, err = capfd.readouterr()
    assert (out + err).count("no CUDA device is available") >= 3


def _control_fleet(jax, option, value):
    """The fleet one package builds from a control-loop option (each
    ``models`` entry a ``ModelSpec`` of that package; ``warm_pool``
    alone, and beside a catalog): its bounds, budget, catalog and the
    error it raises."""
    if jax:
        from tfmesos_tpu.fleet.catalog import ModelSpec
        from tfmesos_tpu.fleet.launcher import FleetServer as Fleet
    else:
        from tfmesos_tpu_torch.fleet.catalog import ModelSpec
        Fleet = FleetServer
    out = []
    if option == "models":
        kws = [dict(models=[ModelSpec(m) for m in value])]
    elif option == "warm_pool":
        kws = [dict(replicas=1, warm_pool=value),
               dict(models=[ModelSpec("chat")], warm_pool=value)]
    elif option == "gang_size":
        kws = [dict(replicas=1, gang_size=value), dict(gang_size=0),
               dict(gang_size=value, replicas=0, prefill_replicas=1,
                    decode_replicas=1),
               dict(models=[ModelSpec("chat", replicas=2,
                                      gang_size=value)], warm_pool=1)]
    else:
        kws = [dict(replicas=1, autoscale=value),
               dict(replicas=3, autoscale=value, min_replicas=2)]
    for kw in kws:
        try:
            f = Fleet(**kw)
        except ValueError as e:
            out.append(("raised", str(e)))
            continue
        keys = ["unified"] + [f"{m}/unified" for m in
                              (f.catalog.ids() if f.catalog else ())]
        out.append((f.autoscale, f.min_replicas, f.max_replicas,
                    f.replica_budget, f.warm_pool,
                    {k: f.bounds(k) for k in keys},
                    {k: f.gang_size_for(k) for k in keys + ["prefill"]}))
    return out


@pytest.mark.parametrize("option,value", [
    ("autoscale", True), ("models", ["chat"]), ("warm_pool", 1),
    ("gang_size", 2), ("draft", True), ("gateway_processes", 2),
    ("http_port", 0), ("batch_lane", True), ("master", "zk://x")])
def test_options_not_ported_are_refused_by_name(option, value):
    """No JAX option waits any more (the ``_NOT_PORTED`` table is gone).
    ``draft`` is ported: it is accepted and
    puts ``--draft --n-draft`` on the replica command line, and a bad
    ``n_draft`` is the JAX fleet's ValueError.  ``autoscale``,
    ``models``, ``warm_pool`` and ``gang_size`` are ported: the option
    gives the fleet the JAX fleet gets (bounds, slot budget, gang sizes
    a key), or the same error.  ``gateway_processes``, ``http_port``,
    ``batch_lane`` and ``master`` are ported: the fleet keeps what the
    JAX fleet keeps (the gateway process command with the port's
    module, the class list with the lane's ``batch`` class, the
    master), and a negative count is the JAX fleet's ValueError."""
    from types import SimpleNamespace

    from tfmesos_tpu.fleet.launcher import FleetServer as JaxFleet
    from tfmesos_tpu_torch.fleet import launcher

    assert not hasattr(launcher, "_NOT_PORTED")

    if option in ("gateway_processes", "http_port", "batch_lane",
                  "master"):

        def kept(Fleet):
            f = Fleet(replicas=1, **{option: value})
            f.registry = SimpleNamespace(addr="127.0.0.1:1")
            cmd = f._gateway_cmd(7, True, f.http_port)[1:]
            if "--classes-json" in cmd:
                # The port's one addition: gateway processes get the
                # class table (the reference's run every label in the
                # default class, so its batch lane never yields there).
                i = cmd.index("--classes-json")
                assert json.loads(cmd[i + 1]) == [
                    dataclasses.asdict(c) for c in f.priority_classes]
                del cmd[i:i + 2]
            return (f.gateway_processes, f.http_port, f.master,
                    [repr(c) for c in f.priority_classes or ()],
                    " ".join(cmd).replace("tfmesos_tpu_torch.",
                                          "tfmesos_tpu."))

        assert kept(FleetServer) == kept(JaxFleet)
        if option == "batch_lane":
            mine = FleetServer(replicas=1, batch_lane=True)
            mine.registry = SimpleNamespace(addr="127.0.0.1:1")
            assert "--classes-json" in mine._gateway_cmd(0, False, None)
        assert getattr(FleetServer(replicas=1, **{option: value}),
                       option) == value
        if option == "gateway_processes":
            for Fleet in (FleetServer, JaxFleet):
                with pytest.raises(ValueError, match="gateway_processes "
                                                     "must be >= 0"):
                    Fleet(replicas=1, gateway_processes=-1)
        return

    if option in ("autoscale", "models", "warm_pool", "gang_size"):
        assert _control_fleet(False, option, value) \
            == _control_fleet(True, option, value)
        return
    if option == "draft":
        fleet = FleetServer(replicas=1, draft=value, n_draft=3)
        fleet.registry = SimpleNamespace(addr="127.0.0.1:1")
        assert "--draft --n-draft 3" in fleet._replica_cmd()
        with pytest.raises(ValueError, match="n_draft must be >= 1"):
            FleetServer(replicas=1, draft=True, n_draft=0)


def test_local_backend_pins_no_platform(tmp_path, monkeypatch):
    """The JAX LocalBackend sets ``JAX_PLATFORMS=cpu`` in every child;
    the port's passes the parent's environment through untouched."""
    from tfmesos_tpu_torch.backends.local import LocalBackend
    from tfmesos_tpu_torch.spec import Offer

    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    statuses = []
    sched = type("Sched", (), {
        "on_registered": lambda self, info: None,
        "on_offers": lambda self, offers: None,
        "on_status": lambda self, s: statuses.append(s.state)})()
    backend = LocalBackend()
    backend.start(sched)
    out = tmp_path / "env.txt"
    info = {"name": "t:0", "task_id": {"value": "t0"},
            "resources": [{"name": "cpus", "scalar": {"value": 1.0}},
                          {"name": "mem", "scalar": {"value": 1.0}}],
            "command": {"shell": True,
                        "value": f"env > {out}",
                        "environment": {"variables": [
                            {"name": "MARK", "value": "1"}]}}}
    try:
        backend.launch(Offer("o", "local", "127.0.0.1", 1.0, 1.0), [info])
        deadline = time.monotonic() + 20.0
        while "TASK_FINISHED" not in statuses \
                and time.monotonic() < deadline:
            time.sleep(0.02)
    finally:
        backend.stop()
    env = dict(line.split("=", 1) for line in
               out.read_text().splitlines() if "=" in line)
    assert env["MARK"] == "1"
    assert "JAX_PLATFORMS" not in env
