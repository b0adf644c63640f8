"""Gang replicas of the port (``tfmesos_tpu_torch/fleet/gang.py`` with
the scheduler, registry, replica and launcher halves) against the JAX
package's, on the CPU.

* The protocol, ported from ``tests/test_gang.py`` over real sockets:
  the env contract and the token digest (equal to JAX's on seeded
  streams), forming, dispatch and digest verification, the join fence,
  the zombie exit, a break fired once, a stop without a break,
  ``leader_handler``; the registry's ``gang_lookup`` over the wire.
* Across frameworks over the shared wire: a JAX member joins a port
  leader and a port member a JAX leader, and their digests agree.
* The scheduler's ``add_gang`` stamps and all-or-nothing batch order,
  and the launcher's gang book (sizing, a whole-gang kill, one re-form
  a death under a fresh id) on stub schedulers.
* One CPU fleet of real processes (tiny model, ``gang_size=2``, local
  backend): its completions are the JAX batcher's greedy streams on the
  same weights, the leader counts no divergence, and a member SIGKILL
  re-forms the gang once, which then serves again.
"""

import os
import signal
import threading
import time
import types

import numpy as np
import pytest
import torch
from torch_parity import jax_compile_cache_off  # noqa: F401

from tfmesos_tpu.fleet import gang as jgang
from tfmesos_tpu.fleet import registry as jreg
from tfmesos_tpu_torch import wire
from tfmesos_tpu_torch.fleet.gang import (GANG_ENV_ID, GANG_ENV_RANK,
                                          GANG_ENV_SIZE, MAX_PENDING_DIGESTS,
                                          GangLeader, GangMember,
                                          leader_handler, read_gang_env,
                                          token_digest)
from tfmesos_tpu_torch.fleet.registry import ReplicaRegistry


def _wait(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.01)
    return cond()


# -- env contract + digests --------------------------------------------------


@pytest.mark.parametrize("env", [
    {GANG_ENV_ID: "replica/g1", GANG_ENV_SIZE: "4", GANG_ENV_RANK: "2"},
    {}, {GANG_ENV_ID: "g", GANG_ENV_SIZE: "x", GANG_ENV_RANK: "0"},
    {GANG_ENV_ID: "g", GANG_ENV_SIZE: "1", GANG_ENV_RANK: "0"},
    {GANG_ENV_ID: "g", GANG_ENV_SIZE: "2", GANG_ENV_RANK: "2"},
    {GANG_ENV_ID: "g", GANG_ENV_SIZE: "2"}], ids=str)
def test_read_gang_env_is_the_jax_contract(env):
    assert read_gang_env(env) == jgang.read_gang_env(env)
    assert (GANG_ENV_ID, GANG_ENV_SIZE, GANG_ENV_RANK,
            MAX_PENDING_DIGESTS) == (jgang.GANG_ENV_ID, jgang.GANG_ENV_SIZE,
                                     jgang.GANG_ENV_RANK,
                                     jgang.MAX_PENDING_DIGESTS)


def test_token_digest_is_jax_on_seeded_streams():
    rng = np.random.default_rng(19)
    for n in (0, 1, 7, 64):
        toks = rng.integers(-2 ** 40, 2 ** 40, n)
        for stream in (toks.tolist(), tuple(toks.tolist()),
                       list(toks.astype(np.int64))):
            assert token_digest(stream) == jgang.token_digest(stream)
        assert len(token_digest(toks.tolist())) == 16
    assert token_digest([]) == token_digest(None) == jgang.token_digest(None)
    assert token_digest([1, 2, 3]) != token_digest([3, 2, 1])


# -- leader/member protocol over real sockets --------------------------------


def _registry_with_leader_beat(leader, registry=ReplicaRegistry):
    reg = registry(token="").start()
    reg.observe({"op": "heartbeat", "addr": "127.0.0.1:9", "capacity": 4,
                 "outstanding": 0, "gen": leader.generation,
                 "gang": leader.gang_info()})
    return reg


def _form_dispatch_verify(leader_cls, member_cls, registry):
    """JAX ``test_gang_forms_dispatches_and_verifies_digests`` with the
    given sides: forms, one dispatch verified, one mismatch counted once
    a member."""
    broken = []
    leader = leader_cls("replica/g1", size=3, generation=0,
                        on_break=broken.append).start()
    reg = _registry_with_leader_beat(leader, registry)
    stop = threading.Event()
    members = [member_cls("replica/g1", 3, rank, 0, reg.addr,
                          execute=lambda head: [1, 2, head["n"]],
                          poll_interval=0.05, lookup_timeout=10.0)
               for rank in (1, 2)]
    threads = [threading.Thread(target=m.run, args=(stop,), daemon=True)
               for m in members]
    try:
        for t in threads:
            t.start()
        assert leader.wait_formed(timeout=10.0)
        assert leader.live == 3 and leader.gang_info()["live"] == 3
        leader.dispatch({"op": "generate", "id": 7, "n": 3})
        assert _wait(lambda: all(m.served >= 1 for m in members))
        leader.observe_local(7, [1, 2, 3])
        time.sleep(0.1)
        assert leader.divergence == 0
        leader.dispatch({"op": "generate", "id": 8, "n": 4})
        assert _wait(lambda: all(m.served >= 2 for m in members))
        leader.observe_local(8, [9, 9, 9])
        assert _wait(lambda: leader.divergence >= 2)
        assert leader.divergence == 2 and leader.dispatches == 2
        assert not leader.broken and broken == []
    finally:
        stop.set()
        leader.stop()
        reg.stop()
        for t in threads:
            t.join(timeout=5.0)
    return leader


@pytest.mark.parametrize("leader_side,member_side", [
    ("port", "port"), ("port", "jax"), ("jax", "port")])
def test_gang_forms_dispatches_and_verifies_across_frameworks(leader_side,
                                                             member_side):
    """Port members under a port leader, JAX members under a port leader
    (the port registry) and port members under a JAX leader (the JAX
    registry): the same frames, the same digests, no divergence until a
    leader's own completion differs."""
    sides = {"port": (GangLeader, GangMember, ReplicaRegistry),
             "jax": (jgang.GangLeader, jgang.GangMember,
                     jreg.ReplicaRegistry)}
    leader = _form_dispatch_verify(sides[leader_side][0],
                                   sides[member_side][1],
                                   sides[leader_side][2])
    if leader_side == "port":
        assert leader.acks == 4


def test_join_fencing_rejects_wrong_gang_and_generation():
    leader = GangLeader("replica/g2", size=2, generation=3).start()
    try:
        for bad in ({"gang_id": "replica/g2", "rank": 1, "gen": 2},
                    {"gang_id": "replica/OTHER", "rank": 1, "gen": 3},
                    {"gang_id": "replica/g2", "rank": 0, "gen": 3},
                    {"gang_id": "replica/g2", "rank": 5, "gen": 3},
                    {"gang_id": "replica/g2", "rank": "x", "gen": 3}):
            sock = wire.connect(leader.coord_addr, timeout=5.0)
            try:
                wire.send_msg(sock, dict(bad, op="gang_join"), "")
                reply = wire.recv_msg(sock, "")
                assert reply["op"] == "gang_joined"
                assert reply["ok"] is False, bad
            finally:
                sock.close()
        assert not leader.formed and leader.live == 1
    finally:
        leader.stop()


def test_member_zombie_fence_on_newer_generation_leader():
    leader = GangLeader("replica/g3", size=2, generation=5).start()
    reg = _registry_with_leader_beat(leader)
    try:
        member = GangMember("replica/g3", 2, 1, generation=4,
                            registry_addr=reg.addr, poll_interval=0.05,
                            lookup_timeout=2.0)
        assert member.run() == "no_leader"
        assert not leader.formed
    finally:
        leader.stop()
        reg.stop()


def test_member_eof_breaks_gang_once():
    broken = []
    leader = GangLeader("replica/g4", size=3, generation=0,
                        on_break=broken.append).start()
    reg = _registry_with_leader_beat(leader)
    stop, stop1 = threading.Event(), threading.Event()
    outcomes = {}

    def run(rank, member_stop):
        m = GangMember("replica/g4", 3, rank, 0, reg.addr,
                       poll_interval=0.05, lookup_timeout=10.0)
        outcomes[rank] = m.run(member_stop)

    t1 = threading.Thread(target=run, args=(1, stop1), daemon=True)
    t2 = threading.Thread(target=run, args=(2, stop), daemon=True)
    try:
        t1.start()
        t2.start()
        assert leader.wait_formed(timeout=10.0)
        stop1.set()
        leader.dispatch({"op": "generate", "id": 1})   # wakes the loop
        t1.join(timeout=5.0)
        # The leader sets the flag, then calls on_break: wait for both.
        assert _wait(lambda: leader.broken and broken, 5.0)
        assert broken == [1]
    finally:
        stop.set()
        leader.stop()
        reg.stop()
        t1.join(timeout=5.0)
        t2.join(timeout=5.0)
    assert outcomes.get(2) in ("leader_eof", "stopped")


def test_leader_stop_does_not_fire_on_break():
    broken = []
    leader = GangLeader("replica/g5", size=2, generation=0,
                        on_break=broken.append).start()
    reg = _registry_with_leader_beat(leader)
    stop = threading.Event()
    m = GangMember("replica/g5", 2, 1, 0, reg.addr, poll_interval=0.05,
                   lookup_timeout=10.0)
    t = threading.Thread(target=m.run, args=(stop,), daemon=True)
    try:
        t.start()
        assert leader.wait_formed(timeout=10.0)
    finally:
        leader.stop()
        time.sleep(0.2)
        stop.set()
        reg.stop()
        t.join(timeout=5.0)
    assert broken == []


def test_leader_handler_fans_out_and_observes_completions():
    """Plain generate heads dispatch to members before the leader serves
    them, completion tokens feed the digest check, control ops pass
    through; the wrapped reply keeps the stream and the connection key
    (a cancel on the same link finds the request)."""
    dispatched, observed, inner_calls = [], [], []

    class StubLeader:
        def dispatch(self, head):
            dispatched.append(head)

        def observe_local(self, mid, tokens):
            observed.append((mid, list(tokens)))

    def inner(msg, reply):
        inner_calls.append((msg, getattr(reply, "conn_key", None),
                            getattr(reply, "partial", None)))
        if isinstance(msg, dict) and msg.get("op") == "generate":
            reply({"op": "completion", "id": msg["id"], "tokens": [4, 5]})
        else:
            reply({"op": "ok"})

    out = []
    reply = out.append
    handler = leader_handler(inner, StubLeader())

    def replier(msg):
        out.append(msg)
    replier.conn_key, replier.partial = 77, print
    handler({"op": "generate", "id": 42}, replier)
    assert dispatched == [{"op": "generate", "id": 42}]
    assert observed == [(42, [4, 5])]
    assert out[-1]["op"] == "completion"
    assert inner_calls[-1][1:] == (77, print)
    handler({"op": "status"}, reply)
    assert dispatched == [{"op": "generate", "id": 42}]
    assert out[-1] == {"op": "ok"}
    raw = wire.RawFrame({"op": "generate", "id": 3}, b"")
    handler(raw, reply)                 # raw frames pass straight through
    assert len(dispatched) == 1


def test_registry_gang_lookup_over_the_wire_matches_jax():
    """Both registries answer ``gang_lookup`` on their socket alike."""
    got = []
    for registry in (ReplicaRegistry, jreg.ReplicaRegistry):
        reg = registry().start()
        try:
            reg.observe({"op": "heartbeat", "addr": "a:1", "capacity": 4,
                         "outstanding": 0, "gen": 0,
                         "gang": {"id": "replica/g9", "size": 2, "live": 2,
                                  "coord": "c:9"}})
            replies = []
            for gid in ("replica/g9", "replica/absent"):
                sock = wire.connect(reg.addr, timeout=5.0)
                try:
                    wire.send_msg(sock, {"op": "gang_lookup",
                                         "gang_id": gid}, "")
                    replies.append(wire.recv_msg(sock, ""))
                finally:
                    sock.close()
            got.append(replies)
        finally:
            reg.stop()
    assert got[0][0]["found"] and got[0][0]["coord"] == "c:9"
    assert not got[0][1]["found"]
    assert got[0] == got[1]


# -- scheduler: atomic placement + env contract ------------------------------


def _dyn_scheduler(pkg):
    """A dynamic scheduler of ``pkg`` with the minimum state ``add_gang``
    and ``_batch_order`` touch (no backend, no wire server)."""
    import importlib

    sched_mod = importlib.import_module(f"{pkg}.scheduler")
    logging = importlib.import_module(f"{pkg}.utils.logging")
    sched = sched_mod.TPUMesosScheduler.__new__(sched_mod.TPUMesosScheduler)
    sched.dynamic = True
    sched._stopped = False
    sched.tasks = []
    sched.volumes = []
    sched.generation = 0
    sched._gang_seq = 0
    sched._dyn_index = {}
    sched._lock = threading.RLock()
    sched._fatal = None
    sched.on_dynamic_death = None
    sched.log = logging.get_logger(f"{pkg}.scheduler")
    sched._revive_backend = lambda why: None
    return sched


def test_add_gang_stamps_env_and_labels_as_jax():
    out = {}
    for pkg in ("tfmesos_tpu_torch", "tfmesos_tpu"):
        sched = _dyn_scheduler(pkg)
        members = sched.add_gang("replica", ["cmd"] * 3, cpus=1.0, mem=64.0,
                                 envs=[{"K": str(i)} for i in range(3)])
        again = sched.add_gang("replica", ["cmd"] * 2)
        errors = []
        for bad in (dict(cmds=[]), dict(cmds=["a", "b"], envs=[{}])):
            with pytest.raises(ValueError) as e:
                sched.add_gang("replica", **bad)
            errors.append(str(e.value))
        out[pkg] = ([(t.gang, t.dynamic, t.generation, t.task_index,
                      dict(t.extra_env)) for t in members + again], errors)
    mine = out["tfmesos_tpu_torch"]
    assert mine == out["tfmesos_tpu"]
    assert [m[0] for m in mine[0]] == ["replica/g1"] * 3 + ["replica/g2"] * 2
    assert mine[0][2][4] == {"K": "2", GANG_ENV_ID: "replica/g1",
                             GANG_ENV_SIZE: "3", GANG_ENV_RANK: "2"}


def _orders(pkg):
    import importlib

    Offer = importlib.import_module(f"{pkg}.spec").Offer
    sched = _dyn_scheduler(pkg)
    gang = sched.add_gang("replica", ["cmd"] * 2, cpus=2.0, mem=100.0)
    loose = sched._add_task_locked("replica", "cmd", 1.0, 50.0, 0, None)
    name = {id(t): f"g{i}" for i, t in enumerate(gang)}
    name[id(loose)] = "loose"
    small = [Offer(id="o1", agent_id="a", hostname="h1", cpus=2.0,
                   mem=500.0, chips=0)]
    batch = small + [Offer(id="o3", agent_id="b", hostname="h2", cpus=3.0,
                           mem=500.0, chips=0)]
    out = [[name[id(t)] for t in sched._batch_order(o)]
           for o in (small, batch)]
    two = _dyn_scheduler(pkg)
    g1 = two.add_gang("replica", ["cmd"] * 2, cpus=2.0, mem=100.0)
    g2 = two.add_gang("replica", ["cmd"] * 2, cpus=2.0, mem=100.0)
    order = two._batch_order([Offer(id="o1", agent_id="a", hostname="h1",
                                    cpus=5.0, mem=500.0, chips=0)])
    out.append(sorted({t.gang for t in order}))
    assert {t.gang for t in order} in ({g1[0].gang}, {g2[0].gang})
    return out


def test_batch_order_places_gangs_all_or_nothing_as_jax():
    """One 2-cpu offer holds the loose task but not the gang (withheld);
    a batch holding both members admits the gang first; 5 cpus hold one
    of two gangs whole, never both halves."""
    mine = _orders("tfmesos_tpu_torch")
    assert mine[0] == ["loose"] and mine[1] == ["g0", "g1", "loose"]
    assert len(mine[2]) == 1
    assert mine == _orders("tfmesos_tpu")


def test_dynamic_death_hook_fires_off_the_status_thread():
    sched = _dyn_scheduler("tfmesos_tpu_torch")
    seen = []
    fired = threading.Event()

    def hook(task):
        seen.append((task, threading.current_thread().name))
        fired.set()

    task = sched.add_gang("replica", ["cmd"] * 2)[0]
    thread = threading.Thread(target=sched._fire_dynamic_death,
                              args=(hook, task), name="tpumesos-dyn-death",
                              daemon=True)
    thread.start()
    thread.join(5.0)
    assert fired.wait(5.0) and seen == [(task, "tpumesos-dyn-death")]


# -- launcher: the gang book (no processes) ----------------------------------


class _StubGangSched:
    def __init__(self):
        self.removed = []
        self.generation = 0
        self._seq = 0
        self._idx = 0
        self.tasks = []

    def add_gang(self, job, cmds, cpus=1.0, mem=1024.0, chips=0):
        self._seq += 1
        gid = f"{job}/g{self._seq}"
        members = []
        for _ in cmds:
            members.append(types.SimpleNamespace(
                id=f"t{self._idx}", job_name=job, task_index=self._idx,
                gang=gid))
            self._idx += 1
        self.tasks.extend(members)
        return members

    def remove_task(self, tid):
        found = any(t.id == tid for t in self.tasks)
        self.tasks = [t for t in self.tasks if t.id != tid]
        self.removed.append(tid)
        return found

    def tasks_of(self, job):
        return [t for t in self.tasks if t.job_name == job]

    def bump_generation(self):
        self.generation += 1
        return self.generation


def _gang_fleet(pkg):
    import importlib

    launcher = importlib.import_module(f"{pkg}.fleet.launcher")
    metrics = importlib.import_module(f"{pkg}.fleet.metrics")
    fleet = launcher.FleetServer(replicas=2, gang_size=2)
    fleet.scheduler = _StubGangSched()
    fleet._replica_cmd = lambda role, wv=None, model=None: "cmd"
    fleet.metrics = metrics.FleetMetrics()
    return fleet


def _launch_kill(pkg):
    fleet = _gang_fleet(pkg)
    node = fleet.launch_gang("unified", "v1")
    with fleet._gang_lock:
        (gid, info), = fleet._gangs.items()
    out = [node, dict(info), fleet.tier_actual("unified"),
           fleet.gang_size_for("unified"), fleet.gang_size_for("prefill")]
    fleet.launch_gang("unified", "v1")
    out.append(fleet.tier_actual("unified"))
    out += [fleet.kill_replica(node), sorted(fleet.scheduler.removed),
            gid in fleet._gangs, node in fleet._node_keys,
            fleet.tier_actual("unified")]
    return out


def test_launcher_launch_kill_and_tier_actual_count_gangs_as_one():
    """Rank 0 leads and routes; two member tasks are ONE replica; killing
    the leader's node kills the whole gang — as the JAX launcher does."""
    mine = _launch_kill("tfmesos_tpu_torch")
    assert mine[0] == "replica:0" and mine[1]["size"] == 2
    assert mine[2:5] == [1, 2, 1] and mine[5] == 2
    assert mine[6] is True and mine[7] == ["t0", "t1"]
    assert mine[8:] == [False, False, 1]
    assert mine == _launch_kill("tfmesos_tpu")


def _reform(pkg):
    fleet = _gang_fleet(pkg)
    fleet._started = True
    node = fleet.launch_gang("unified", "v1")
    with fleet._gang_lock:
        (gid, _), = fleet._gangs.items()
    members = [t for t in fleet.scheduler.tasks_of("replica")
               if t.gang == gid]
    fleet._on_dynamic_death(members[1])
    with fleet._gang_lock:
        (new_gid, new_info), = fleet._gangs.items()
    out = [fleet.scheduler.generation, sorted(fleet.scheduler.removed),
           new_gid != gid, new_info["key"], new_info["weights_version"],
           fleet.metrics.get("gang_reforms"), node in fleet._node_keys,
           fleet._node_keys.get(new_info["leader_node"])]
    fleet._on_dynamic_death(members[0])      # the sibling's own death
    out += [fleet.metrics.get("gang_reforms"), sorted(fleet._gangs)]
    fleet._on_dynamic_death(types.SimpleNamespace(
        id="x", gang=None, job_name="replica", task_index=9))
    out.append(fleet.metrics.get("gang_reforms"))
    return out


def test_launcher_gang_death_reforms_once_with_fresh_id():
    """A member's death tears the siblings down, bumps the generation and
    re-forms ONCE under a fresh gang id; the sibling's own death and a
    gang-less death re-form nothing — as the JAX launcher does."""
    mine = _reform("tfmesos_tpu_torch")
    assert mine[:8] == [1, ["t0"], True, "unified", "v1", 1, False,
                        "unified"]
    assert mine[8] == 1 and mine[9] == ["replica/g2"] and mine[10] == 1
    assert mine == _reform("tfmesos_tpu")


def test_launcher_gang_size_validation_as_jax():
    from tfmesos_tpu.fleet.launcher import FleetServer as JaxFleet
    from tfmesos_tpu_torch.fleet.launcher import FleetServer

    for kw in (dict(gang_size=0), dict(gang_size=2, replicas=0,
                                       prefill_replicas=1,
                                       decode_replicas=1)):
        errors = []
        for cls in (FleetServer, JaxFleet):
            with pytest.raises(ValueError) as e:
                cls(**kw)
            errors.append(str(e.value))
        assert errors[0] == errors[1]


# -- one CPU fleet of real processes -----------------------------------------

NEW = 6
SHAPE = dict(tiny=True, rows=2, max_len=64, page_size=16, prefill_bucket=16,
             device="cpu", request_timeout=120.0, start_timeout=120.0,
             heartbeat_interval=0.1)


def _prompts(n=4, seed=11):
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


def _leader_stats(fleet):
    from tfmesos_tpu_torch.fleet.client import MuxConnection

    (rep,) = [r for r in fleet.registry.alive()
              if (r.role or "unified") == "unified"]
    conn = MuxConnection(rep.addr, fleet.token)
    try:
        return rep, conn.call({"op": "stats"}, timeout=60.0)
    finally:
        conn.close()


def _generate(fleet, prompts):
    client = fleet.client(timeout=120.0)
    try:
        out = [None] * len(prompts)

        def one(i):
            out[i] = client.generate(prompts[i], NEW)["tokens"]

        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120.0)
        return out
    finally:
        client.close()


def test_gang_fleet_serves_jax_streams_and_reforms_after_a_member_kill(
        capfd):
    from tfmesos_tpu_torch.fleet.launcher import FleetServer

    prompts = _prompts()
    want = _jax_streams(prompts)
    fleet = FleetServer(replicas=1, gang_size=2, **SHAPE).start()
    try:
        assert _generate(fleet, prompts) == want
        rep, st = _leader_stats(fleet)
        gang = st["gang"]
        assert gang["size"] == 2 and gang["live"] == 2 and gang["formed"]
        assert gang["dispatches"] == len(prompts)
        assert _wait(lambda: _leader_stats(fleet)[1]["gang"]["acks"]
                     == len(prompts), 30.0)
        assert _leader_stats(fleet)[1]["gang"]["divergence"] == 0
        assert rep.gang_size == 2 and rep.gang_id == gang["id"]
        snap = fleet.snapshot()
        assert snap["gauges"]["roles"]["unified"]["gangs"] == 1
        # SIGKILL the member's process group: the leader breaks and
        # exits 1, and the launcher re-forms the gang once, fresh id.
        with fleet._gang_lock:
            (gid, info), = fleet._gangs.items()
        member = fleet.scheduler.backend._procs[info["task_ids"][1]]
        os.killpg(member.pid, signal.SIGKILL)
        assert _wait(lambda: fleet.metrics.get("gang_reforms") == 1, 30.0)
        with fleet._gang_lock:
            (new_gid, _), = fleet._gangs.items()
        assert new_gid != gid
        assert _wait(lambda: any(
            r.addr != rep.addr and r.gang_id == new_gid
            for r in fleet.registry.alive()), 90.0)
        assert fleet.scheduler.generation == 1
        assert _generate(fleet, prompts[:2]) == want[:2]
        # The member mirrors after the leader answered: wait its acks.
        assert _wait(lambda: _leader_stats(fleet)[1]["gang"]["acks"] == 2,
                     60.0)
        rep2, st2 = _leader_stats(fleet)
        assert rep2.gang_id == new_gid and st2["gang"]["generation"] == 1
        assert st2["gang"]["dispatches"] == 2
        assert st2["gang"]["divergence"] == 0
        assert fleet.metrics.get("gang_reforms") == 1
    finally:
        fleet.stop()
    out = capfd.readouterr().out
    assert f"gang {gid} formed (2 members, generation 0)" in out
    lines = [line for line in out.splitlines()
             if line.startswith("gang member stats ")]
    assert lines, out[-3000:]
    import json

    last = json.loads(lines[-1][len("gang member stats "):])
    assert last["gang"] == new_gid and last["generation"] == 1
    assert last["served"] == 2 and last["counters"]["prefills"] == 2


# -- a gang's KV through the fabric ------------------------------------------


def test_fabric_gang_host_loss_resume_round_trips_whole():
    """JAX ``test_fabric_gang_host_loss_resume_round_trips_whole`` on the
    port's batchers: each rank's parked session folds into ONE gang
    artifact that replicates through a port fabric; after the parker
    dies a survivor fetches it whole and splits it back, and every
    rank's resumed turn is the JAX batcher's cold full-history
    stream."""
    import jax

    from test_torch_kvfabric import FabricNet
    from tfmesos_tpu import serving as js
    from tfmesos_tpu.models import transformer as jt
    from tfmesos_tpu_torch import convert
    from tfmesos_tpu_torch import serving as ts
    from tfmesos_tpu_torch.fleet.kvtier import (KVTierStore, pack_gang_shards,
                                                unpack_gang_shards)
    from tfmesos_tpu_torch.models import transformer as tt

    dims = dict(vocab_size=97, d_model=32, n_layers=2, n_heads=4, d_ff=64,
                max_seq_len=128)
    jcfg = jt.TransformerConfig(dtype=jax.numpy.float32, **dims)
    jparams = jax.tree_util.tree_map(
        np.asarray, jt.init_params(jcfg, jax.random.PRNGKey(0)))
    tcfg = tt.TransformerConfig(dtype=torch.float32, **dims)
    tparams = convert.params_from_jax(jparams)
    kw = dict(rows=2, max_len=128, page_size=16, prefill_bucket=16)
    rng = np.random.RandomState(13)
    hist = list(rng.randint(0, 97, size=20))
    shards, toks1 = [], None
    for r in range(2):
        store = KVTierStore(ram_bytes=8 << 20, token="tok")
        b = ts.ContinuousBatcher(tcfg, tparams, kv_tier=store, device="cpu",
                                 **kw)
        (c,) = b.run([ts.Request(np.asarray(hist, np.int32), 6,
                                 session_id="g")])
        toks1 = c.tokens
        meta, body = store.resume("g")
        shards.append((dict(meta, rank=r), body))
    gmeta, gbody = pack_gang_shards(shards)
    net = FabricNet("port")
    fabs = {n: net.add(n, replication=2, ram=8 << 20)
            for n in ("a:1", "b:1", "c:1")}
    fabs["a:1"].park("g", gmeta, gbody)
    assert fabs["a:1"].store.stats()["park_replicated"] == 1
    net.kill("a:1")
    holder = "b:1" if fabs["b:1"].store.get("session", "g") else "c:1"
    resumer = "c:1" if holder == "b:1" else "b:1"
    got = fabs[resumer].resume("g")
    assert got is not None
    assert fabs[resumer].store.stats()["fabric_fetch_hit"] == 1
    back = unpack_gang_shards(dict(got[0]), got[1])
    assert [m["rank"] for m, _ in back] == [0, 1]
    hist += list(toks1) + list(rng.randint(0, 97, size=4))
    prompt2 = np.asarray(hist, np.int32)
    (ref,) = js.ContinuousBatcher(jcfg, jparams, **kw).run(
        [js.Request(prompt=prompt2, max_new_tokens=6)])
    for r, (smeta, sbody) in enumerate(back):
        store = KVTierStore(ram_bytes=8 << 20, token="tok")
        store.park("g", dict(smeta), sbody)
        b = ts.ContinuousBatcher(tcfg, tparams, kv_tier=store, device="cpu",
                                 **kw)
        (c2,) = b.run([ts.Request(prompt2, 6, session_id="g")])
        assert c2.tokens == ref.tokens, f"rank {r} diverged"
        assert store.stats()["resume"] == 1


def test_leader_process_breaks_once_and_exits_1_when_its_member_dies(
        tmp_path):
    """A gang of two replica processes (the env a fleet stamps, no
    fleet): once the leader is formed and serving, SIGKILL the member;
    the leader logs its break once and exits 1 (in a fleet the
    launcher's teardown SIGTERMs the leader's node runtime at the same
    moment, so the code is read here, from the process itself)."""
    import subprocess
    import sys

    reg = ReplicaRegistry(token="tok").start()
    env = dict(os.environ, TPUMESOS_TOKEN="tok",
               PYTHONPATH=os.pathsep.join(
                   [str(os.path.dirname(os.path.dirname(
                       os.path.abspath(__file__)))),
                    os.environ.get("PYTHONPATH", "")]),
               **{GANG_ENV_ID: "replica/g1", GANG_ENV_SIZE: "2"})
    env.pop("TPUMESOS_TOKEN_FILE", None)
    argv = [sys.executable, "-m", "tfmesos_tpu_torch.fleet.replica",
            "--tiny", "--device", "cpu", "--registry", reg.addr,
            "--heartbeat-interval", "0.05", "--rows", "2", "--max-len",
            "64", "--page-size", "16", "--prefill-bucket", "16"]
    logs = [open(tmp_path / f"rank{r}.log", "w+") for r in (0, 1)]
    procs = [subprocess.Popen(argv, env=dict(env, **{GANG_ENV_RANK: str(r)}),
                              stdout=logs[r], stderr=subprocess.STDOUT,
                              text=True) for r in (0, 1)]
    try:
        assert _wait(lambda: "replica serving on" in
                     (tmp_path / "rank0.log").read_text(), 120.0), \
            (tmp_path / "rank0.log").read_text()[-3000:]
        procs[1].kill()
        assert procs[1].wait(timeout=30.0) == -signal.SIGKILL
        assert procs[0].wait(timeout=60.0) == 1
        out = (tmp_path / "rank0.log").read_text()
        assert out.count("gang replica/g1 member rank 1 lost: gang "
                         "broken") == 1, out[-3000:]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for f in logs:
            f.close()
        reg.stop()


def test_int8_replicas_quantize_weights_and_pool():
    """The port's own ``int8`` fleet option reaches every replica
    command (a gang's members alike), and the replica's ``--int8``
    builds int8 weights over an int8 pool."""
    from tfmesos_tpu_torch.fleet import replica
    from tfmesos_tpu_torch.fleet.launcher import FleetServer
    from tfmesos_tpu_torch.ops.quant import QTensor
    from tfmesos_tpu_torch.serving import Request

    fleet = FleetServer(replicas=1, gang_size=2, int8=True)
    fleet.registry = types.SimpleNamespace(addr="127.0.0.1:1")
    assert " --int8 " in fleet._replica_cmd() + " "
    args = replica.build_parser().parse_args(
        ["--tiny", "--device", "cpu", "--int8",
         "--max-len", "64", "--page-size", "16", "--prefill-bucket", "16"])
    b = replica.build_batcher(args)
    assert isinstance(b.params["layers"]["wq"], QTensor)
    assert isinstance(b.pool["k"], QTensor)
    (c,) = b.run([Request(np.asarray([5, 9, 3], np.int32), 4)])
    assert len(c.tokens) == 4
