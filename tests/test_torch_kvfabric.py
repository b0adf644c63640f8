"""The port's KV fabric (``KVFabric``, ``rendezvous_order``) against the
reference's, and the tier on the port's fleet surface.

Without sockets: every fabric case of ``tests/test_kvfabric.py`` that
needs no gang runs on a mesh of JAX fabrics over the JAX registry and on
a mesh of port fabrics over the port's registry, each under the
reference's assertions, and the two observe the same; mixed meshes park
on one framework and resume on the other.  Over sockets, on the CPU: a
port ``--role kv`` holder keeps a JAX replica's replicated park behind
the JAX registry and serves it to a port replica after the parker
stopped; the holder never imports torch; the replica's tier rides its
heartbeat and ``stats``; and ``FleetServer`` / ``tfserve`` pass the KV
flags to every replica and boot the holders."""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
from torch_parity import (JaxFleet, jax_compile_cache_off,  # noqa: F401
                          jax_replica, port_replica, stop_replica,
                          tiny_models, wait_for)

from tfmesos_tpu import wire as jwire
from tfmesos_tpu.fleet import kvtier as jkv
from tfmesos_tpu.fleet import registry as jreg
from tfmesos_tpu_torch import wire as twire
from tfmesos_tpu_torch.fleet import kvtier as tkv
from tfmesos_tpu_torch.fleet import registry as treg

ROOT = Path(__file__).resolve().parent.parent
SIDES = {"jax": (jkv, jreg, jwire), "port": (tkv, treg, twire)}


class FabricNet:
    """An in-process fabric mesh with no sockets (the reference test's
    harness): ``rpc`` routes by addr to each peer fabric's handlers, and
    a real registry (``reg_side``'s) answers ``kv_peers`` / ``kv_locate``
    as its heartbeat socket would.  Each node is one framework's
    ``KVFabric`` over its ``KVTierStore``."""

    REG = "reg:0"

    def __init__(self, side="port", reg_side=None):
        self.side = side
        self.clock = [0.0]
        registry = SIDES[reg_side or side][1]
        self.reg = registry.ReplicaRegistry(clock=lambda: self.clock[0])
        self.fabrics, self.roles, self.dead = {}, {}, set()
        self.node_side = {}         # addr -> the framework of its fabric
        self.caller = side          # the framework of the calling fabric
        self.rpc_log = []

    def rpc(self, addr, meta, body=None, timeout=10.0):
        self.rpc_log.append((addr, meta.get("op")))
        if addr == self.REG:
            if meta["op"] == "kv_peers":
                return self.reg.kv_peers()
            return self.reg.kv_locate(meta.get("kind"), meta.get("key"))
        if addr in self.dead or addr not in self.fabrics:
            raise ConnectionRefusedError(f"{addr} is down")
        peer = self.fabrics[addr]
        if meta.get("op") == "kv_put":
            wire = SIDES[self.node_side[addr]][2]
            return peer.handle_put(wire.RawFrame(meta, body or b""))
        reply = peer.handle_fetch(meta)
        if hasattr(reply, "body"):
            # Across frameworks a frame is rebuilt as the caller's type,
            # as the wire would decode it.
            reply = SIDES[self.caller][2].RawFrame(reply.meta, reply.body)
        return reply

    def add(self, addr, replication=2, wv="v1", role=None, ram=1 << 20,
            disk_dir=None, disk_bytes=None, side=None):
        side = side or self.side
        kv = SIDES[side][0]
        stamp = {} if wv is None else {"weights_version": wv}
        store = kv.KVTierStore(ram_bytes=ram, disk_dir=disk_dir,
                               disk_bytes=disk_bytes, token="tok",
                               stamp=stamp)

        def rpc(a, meta, body=None, timeout=10.0):
            self.caller = side
            return self.rpc(a, meta, body, timeout)

        fab = kv.KVFabric(store, token="tok", self_addr=addr,
                          registry_addr=self.REG, replication=replication,
                          rpc=rpc, peer_ttl=0.0)
        self.fabrics[addr] = fab
        self.node_side[addr] = side
        if role:
            self.roles[addr] = role
        self.beat(addr)
        return fab

    def beat(self, addr):
        fab = self.fabrics[addr]
        msg = {"op": "heartbeat", "addr": addr, "capacity": 4,
               "outstanding": 0, "kv_tier": fab.summary()}
        wv = fab.store.stamp.get("weights_version")
        if wv:
            msg["weights_version"] = wv
        if addr in self.roles:
            msg["role"] = self.roles[addr]
        self.reg.observe(msg)

    def beat_all(self):
        for addr in self.fabrics:
            if addr not in self.dead:
                self.beat(addr)

    def kill(self, addr):
        """The process stops answering now; the registry marks it dead
        one sweep later."""
        self.dead.add(addr)
        self.clock[0] += 10.0
        self.beat_all()
        self.reg.sweep()


# -- the reference's cases, each returning what it observed ----------------


def replicated_park_lands_a_peer_copy(net, tmp_path):
    a = net.add("a:1")
    b = net.add("b:1")
    a.park("conv", {"n": 1}, b"kv-bytes" * 50)
    meta, body = b.store.get("session", "conv")
    assert body == b"kv-bytes" * 50 and meta["weights_version"] == "v1"
    st = a.store.stats()
    assert st["park_replicated"] == 1 and st["fabric_push"] == 1
    assert st.get("fabric_push_fail", 0) == 0
    assert b.store.stats()["fabric_store"] == 1
    return st, b.store.stats(), meta


def park_degrades_when_every_push_fails(net, tmp_path):
    a = net.add("a:1")
    net.add("b:1")
    net.dead.add("b:1")             # dials fail, the registry still lists it
    a.park("conv", {}, b"x" * 100)
    assert a.store.resume("conv") is not None
    st = a.store.stats()
    assert st["park_degraded"] == 1 and st.get("park_replicated", 0) == 0
    assert st["fabric_push_fail"] == 1
    return st


def replication_one_never_touches_the_wire(net, tmp_path):
    a = net.add("a:1", replication=1)
    net.add("b:1", replication=1)
    net.rpc_log.clear()
    a.park("conv", {}, b"x" * 10)
    assert net.rpc_log == []
    return a.store.stats()


def kv_role_holders_are_preferred(net, tmp_path):
    a = net.add("a:1")
    net.add("b:1")
    net.add("kv:1", replication=1, role="kv")
    targets = a._replica_targets("conv")
    assert targets[0] == "kv:1"
    a.park("conv", {}, b"x" * 20)
    assert net.fabrics["kv:1"].store.get("session", "conv") is not None
    assert net.fabrics["b:1"].store.get("session", "conv") is None
    return targets


def parker_death_forwards_the_copy(net, tmp_path):
    a = net.add("a:1")
    b = net.add("b:1")
    c = net.add("c:1")
    body = b"gang-of-one-kv" * 99
    a.park("conv", {"tokens": [1, 2, 3]}, body)
    net.beat_all()
    net.kill("a:1")
    other = c if b.store.get("session", "conv") else b
    meta, out = other.resume("conv")
    assert out == body and meta["tokens"] == [1, 2, 3]
    st = other.store.stats()
    assert st["fabric_fetch_hit"] == 1
    assert other.store.resume("conv") is not None
    return other.self_addr, st


def scale_to_zero_through_a_kv_holder(net, tmp_path):
    a = net.add("a:1")
    net.add("kv:1", replication=1, role="kv")
    a.park("conv", {}, b"z" * 64)
    net.beat_all()
    net.kill("a:1")
    late = net.add("late:1")
    got = late.resume("conv")
    assert got is not None and got[1] == b"z" * 64
    return late.store.stats()


def empty_locate_probes_rendezvous_heads(net, tmp_path):
    a = net.add("a:1")
    b = net.add("b:1")
    c = net.add("c:1")
    a.park("conv", {}, b"q" * 32)
    assert net.reg.kv_locate("session", "conv")["addrs"] == []
    holder = "b:1" if b.store.get("session", "conv") else "c:1"
    got = c.resume("conv") if holder == "b:1" else b.resume("conv")
    assert got is not None and got[1] == b"q" * 32
    return holder


def every_copy_died(net, tmp_path):
    a = net.add("a:1", replication=1)
    c = net.add("c:1")
    a.park("conv", {}, b"x" * 16)
    net.beat_all()
    net.kill("a:1")
    assert c.resume("conv") is None
    return c.store.stats()


def stale_fence_copy_is_rejected(net, tmp_path):
    old = net.add("old:1", replication=1, wv="v1")
    new = net.add("new:1", wv="v2")
    old.park("conv", {}, b"stale-kv" * 10)
    net.beat_all()
    assert new.resume("conv") is None
    st = new.store.stats()
    assert st["fabric_reject_stale"] == 1
    assert st.get("fabric_fetch_hit", 0) == 0
    assert new.store.get("session", "conv") is None
    return st


def holder_disk_corruption_is_a_miss(net, tmp_path):
    h = net.add("h:1", replication=1, ram=0, disk_dir=str(tmp_path),
                disk_bytes=1 << 20)
    c = net.add("c:1")
    h.park("conv", {}, b"payload" * 100)
    net.beat_all()
    (path,) = [p for p in tmp_path.iterdir() if p.name.endswith(".kvt")]
    blob = bytearray(path.read_bytes())
    blob[len(blob) // 2] ^= 0x40
    path.write_bytes(bytes(blob))
    assert c.resume("conv") is None
    assert h.store.stats()["corrupt"] == 1 and not path.exists()
    assert c.store.stats()["fabric_fetch_miss"] >= 1
    return h.store.stats(), c.store.stats()


def handle_put_validates(net, tmp_path):
    a = net.add("a:1", replication=1, ram=2000, wv=None, role="kv")
    frame = SIDES[net.side][2].RawFrame
    out = [a.handle_put(frame({"op": "kv_put", "kind": "nope", "key": "k",
                               "meta": {}}, b"")),
           a.handle_put(frame({"op": "kv_put", "kind": "session", "key": "",
                               "meta": {}}, b"")),
           a.handle_put(frame({"op": "kv_put", "kind": "session",
                               "key": "big", "meta": {}}, b"x" * 50_000)),
           a.handle_put(frame({"op": "kv_put", "kind": "session",
                               "key": "s", "meta": {"weights_version":
                                                    "v9"}}, b"x" * 100))]
    assert [o.get("kind") for o in out[:3]] == ["bad_request", "bad_request",
                                                "kv_tier_full"]
    assert out[3]["op"] == "kv_put_ok"
    assert a.store.get("session", "s")[0]["weights_version"] == "v9"
    for o in out:
        o.pop("error", None)
    return out


def handle_fetch_terminates_locate_loops(net, tmp_path):
    a = net.add("a:1")
    b = net.add("b:1")
    for addr in ("a:1", "b:1"):
        net.reg.observe({"op": "heartbeat", "addr": addr, "capacity": 4,
                         "outstanding": 0, "weights_version": "v1",
                         "kv_tier": {"sessions": ["ghost"],
                                     "counters": {}}})
    miss = a.handle_fetch({"op": "kv_fetch", "kind": "session",
                           "key": "ghost"})
    assert miss["op"] == "kv_miss"
    assert a.resume("ghost") is None and b.resume("ghost") is None
    bad = a.handle_fetch({"op": "kv_fetch", "kind": "x", "key": "k"})
    assert bad["kind"] == "bad_request"
    return miss, a.store.stats()


def registry_kv_peers_and_locate(net, tmp_path):
    net.add("b:1")
    a = net.add("a:1", replication=1)
    net.add("kv:1", replication=1, role="kv")
    net.reg.observe({"op": "heartbeat", "addr": "plain:1", "capacity": 4,
                     "outstanding": 0})
    peers = [p["addr"] for p in net.reg.kv_peers()["peers"]]
    assert peers[0] == "kv:1" and set(peers) == {"kv:1", "a:1", "b:1"}
    a.park("conv", {}, b"x" * 10)
    a.store.prefix_geometry = {"page": 8, "first": 16, "seed": 0}
    a.store.put_prefix("deadbeef", {}, b"y" * 10)
    net.beat("a:1")
    assert net.reg.kv_locate("session", "conv")["addrs"] == ["a:1"]
    assert net.reg.kv_locate("prefix", "deadbeef")["addrs"] == ["a:1"]
    assert net.reg.kv_locate("session", "nope")["addrs"] == []
    return peers


def partition_degrades_then_heals(net, tmp_path):
    """A partition between one peer pair (its pushes fail while both stay
    registry-alive): the park lands locally, degraded; once healed the
    next park replicates."""
    a = net.add("a:1")
    net.add("b:1")
    real, cut = a._rpc, [True]

    def rpc(addr, meta, body=None, timeout=10.0):
        if cut[0] and addr == "b:1":
            raise ConnectionResetError("partitioned from b:1")
        return real(addr, meta, body, timeout)

    a._rpc = rpc
    a.park("conv", {}, b"x" * 40)
    st = a.store.stats()
    assert st["park_degraded"] == 1 and st["fabric_push_fail"] == 1
    cut[0] = False
    a.park("conv2", {}, b"y" * 40)
    assert a.store.stats()["park_replicated"] == 1
    assert net.fabrics["b:1"].store.get("session", "conv2") is not None
    return st, a.store.stats()


def prefix_fetch_through(net, tmp_path):
    """A spilled prefix page missing locally is fetched from the peer
    that holds it, counted ``fabric_prefix_fetches``."""
    a = net.add("a:1", replication=1)
    b = net.add("b:1")
    a.store.prefix_geometry = {"page": 16, "first": 16, "seed": ""}
    a.store.put_prefix("ab" * 32, {"k_bytes": 4}, b"pagebyte")
    net.beat_all()
    meta, body = b.get_prefix("ab" * 32)
    assert body == b"pagebyte" and meta["k_bytes"] == 4
    assert b.store.stats()["fabric_prefix_fetches"] == 1
    assert b.get_prefix("cd" * 32) is None
    return b.store.stats()


def loaded_placement_order(net, tmp_path):
    """``placement='loaded'`` re-scores the rendezvous order by the
    peers' advertised occupancy buckets."""
    kv = SIDES[net.side][0]
    peers = [{"addr": f"r{i}:1", "occupancy": occ}
             for i, occ in enumerate([0.9, 0.1, None, 0.5, 2.0, -1.0,
                                      float("nan"), 0.3])]
    fab = kv.KVFabric(kv.KVTierStore(ram_bytes=100), placement="loaded",
                      peers=lambda: peers)
    plain = kv.KVFabric(kv.KVTierStore(ram_bytes=100),
                        peers=lambda: peers)
    out = {key: (fab._replica_targets(key), plain._replica_targets(key))
           for key in ("conv", "other", "x" * 40)}
    for bad in (dict(replication=0), dict(placement="random")):
        with pytest.raises(ValueError):
            kv.KVFabric(kv.KVTierStore(ram_bytes=100), **bad)
    return out


CASES = [replicated_park_lands_a_peer_copy,
         park_degrades_when_every_push_fails,
         replication_one_never_touches_the_wire,
         kv_role_holders_are_preferred, parker_death_forwards_the_copy,
         scale_to_zero_through_a_kv_holder,
         empty_locate_probes_rendezvous_heads, every_copy_died,
         stale_fence_copy_is_rejected, holder_disk_corruption_is_a_miss,
         handle_put_validates, handle_fetch_terminates_locate_loops,
         registry_kv_peers_and_locate, partition_degrades_then_heals,
         prefix_fetch_through, loaded_placement_order]


@pytest.mark.parametrize("case", CASES, ids=lambda f: f.__name__)
def test_fabric_case_matches_jax(case, tmp_path):
    """One case of the reference's fabric tests on a JAX mesh and on a
    port mesh: both pass its assertions and observe the same."""
    got = {}
    for side in SIDES:
        (tmp_path / side).mkdir()
        got[side] = case(FabricNet(side), tmp_path / side)
    assert got["port"] == got["jax"]


def test_rendezvous_order_is_the_reference_order():
    addrs = [f"10.0.0.{i}:{7000 + i}" for i in range(9)]
    for i in range(64):
        key = f"conv-{i}"
        assert tkv.rendezvous_order(key, addrs) \
            == jkv.rendezvous_order(key, addrs)
    heads = {tkv.rendezvous_order(f"c{i}", addrs)[0] for i in range(64)}
    assert len(heads) > 1


@pytest.mark.parametrize("parker,rest", [("jax", "port"), ("port", "jax")])
def test_mixed_mesh_park_and_resume(parker, rest):
    """A park replicated from one framework's fabric lands on the other's
    peer, and after the parker dies a third node of the other framework
    resumes it (un-restamped, fence intact), over either registry."""
    for reg_side in SIDES:
        net = FabricNet(rest, reg_side=reg_side)
        a = net.add("a:1", side=parker)
        b = net.add("b:1")
        c = net.add("c:1")
        body = bytes(range(256)) * 4
        a.park("conv", {"history": [1, 2, 3]}, body)
        assert a.store.stats()["park_replicated"] == 1
        net.beat_all()
        net.kill("a:1")
        other = c if b.store.get("session", "conv") else b
        meta, out = other.resume("conv")
        assert out == body and meta["history"] == [1, 2, 3]
        assert meta["weights_version"] == "v1"
        assert other.store.stats()["fabric_fetch_hit"] == 1


# -- over sockets: replicas, the holder, the launcher, tfserve --------------

TOKEN = "kv-fabric-token"
ARGV = ["--tiny", "--rows", "2", "--max-len", "128", "--page-size", "16",
        "--prefill-bucket", "16", "--heartbeat-interval", "0.05"]


def _ask(addr, msg, timeout=120.0):
    from tfmesos_tpu.fleet.client import MuxConnection

    link = MuxConnection(addr, TOKEN)
    try:
        return link.call(msg, timeout=timeout)
    finally:
        link.close()


def _generate(addr, prompt, new, session=None):
    msg = {"op": "generate", "prompt": [int(t) for t in prompt],
           "max_new_tokens": new}
    if session:
        msg["session"] = session
    out = _ask(addr, msg)
    assert out["op"] == "completion", out
    return out["tokens"]


def _holder_args(extra=()):
    from tfmesos_tpu_torch.fleet import replica as pr

    return pr.build_parser().parse_args(
        ["--role", "kv", "--kv-tier-mb", "4", "--heartbeat-interval",
         "0.05"] + list(extra))


def test_port_kv_holder_serves_a_jax_replicas_park():
    """A JAX replica (tier, fabric, replication 2) behind the JAX registry
    parks a conversation; its copy lands on the port's ``--role kv``
    holder; the parker stops; a port replica behind the same registry
    resumes the next turn by ``kv_fetch`` from the holder, and the reply
    equals a cold full-history prefill."""
    jcfg, jparams, tcfg, tparams = tiny_models()
    from tfmesos_tpu_torch.fleet import replica as pr
    from tfmesos_tpu_torch.serving import ContinuousBatcher, Request

    fleet = JaxFleet(TOKEN)
    holder = pr.start_kv_holder(_holder_args(["--registry", fleet.addr]),
                                token=TOKEN)[0]
    tier = ["--kv-tier-mb", "4", "--kv-replication", "2", "--registry",
            fleet.addr]
    parker = jax_replica(ARGV + tier, TOKEN)
    resumer = None
    try:
        wait_for(lambda: {holder.addr, parker[0].addr} <= {
            p["addr"] for p in fleet.registry.kv_peers()["peers"]},
            what="the holder and the parker as fabric peers")
        rng = np.random.RandomState(12)
        p1 = [int(t) for t in rng.randint(0, 97, size=30)]
        r1 = _generate(parker[0].addr, p1, 6, session="conv")
        fab = parker[2].kv_tier
        assert fab.store.stats()["park_replicated"] == 1
        held = _ask(holder.addr, {"op": "stats"})
        assert held["summary"]["sessions"] == ["conv"]
        assert held["kv_tier"]["fabric_store"] == 1
        stop_replica(parker)
        parker = None
        resumer = port_replica(ARGV + ["--kv-tier-mb", "4", "--registry",
                                       fleet.addr], TOKEN, params=tparams)
        wait_for(lambda: holder.addr in fleet.registry.kv_locate(
            "session", "conv")["addrs"], what="the holder's placement")
        p2 = p1 + r1 + [int(t) for t in rng.randint(0, 97, size=7)]
        r2 = _generate(resumer[0].addr, p2, 6, session="conv")
        cold = ContinuousBatcher(tcfg, tparams, rows=2, max_len=128,
                                 page_size=16, prefill_bucket=16,
                                 device="cpu")
        (want,) = cold.run([Request(np.asarray(p2, np.int32), 6)])
        assert r2 == list(want.tokens)
        st = _ask(resumer[0].addr, {"op": "stats"})
        assert st["kv_tier"]["resume"] == 1
        assert st["kv_tier"]["fabric_fetch_hit"] == 1
        assert st["counters"]["tail_prefills"] == 1
    finally:
        for rep in (parker, resumer):
            if rep is not None:
                stop_replica(rep)
        holder.stop()
        fleet.close()


def test_replica_tier_rides_heartbeat_and_stats():
    """``--kv-tier-mb`` builds a stamped store; behind a registry the
    batcher's tier is the fabric, its summary rides every heartbeat (the
    router's session affinity) and ``stats`` reports its counters."""
    _, _, _, tparams = tiny_models()
    fleet = JaxFleet(TOKEN)
    rep = port_replica(ARGV + ["--kv-tier-mb", "2", "--registry",
                               fleet.addr, "--weights-version", "v3"],
                       TOKEN, params=tparams)
    try:
        server, _, batcher = rep
        assert isinstance(batcher.kv_tier, tkv.KVFabric)
        assert batcher.kv_tier.stamp == {"weights_version": "v3", "gen": 0}
        assert batcher.kv_tier.ram_bytes == 2_000_000
        _generate(server.addr, [5, 9, 3, 1, 4, 4, 2], 4, session="s1")
        wait_for(lambda: "s1" in ((fleet.info(server.addr).kv_tier or {})
                                  .get("sessions") or ()),
                 what="the parked session on a heartbeat")
        st = _ask(server.addr, {"op": "stats"})
        assert st["kv_tier"]["park"] == 1
        assert fleet.router.pick(session="s1") == server.addr
    finally:
        stop_replica(rep)
        fleet.close()


def test_kv_holder_process_never_imports_torch(tmp_path):
    """``python -m tfmesos_tpu_torch.fleet.replica --role kv`` serves
    ``kv_put`` / ``kv_fetch`` and answers ``stats`` with no torch, no
    CUDA context and no device memory; other ops are refused; without a
    tier it exits 2."""
    env = dict(os.environ, TPUMESOS_TOKEN=TOKEN, PYTHONPATH=str(ROOT))
    cmd = [sys.executable, "-m", "tfmesos_tpu_torch.fleet.replica",
           "--role", "kv"]
    bad = subprocess.run(cmd, env=env, cwd=str(tmp_path),
                         capture_output=True, text=True, timeout=60)
    assert bad.returncode == 2 and "needs a tier" in bad.stderr
    proc = subprocess.Popen(cmd + ["--kv-tier-mb", "1", "--kv-tier-dir",
                                   str(tmp_path / "tier")],
                            env=env, cwd=str(tmp_path),
                            stdout=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("replica serving on ") and "(role kv)" in line
        addr = line.split()[3]
        put = {"op": "kv_put", "kind": "session", "key": "conv",
               "meta": {"weights_version": "v1"}}
        from tfmesos_tpu.fleet.client import MuxConnection

        link = MuxConnection(addr, TOKEN)
        try:
            assert link.call_raw(put, b"abc" * 100,
                                 timeout=30)["op"] == "kv_put_ok"
            got = link.call({"op": "kv_fetch", "kind": "session",
                             "key": "conv"}, timeout=30)
            refused = link.call({"op": "generate", "prompt": [1],
                                 "max_new_tokens": 1}, timeout=30)
            stats = link.call({"op": "stats"}, timeout=30)
        finally:
            link.close()
        assert got.meta["op"] == "kv_artifact" and got.body == b"abc" * 100
        assert refused["kind"] == "bad_request"
        assert (stats["torch_imported"], stats["cuda_initialized"],
                stats["memory_allocated"]) == (False, False, 0)
        assert stats["summary"]["sessions"] == ["conv"]
        assert stats["summary"]["disk"] is True
    finally:
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0


@pytest.mark.parametrize("kw,want", [
    (dict(kv_tier_mb=8.0), ["--kv-tier-mb", "8.0", "--kv-tier-dir", "TMP"]),
    (dict(kv_tier_mb=8.0, kv_tier_dir="/srv/kv"),
     ["--kv-tier-mb", "8.0", "--kv-tier-dir", "/srv/kv"]),
    (dict(kv_tier_dir="/srv/kv"), ["--kv-tier-dir", "/srv/kv"]),
    (dict(kv_tier_mb=4.0, kv_replication=3, kv_placement="loaded",
          kv_replicas=1),
     ["--kv-tier-mb", "4.0", "--kv-tier-dir", "TMP", "--kv-replication",
      "3", "--kv-placement", "loaded"])], ids=["mb", "mb+dir", "dir",
                                               "fabric"])
def test_fleet_replica_cmd_carries_the_kv_flags(kw, want):
    """The KV options reach every replica's command line as the JAX
    fleet's do (the fleet's own temp directory when only a RAM budget is
    given)."""
    from tfmesos_tpu.fleet.launcher import FleetServer as JaxFleetServer
    from tfmesos_tpu_torch.fleet.launcher import FleetServer

    cmds = []
    for cls in (JaxFleetServer, FleetServer):
        f = cls(replicas=1, tiny=True, **kw)
        f.registry = SimpleNamespace(addr="127.0.0.1:1")
        f._kv_tier_tmp = "TMP" if f.kv_tier_dir is None \
            and f.kv_tier_mb > 0 else None
        argv = f._replica_cmd().split()
        first = next(i for i, a in enumerate(argv) if a.startswith("--kv"))
        cmds.append(argv[first:])
    assert cmds[1] == cmds[0] == want


@pytest.mark.parametrize("kw", [
    dict(kv_tier_mb=-1), dict(kv_tier_dir="-rf /"),
    dict(kv_tier_dir="a b"), dict(kv_replication=0),
    dict(kv_replication=9), dict(kv_placement="random"),
    dict(kv_replicas=-1), dict(kv_replicas=1)], ids=lambda kw: repr(kw))
def test_fleet_kv_options_validate_as_jax(kw):
    from tfmesos_tpu.fleet.launcher import FleetServer as JaxFleetServer
    from tfmesos_tpu_torch.fleet.launcher import FleetServer

    errors = []
    for cls in (JaxFleetServer, FleetServer):
        with pytest.raises(ValueError) as e:
            cls(replicas=1, **kw)
        errors.append(str(e.value))
    assert errors[1] == errors[0]


def test_tfserve_kv_tier_sessions_end_to_end(monkeypatch, capsys, tmp_path):
    """``tfserve --kv-tier-mb 8 --kv-tier-dir DIR --kv-replicas 1`` brings
    up one CPU replica and one KV holder with the flags on their command
    lines; ``submit --session`` parks a turn and resumes the next, which
    the gateway's ``kv_tier`` gauge counts."""
    from tfmesos_tpu_torch import cli

    monkeypatch.setenv("TPUMESOS_TOKEN", TOKEN)
    monkeypatch.delenv("TPUMESOS_TOKEN_FILE", raising=False)
    tier_dir = str(tmp_path / "kvtier")
    seen = {}

    def interrupted_sleep(_seconds):
        banner = capsys.readouterr().out.strip().splitlines()[-1]
        gw = banner.split()[3]
        seen["cmdlines"] = _cmdlines_with(tier_dir)
        outs = []
        prompt = [5, 9, 3, 7, 1, 2, 8, 6, 4]
        for turn in range(2):
            rc = cli.main(["submit", "-g", gw, "--prompt",
                           ",".join(map(str, prompt)), "-n", "4",
                           "--session", "chat-1"])
            out = json.loads(capsys.readouterr().out.strip()
                             .splitlines()[-1])
            assert rc == 0
            outs.append(out["tokens"])
            prompt = prompt + out["tokens"] + [3, 3]
            time.sleep(0.5)             # a heartbeat carries the park
        seen["outs"] = outs
        cli.main(["metrics", "-g", gw, "--json"])
        seen["metrics"] = json.loads(capsys.readouterr().out)
        raise KeyboardInterrupt

    monkeypatch.setattr(cli, "time", SimpleNamespace(sleep=interrupted_sleep))
    rc = cli.main(["serve", "--replicas", "1", "--tiny", "--device", "cpu",
                   "--rows", "2", "--max-len", "128", "-p", "0",
                   "--gateway-host", "127.0.0.1", "--metrics-interval", "0",
                   "--kv-tier-mb", "8", "--kv-tier-dir", tier_dir,
                   "--kv-replicas", "1"])
    assert rc == 0
    roles = sorted("--role kv" in c for c in seen["cmdlines"])
    assert roles == [False, True], seen["cmdlines"]
    assert all(f"--kv-tier-mb 8.0 --kv-tier-dir {tier_dir}" in c
               for c in seen["cmdlines"])
    assert [len(t) for t in seen["outs"]] == [4, 4]
    gauge = seen["metrics"]["gauges"]["kv_tier"]
    assert gauge["park"] == 2 and gauge["resume"] == 1, gauge
    assert not _cmdlines_with(tier_dir)     # every replica stopped


def _cmdlines_with(needle):
    """Command lines of live replica processes mentioning ``needle``."""
    out = []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/cmdline", "rb") as f:
                argv = f.read().split(b"\0")
        except OSError:
            continue
        line = " ".join(a.decode(errors="replace") for a in argv if a)
        if "tfmesos_tpu_torch.fleet.replica" in line and needle in line \
                and not line.startswith("/bin/sh"):
            out.append(line)
    return out
