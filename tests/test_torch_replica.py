"""One fleet, two frameworks: the JAX registry, router and gateway in
this process with one JAX replica (``tfmesos_tpu.fleet.replica``) and one
port replica (``tfmesos_tpu_torch.fleet.replica``) serving the same tiny
weights on the CPU.  Requests pinned to each replica, and mixed traffic
through ``FleetClient``, give the JAX package's offline greedy
``generate`` exactly; streamed partials carry offsets that rebuild the
list; a ``migrate`` sent mid-stream to either replica resumes on the
other token-identically, through the router's relay (a raw
``suspended`` frame) and through ``push_to`` (``kv_stage``, then
``kv_ref``); and a traced generate comes back with the JAX replica's
span names."""

import threading

import numpy as np
import pytest
from torch_parity import (JaxFleet, jax_compile_cache_off,  # noqa: F401
                          jax_replica, offline_generate, port_replica,
                          slow_streams, stop_replica, tiny_models,
                          wait_for)

TOKEN = "replica-parity-token"
ARGV = ["--tiny", "--rows", "4", "--heartbeat-interval", "0.05"]
NEW = 10
LONG = 100              # a migrated request's new tokens


def _prompts(n=8, seed=7):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 97, rng.randint(3, 41)).tolist()
            for _ in range(n)]


@pytest.fixture(scope="module")
def fleet():
    jcfg, jparams, _, tparams = tiny_models()
    f = JaxFleet(TOKEN)
    reps = {"jax": jax_replica(ARGV + ["--registry", f.addr], TOKEN),
            "port": port_replica(ARGV + ["--registry", f.addr], TOKEN,
                                 params=tparams)}
    f.reps = reps
    f.addrs = {k: r[0].addr for k, r in reps.items()}
    f.wait_routable(*f.addrs.values())
    prompts = _prompts()
    long_prompt = _prompts(1, seed=11)[0][:9]
    f.prompts = prompts
    f.want = offline_generate(jcfg, jparams, prompts, NEW)
    f.long_prompt = long_prompt
    f.long_want = offline_generate(jcfg, jparams, [long_prompt], LONG)[0]
    yield f
    for r in reps.values():
        stop_replica(r)
    f.close()


def _concurrently(fns):
    out, errors = [None] * len(fns), []

    def run(i):
        try:
            out[i] = fns[i]()
        except Exception as e:      # surfaced below
            errors.append((i, e))

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(fns))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120.0)
    assert not errors, errors
    return out


def _check_partials(parts, tokens):
    """Partial frames: contiguous offsets from 0 whose tokens are the
    final list's prefix (the last block's tokens may come only with
    the completion)."""
    got = []
    for p in parts:
        assert p["op"] == "tokens" and p["off"] == len(got), parts
        got += p["tokens"]
    assert got == tokens[:len(got)] and len(got) >= 1


@pytest.mark.parametrize("which", ["jax", "port"])
def test_pinned_generate_matches_offline(fleet, which):
    """Every request pinned to one replica over a mux link, half of them
    streamed: completions are the offline ``generate``'s, partials
    rebuild the list."""
    from tfmesos_tpu.fleet.client import MuxConnection

    link = MuxConnection(fleet.addrs[which], TOKEN)
    parts = [[] for _ in fleet.prompts]

    def call(i):
        return lambda: link.call(
            {"op": "generate", "prompt": fleet.prompts[i],
             "max_new_tokens": NEW, "stream": i % 2 == 0},
            timeout=120.0, on_partial=parts[i].append)

    try:
        replies = _concurrently([call(i)
                                 for i in range(len(fleet.prompts))])
    finally:
        link.close()
    for i, r in enumerate(replies):
        assert r["op"] == "completion" and r["tokens"] == fleet.want[i], i
        assert r["total_ms"] >= r["ttft_ms"] >= 0
        if i % 2 == 0:
            _check_partials(parts[i], r["tokens"])
        else:
            assert parts[i] == []


def test_mixed_traffic_through_the_gateway(fleet):
    """Concurrent traffic through ``FleetClient`` spreads over both
    replicas; every completion is the offline one, and the streamed
    requests' ``on_tokens`` see each token once, in order."""
    client = fleet.client()
    batchers = [fleet.reps[k][2] for k in ("jax", "port")]
    before = [b._next_rid for b in batchers]
    streamed = [[] for _ in fleet.prompts]

    def call(i):
        kw = {"on_tokens": streamed[i].extend} if i % 2 else {}
        return lambda: client.generate(fleet.prompts[i], NEW, **kw)

    replies = _concurrently([call(i) for i in range(len(fleet.prompts))])
    for i, r in enumerate(replies):
        assert r["tokens"] == fleet.want[i], i
        if i % 2:
            assert streamed[i] == r["tokens"], i
    # Admissions on each side (rids count them).
    assert all(b._next_rid > n for b, n in zip(batchers, before)), \
        "one replica served nothing"


@pytest.mark.parametrize("push", [False, True], ids=["relay", "push_to"])
@pytest.mark.parametrize("victim,survivor", [("port", "jax"),
                                             ("jax", "port")])
def test_migrate_resumes_on_the_other_framework(fleet, victim, survivor,
                                                push):
    """A streamed request on ``victim`` (the survivor held unroutable
    until its first tokens), then ``migrate`` to the victim through
    ``router.control``: the router resumes the suspended artifact on the
    survivor, and the client's stream and completion are the offline
    ``generate``'s, token for token."""
    router, metrics = fleet.router, fleet.metrics
    vsrv, ssrv = fleet.reps[victim][0], fleet.reps[survivor][0]
    saddr = fleet.addrs[survivor]
    before = dict(metrics.snapshot()["counters"])
    inner = slow_streams(vsrv, 0.02)
    ssrv.set_status("warming")
    try:
        wait_for(lambda: fleet.info(saddr).state == "warming",
                 what="survivor warming")
        first, streamed, out = threading.Event(), [], {}

        def on_tokens(toks):
            streamed.extend(toks)
            first.set()

        def call():
            out["reply"] = fleet.client().generate(
                fleet.long_prompt, LONG, on_tokens=on_tokens)

        t = threading.Thread(target=call)
        t.start()
        assert first.wait(60.0), "no token streamed"
        ssrv.set_status(None)
        fleet.wait_routable(saddr)
        msg = {"op": "migrate"}
        if push:
            msg["push_to"] = router.migration_target(fleet.addrs[victim])
            assert msg["push_to"] == saddr
        assert router.control(fleet.addrs[victim], msg)["op"] == "migrated"
        t.join(timeout=120.0)
    finally:
        vsrv.handler = inner
        ssrv.set_status(None)
    reply = out["reply"]
    assert reply["tokens"] == fleet.long_want
    assert streamed == fleet.long_want
    after = metrics.snapshot()["counters"]
    assert after.get("migration_resumes", 0) \
        == before.get("migration_resumes", 0) + 1
    assert after.get("migration_direct", 0) \
        == before.get("migration_direct", 0) + int(push)
    assert after.get("migration_reruns", 0) \
        == before.get("migration_reruns", 0)
    fleet.wait_routable(*fleet.addrs.values())


def test_traced_generate_carries_the_jax_span_names(fleet):
    """``trace_id`` + ``trace_detail`` on a pinned generate: both
    replicas answer with hop-local spans of the same names in the same
    order (``replica/recv``, the batcher's ``admit``, ``prefill``,
    ``decode``)."""
    from tfmesos_tpu.fleet.client import MuxConnection

    names = {}
    for which, addr in fleet.addrs.items():
        link = MuxConnection(addr, TOKEN)
        try:
            r = link.call({"op": "generate", "prompt": fleet.prompts[0],
                           "max_new_tokens": NEW, "trace_id": "t-" + which,
                           "trace_detail": True}, timeout=60.0)
            plain = link.call({"op": "generate",
                               "prompt": fleet.prompts[0],
                               "max_new_tokens": NEW, "trace_id": "u",
                               "trace_detail": False}, timeout=60.0)
        finally:
            link.close()
        assert r["tokens"] == fleet.want[0]
        assert "trace" not in plain     # the tail rule: nothing asked
        spans = r["trace"]
        assert all(s["dur"] >= 0 and s["t0"] >= 0 for s in spans)
        names[which] = [(s["component"], s["name"]) for s in spans]
    assert names["port"] == names["jax"]
    assert ("replica", "recv") in names["port"]
    assert ("batcher", "admit") in names["port"]
