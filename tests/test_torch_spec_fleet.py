"""Speculative replicas of both frameworks in one fleet: the JAX
registry, router and gateway in this process with a JAX replica and a
port replica, each started with ``--draft`` (the JAX tiny model and its
tiny draft, carried across).  Pinned and gateway traffic give the JAX
package's offline greedy ``generate`` exactly (greedy speculation is
lossless); a ``migrate`` mid-stream resumes on the other framework
token-identically, which a speculative survivor accepts only with the
victim's draft pages (``dk``/``dv``) in the artifact; and both
replicas' heartbeats feed the registry's ``spec`` gauge."""

import threading

import numpy as np
import pytest
from torch_parity import (JaxFleet, jax_compile_cache_off,  # noqa: F401
                          jax_replica, offline_generate, port_replica,
                          slow_streams, stop_replica, tiny_draft_params,
                          tiny_models, wait_for)

TOKEN = "spec-fleet-token"
ARGV = ["--tiny", "--rows", "4", "--heartbeat-interval", "0.05",
        "--draft", "--n-draft", "3"]
NEW = 10
LONG = 60


def _prompts(n=6, seed=17):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 97, rng.randint(3, 30)).tolist()
            for _ in range(n)]


@pytest.fixture(scope="module")
def fleet():
    jcfg, jparams, _, tparams = tiny_models()
    draft = tiny_draft_params(max_len=128, n_draft=3)[2]
    f = JaxFleet(TOKEN)
    reps = {"jax": jax_replica(ARGV + ["--registry", f.addr], TOKEN),
            "port": port_replica(ARGV + ["--registry", f.addr], TOKEN,
                                 params=tparams, draft_params=draft)}
    f.reps = reps
    f.addrs = {k: r[0].addr for k, r in reps.items()}
    f.wait_routable(*f.addrs.values())
    f.prompts = _prompts()
    f.want = offline_generate(jcfg, jparams, f.prompts, NEW)
    f.long_prompt = _prompts(1, seed=23)[0][:8]
    f.long_want = offline_generate(jcfg, jparams, [f.long_prompt], LONG)[0]
    yield f
    for r in reps.values():
        stop_replica(r)
    f.close()


def test_spec_replicas_serve_the_offline_greedy_streams(fleet):
    """Pinned to each replica and through the gateway: every completion
    is the offline ``generate``'s; both batchers ran speculative
    rounds."""
    from tfmesos_tpu.fleet.client import MuxConnection

    for which, addr in fleet.addrs.items():
        link = MuxConnection(addr, TOKEN)
        try:
            for i, p in enumerate(fleet.prompts):
                r = link.call({"op": "generate", "prompt": p,
                               "max_new_tokens": NEW}, timeout=120.0)
                assert r["tokens"] == fleet.want[i], (which, i)
        finally:
            link.close()
        assert fleet.reps[which][2].spec_rounds > 0
    client = fleet.client()
    out = [None] * len(fleet.prompts)

    def call(i):
        out[i] = client.generate(fleet.prompts[i], NEW)["tokens"]

    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(fleet.prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120.0)
    assert out == fleet.want


def test_the_registry_spec_gauge_reads_both_replicas(fleet):
    """Both replicas' heartbeats carry ``spec`` (rounds, row_rounds,
    committed, n_draft, acceptance_rate); the registry aggregates them
    over both."""
    for which, addr in fleet.addrs.items():
        b = fleet.reps[which][2]
        wait_for(lambda: (fleet.info(addr).spec or {}).get("rounds")
                 == b.spec_rounds, what=f"{which} spec beat")
        sp = fleet.info(addr).spec
        assert sp["n_draft"] == 3
        assert sp["acceptance_rate"] == b.acceptance_rate
    agg = fleet.registry.spec_summary()
    assert agg["replicas"] == 2 and agg["rounds"] > 0
    assert 0.0 <= agg["acceptance_rate"] <= 1.0


@pytest.mark.parametrize("victim,survivor", [("port", "jax"),
                                             ("jax", "port")])
def test_migrate_carries_the_draft_pages_both_ways(fleet, victim,
                                                   survivor):
    """A streamed request on ``victim``, then ``migrate``: the router
    resumes the suspended spec row on the survivor (a speculative
    batcher takes a mid-stream artifact only with its draft pages), and
    the stream is the offline one, with no rerun."""
    router, metrics = fleet.router, fleet.metrics
    vsrv, ssrv = fleet.reps[victim][0], fleet.reps[survivor][0]
    saddr = fleet.addrs[survivor]
    before = dict(metrics.snapshot()["counters"])
    inner = slow_streams(vsrv, 0.03)
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
        assert router.control(fleet.addrs[victim],
                              {"op": "migrate"})["op"] == "migrated"
        t.join(timeout=120.0)
    finally:
        vsrv.handler = inner
        ssrv.set_status(None)
    assert out["reply"]["tokens"] == fleet.long_want
    assert streamed == fleet.long_want
    after = metrics.snapshot()["counters"]
    assert after.get("migration_resumes", 0) \
        == before.get("migration_resumes", 0) + 1
    assert after.get("migration_reruns", 0) \
        == before.get("migration_reruns", 0)
    fleet.wait_routable(*fleet.addrs.values())
