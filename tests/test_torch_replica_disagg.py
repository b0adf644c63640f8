"""Disaggregated serving across the two frameworks on the CPU: a port
prefill-role replica feeding a JAX decode-role replica, and a JAX
prefill replica feeding a port decode replica, both behind the JAX
registry, router and gateway on the same tiny weights.  Through the
gateway (the router brokers the decode replica, so the prefill replica
pushes its KV there as a ``kv_stage`` frame and the decode call names
it by ``kv_ref``) and through the relay (the raw ``prefilled`` frame
sent on as a raw ``generate``), completions are the JAX package's
offline greedy ``generate``."""

import threading

import numpy as np
import pytest
from torch_parity import (JaxFleet, jax_compile_cache_off,  # noqa: F401
                          jax_replica, offline_generate, port_replica,
                          stop_replica, tiny_models)

TOKEN = "replica-disagg-token"
NEW = 8
HB = ["--tiny", "--heartbeat-interval", "0.05"]


def _prompts(n=6, seed=23):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 97, rng.randint(3, 60)).tolist()
            for _ in range(n)]


@pytest.fixture(scope="module", params=[("port", "jax"), ("jax", "port")],
                ids=["port-prefill-jax-decode", "jax-prefill-port-decode"])
def tiers(request):
    jcfg, jparams, _, tparams = tiny_models()
    f = JaxFleet(TOKEN, workers=6)

    def make(kind, role, rows):
        argv = HB + ["--role", role, "--rows", str(rows),
                     "--registry", f.addr]
        if kind == "port":
            return port_replica(argv, TOKEN, params=tparams)
        return jax_replica(argv, TOKEN)

    pre_kind, dec_kind = request.param
    f.pre = make(pre_kind, "prefill", 2)
    f.dec = make(dec_kind, "decode", 4)
    f.wait_routable(f.pre[0].addr, f.dec[0].addr)
    f.prompts = _prompts()
    f.want = offline_generate(jcfg, jparams, f.prompts, NEW)
    yield f
    stop_replica(f.pre)
    stop_replica(f.dec)
    f.close()


def test_disagg_through_the_gateway(tiers):
    client = tiers.client()
    out = [None] * len(tiers.prompts)
    errors = []

    def one(i):
        try:
            out[i] = client.generate(tiers.prompts[i], NEW)
        except Exception as e:      # surfaced below
            errors.append((i, e))

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(out))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120.0)
    assert not errors, errors
    assert [r["tokens"] for r in out] == tiers.want
    c = tiers.metrics.snapshot()["counters"]
    assert c["disagg_requests"] == len(out)
    assert c["kv_direct_transfers"] == len(out)     # pushed, not relayed
    assert c.get("disagg_fallback", 0) == 0
    summary = tiers.registry.role_summary()
    assert summary["prefill"]["alive"] == 1
    assert summary["decode"]["alive"] == 1


def test_disagg_relay_through_raw_frames(tiers):
    """The relay path by hand: ``prefill`` answers with a raw
    ``prefilled`` frame, which goes on to the decode replica as a raw
    ``generate`` (the router's own meta rewrite), streamed."""
    from tfmesos_tpu import wire as jwire
    from tfmesos_tpu.fleet.client import MuxConnection

    plink = MuxConnection(tiers.pre[0].addr, TOKEN)
    dlink = MuxConnection(tiers.dec[0].addr, TOKEN)
    try:
        for prompt, want in zip(tiers.prompts[:3], tiers.want):
            frame = plink.call({"op": "prefill", "prompt": prompt,
                                "max_new_tokens": NEW}, timeout=60.0)
            assert isinstance(frame, jwire.RawFrame)
            assert frame.meta["op"] == "prefilled"
            assert frame.meta["prefill_ms"] >= 0
            meta = {k: v for k, v in frame.meta.items()
                    if k not in ("op", "id", "prefill_ms", "trace")}
            meta.update(op="generate", prompt=prompt, max_new_tokens=NEW,
                        stream=True)
            parts = []
            reply = dlink.call_raw(meta, frame.body, timeout=60.0,
                                   on_partial=parts.append)
            assert reply["op"] == "completion"
            assert reply["tokens"] == want
            got = [t for p in parts for t in p["tokens"]]
            assert got == want[:len(got)]
    finally:
        plink.close()
        dlink.close()
