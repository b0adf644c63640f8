"""The port replica's wire surface against the JAX replica's on the CPU:
the same message to a JAX replica and to a port replica (tiny model,
same weights) gets the same reply — unknown ops, ``ping``, ``cancel``
found and not found, ``kv_stage`` and its bounded stage (full, TTL
expiry), unknown ``kv_ref``, ``wrong_model``, ``deadline_exceeded``,
malformed prompts and artifacts, ``prefill`` to a unified replica,
``generate`` to a prefill replica, a full prefill queue, ``migrate``,
``adopt``.  The hello and heartbeats carry the JAX replica's fields and
the JAX registry reads them alike; ``rid_seed_for_node`` gives the JAX
values; each option not ported yet is refused with exit code 2."""

import threading
import time

import numpy as np
import pytest
from torch_parity import (jax_compile_cache_off,  # noqa: F401
                          jax_replica, port_replica, replica_environ,
                          slow_streams, stop_replica, tiny_models)

TOKEN = "replica-surface-token"
ARGV = ["--tiny", "--rows", "4", "--model-id", "m1"]


@pytest.fixture(scope="module")
def models():
    return tiny_models()


@pytest.fixture(scope="module")
def pair(models):
    reps = {"jax": jax_replica(ARGV, TOKEN),
            "port": port_replica(ARGV, TOKEN, params=models[3])}
    yield reps
    for r in reps.values():
        stop_replica(r)


@pytest.fixture(scope="module")
def prefill_pair(models):
    argv = ARGV + ["--role", "prefill", "--rows", "2"]
    reps = {"jax": jax_replica(argv, TOKEN),
            "port": port_replica(argv, TOKEN, params=models[3])}
    yield reps
    for r in reps.values():
        stop_replica(r)


def _ask(addr, msg, body=None, timeout=60.0):
    from tfmesos_tpu.fleet.client import MuxConnection

    link = MuxConnection(addr, TOKEN)
    try:
        if body is None:
            return link.call(msg, timeout=timeout)
        return link.call_raw(msg, body, timeout=timeout)
    finally:
        link.close()


def _both(reps, msg, body=None):
    """(JAX reply, port reply) to one message, each on a fresh link."""
    return tuple(_ask(reps[k][0].addr, dict(msg), body)
                 for k in ("jax", "port"))


CASES = {
    "unknown_op": {"op": "frobnicate"},
    "ping": {"op": "ping"},
    "cancel_not_found": {"op": "cancel", "target": 12345},
    "kv_ref_unknown": {"op": "generate", "kv_ref": "nope",
                       "prompt": [1, 2, 3], "max_new_tokens": 2},
    "kv_stage_not_raw": {"op": "kv_stage", "xfer": "x"},
    "wrong_model": {"op": "generate", "prompt": [1, 2, 3],
                    "max_new_tokens": 2, "model": "other"},
    "deadline_exceeded": {"op": "generate", "prompt": [1, 2, 3],
                          "max_new_tokens": 4, "deadline_ms": 1e-6},
    "prompt_not_tokens": {"op": "generate", "prompt": "abc",
                          "max_new_tokens": 2},
    "prompt_missing": {"op": "generate", "max_new_tokens": 2},
    "prompt_empty": {"op": "generate", "prompt": [],
                     "max_new_tokens": 2},
    "no_new_tokens": {"op": "generate", "prompt": [1, 2],
                      "max_new_tokens": 0},
    "too_long": {"op": "generate", "prompt": list(range(90)),
                 "max_new_tokens": 60},
    "prefill_on_unified": {"op": "prefill", "prompt": [1, 2],
                           "max_new_tokens": 2},
    "adopt": {"op": "adopt", "model_id": "m2", "seed": 1},
    "kv_put_not_raw": {"op": "kv_put"},
    "served": {"op": "generate", "prompt": [5, 6, 7], "max_new_tokens": 3,
               "model": "m1"},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_same_reply_as_the_jax_replica(pair, case):
    want, got = _both(pair, CASES[case])
    if case == "served":
        for r in (want, got):
            r.pop("ttft_ms"), r.pop("total_ms")
    assert got == want
    assert got.get("op") != "error" or got["kind"] in (
        "bad_request", "wrong_model", "deadline_exceeded")


def test_migrate_on_an_idle_replica_suspends_the_next_arrival(pair):
    """``migrate`` with nothing in flight is acked, and the armed drain
    gives the next arrival back as a requeue marker, on both."""
    want, got = _both(pair, {"op": "migrate"})
    assert got == want == {"op": "migrated", "id": 1}
    want, got = _both(pair, CASES["served"])
    assert got == want
    assert got == {"op": "suspended", "id": 1, "requeue": True, "gen": 0,
                   "weights_version": "", "model_id": "m1"}


def test_out_of_vocab_prompt_is_refused_by_the_port(pair):
    """A deliberate deviation: the port rejects token ids outside the
    vocab at admission (on the card an out-of-range embedding gather
    is a device-side assert that ends the CUDA context), where the JAX
    gather clamps them and serves."""
    got = _ask(pair["port"][0].addr, {"op": "generate", "prompt": [1, 500],
                                      "max_new_tokens": 2})
    assert got == {"op": "error", "id": 1, "kind": "bad_request",
                   "error": "prompt token ids must lie in [0, 97), got "
                            "[1, 500]"}


RAW_CASES = {
    "kv_stage_no_xfer": {"op": "kv_stage"},
    "kv_stage": {"op": "kv_stage", "xfer": "stage-1"},
    "generate_no_manifest": {"op": "generate", "prompt": [1, 2],
                             "max_new_tokens": 2},
    "generate_bad_manifest": {"op": "generate", "prompt": [1, 2],
                              "max_new_tokens": 2,
                              "arrays": [{"name": "k", "dtype": "float32",
                                          "shape": [4, 4]}]},
}


@pytest.mark.parametrize("case", sorted(RAW_CASES))
def test_same_reply_to_raw_frames(pair, case):
    want, got = _both(pair, RAW_CASES[case], body=b"\x01\x02\x03")
    assert got == want


def test_stage_full_then_expired(pair, monkeypatch):
    """Eight pending transfers fill the stage (``overloaded``); past
    the TTL the next ``kv_stage`` purges them, and their ``kv_ref``
    reads as unknown."""
    for i in range(9):      # earlier tests may have staged one
        want, got = _both(pair, {"op": "kv_stage", "xfer": f"fill-{i}"},
                          body=b"abcd")
        assert got == want
        if got["op"] == "error":
            break
    assert i >= 7 and got["kind"] == "overloaded"
    assert got["error"] == "kv stage full (8 transfers pending)"
    now = time.monotonic()
    monkeypatch.setattr(time, "monotonic", lambda: now + 121.0)
    want, got = _both(pair, {"op": "kv_stage", "xfer": "late"}, body=b"x")
    assert got == want and got["op"] == "kv_staged"
    want, got = _both(pair, {"op": "generate", "kv_ref": "fill-0",
                             "prompt": [1, 2], "max_new_tokens": 2})
    assert got == want and got["kind"] == "bad_request"
    assert "unknown kv_ref 'fill-0'" in got["error"]


def test_cancel_found_ends_the_stream(pair):
    """A ``cancel`` naming an in-flight streamed call on the same link
    finds it, and the call ends ``deadline_exceeded``."""
    from tfmesos_tpu.fleet.client import MuxConnection

    replies = {}
    for which in ("jax", "port"):
        server = pair[which][0]
        inner = slow_streams(server, 0.01)
        link = MuxConnection(server.addr, TOKEN)
        try:
            first, ids, out = threading.Event(), [], {}

            def on_partial(frame):
                ids.append(frame["id"])
                first.set()

            def call():
                out["reply"] = link.call(
                    {"op": "generate", "prompt": [3, 1, 4, 1, 5],
                     "max_new_tokens": 100, "stream": True},
                    timeout=60.0, on_partial=on_partial)

            t = threading.Thread(target=call)
            t.start()
            assert first.wait(30.0)
            cancel = link.call({"op": "cancel", "target": ids[0]},
                               timeout=30.0)
            t.join(timeout=60.0)
        finally:
            server.handler = inner
            link.close()
        replies[which] = (cancel, out["reply"])
    assert replies["port"] == replies["jax"]
    cancel, final = replies["port"]
    assert cancel["found"] is True
    assert final["kind"] == "deadline_exceeded"


PREFILL_CASES = {
    "generate": {"op": "generate", "prompt": [1, 2], "max_new_tokens": 2},
    "migrate": {"op": "migrate"},
    "bad_prompt": {"op": "prefill", "prompt": [], "max_new_tokens": 2},
    "deadline": {"op": "prefill", "prompt": [1, 2, 3],
                 "max_new_tokens": 2, "deadline_ms": 1e-6},
    "unknown_op": {"op": "frobnicate"},
}


@pytest.mark.parametrize("case", sorted(PREFILL_CASES))
def test_prefill_role_same_reply(prefill_pair, case):
    want, got = _both(prefill_pair, PREFILL_CASES[case])
    assert got == want


def test_prefill_role_exports_the_same_artifact(prefill_pair):
    """The ``prefilled`` raw frame: the same meta (but its timing) and
    the same body bytes from both frameworks."""
    want, got = _both(prefill_pair, {"op": "prefill",
                                     "prompt": [9, 8, 7, 6, 5],
                                     "max_new_tokens": 4})
    for r in (want, got):
        assert r.meta.pop("prefill_ms") >= 0
    assert got.meta == want.meta
    assert np.allclose(np.frombuffer(got.body, np.float32),
                       np.frombuffer(want.body, np.float32),
                       rtol=1e-5, atol=1e-5)


def test_raw_generate_to_a_prefill_replica(prefill_pair):
    want, got = _both(prefill_pair, {"op": "generate", "prompt": [1]},
                      body=b"\x00")
    assert got == want and got["kind"] == "bad_request"


class _BlockingExports:
    """A batcher stand-in for the prefill handler: ``export_kv`` waits
    for ``release``, so admitted work piles up in the handler's
    queue."""

    def __init__(self):
        self.entered = threading.Event()
        self.release = threading.Event()
        self.deadline_cancels = 0

    def validate(self, req):
        pass

    def export_kv(self, req):
        self.entered.set()
        self.release.wait(30.0)
        return {"version": 1, "pos": int(req.prompt.size)}


def test_prefill_queue_full_same_reply():
    """With the worker busy and a queue of one, the third prefill is
    shed ``overloaded`` at once, by both handlers; the first two then
    export."""
    from tfmesos_tpu.fleet import replica as jr
    from tfmesos_tpu_torch.fleet import replica as pr

    replies = {}
    for name, mod in (("jax", jr), ("port", pr)):
        b = _BlockingExports()
        handler = mod.prefill_handler(b, max_queue=1)
        got, done = [], threading.Semaphore(0)

        def reply(out, got=got, done=done):
            got.append(out)
            done.release()

        for i in range(3):
            handler({"op": "prefill", "id": i + 1, "prompt": [1, 2, 3],
                     "max_new_tokens": 2}, reply)
            if i == 0:      # the worker holds the first export
                assert b.entered.wait(10.0)
        assert done.acquire(timeout=10.0)
        b.release.set()
        for _ in range(2):
            assert done.acquire(timeout=10.0)
        replies[name] = [r if isinstance(r, dict)
                         else ({k: v for k, v in r.meta.items()
                                if k != "prefill_ms"}, r.body)
                         for r in got]
    assert replies["port"] == replies["jax"]
    assert replies["port"][0]["kind"] == "overloaded"
    assert replies["port"][0]["error"] == "prefill queue full (1 pending)"


def test_swap_adapter_is_refused_as_not_ported(pair, prefill_pair):
    for reps in (pair, prefill_pair):
        got = _ask(reps["port"][0].addr, {"op": "swap_adapter",
                                          "adapter_version": "a1"})
        assert got["kind"] == "bad_request"
        assert "not ported yet" in got["error"]


@pytest.mark.parametrize("node", ["", "replica:0", "replica:17",
                                  "decode:3", "x:\u00fc"])
def test_rid_seed_for_node_matches_jax(node):
    from tfmesos_tpu.fleet.replica import rid_seed_for_node as jax_seed
    from tfmesos_tpu_torch.fleet.replica import rid_seed_for_node

    assert rid_seed_for_node(node) == jax_seed(node)


REFUSED = {
    "draft": (["--draft"], None),
    "warm_pool": (["--warm-pool"], None),
    "gang": ([], {"TPUMESOS_GANG_ID": "g1", "TPUMESOS_GANG_SIZE": "2",
                  "TPUMESOS_GANG_RANK": "0"}),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_unported_option_exits_2(case, monkeypatch, capsys):
    from tfmesos_tpu_torch.fleet import replica as pr

    argv, env = REFUSED[case]
    for k, v in (env or {}).items():
        monkeypatch.setenv(k, v)
    assert pr.main(["--tiny", "--device", "cpu"] + argv) == 2
    assert "not ported yet" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [["--kv-replication", "9"],
                                  ["--model-id", "no spaces"]],
                         ids=["kv_replication_range", "model_id"])
def test_invalid_option_exits_2_as_jax(argv, capsys):
    from tfmesos_tpu_torch.fleet import replica as pr

    assert pr.main(["--tiny", "--device", "cpu"] + argv) == 2
    assert "replica: " in capsys.readouterr().err


class _Sink:
    """A registry stand-in that records every frame a replica's
    heartbeat thread sends (decoded with the JAX package's wire)."""

    def __init__(self):
        from tfmesos_tpu import wire as jwire

        self.msgs = []
        self._listen = jwire.bind_ephemeral("127.0.0.1")
        self.addr = jwire.sock_addr(self._listen)

        def serve():
            while True:
                try:
                    conn, _ = self._listen.accept()
                except OSError:
                    return
                threading.Thread(target=read, args=(conn,),
                                 daemon=True).start()

        def read(conn):
            try:
                for msg in jwire.iter_msgs(conn, jwire.Framer(TOKEN)):
                    self.msgs.append(msg)
            except OSError:
                pass

        threading.Thread(target=serve, daemon=True).start()

    def close(self):
        from tfmesos_tpu import wire as jwire

        jwire.wake_listener(self._listen)
        self._listen.close()


def test_heartbeats_carry_the_jax_fields(models):
    """Both replicas under ``--warmup --prefix-cache-pages 8`` with a
    launch generation and node in their env: the hello says ``status:
    warming``, later beats drop it and carry role, kv_headroom, gen,
    node, weights_version, model_id, adapter_version and the
    prefix-cache summary; after the same request on each, the beats
    match field for field, the JAX registry makes the same entry of
    each, and ``drain`` ends the stream."""
    from tfmesos_tpu.fleet.registry import ReplicaRegistry

    env = replica_environ(generation=3, job="replica", index="2")
    beats = {}
    for which in ("jax", "port"):
        sink = _Sink()
        argv = ARGV + ["--warmup", "--prefix-cache-pages", "8",
                       "--weights-version", "v7", "--registry", sink.addr,
                       "--heartbeat-interval", "0.05"]
        rep = (jax_replica(argv, TOKEN, environ=env) if which == "jax"
               else port_replica(argv, TOKEN, params=models[3],
                                 environ=env))
        try:
            reply = _ask(rep[0].addr, {"op": "generate",
                                       "prompt": list(range(1, 71)),
                                       "max_new_tokens": 3})
            assert reply["op"] == "completion"
            n = len(sink.msgs)
            deadline = time.monotonic() + 10.0
            while len(sink.msgs) < n + 2 and time.monotonic() < deadline:
                time.sleep(0.02)
        finally:
            stop_replica(rep)
            deadline = time.monotonic() + 5.0
            while (not sink.msgs or sink.msgs[-1].get("op") != "drain") \
                    and time.monotonic() < deadline:
                time.sleep(0.02)
            sink.close()
        msgs = sink.msgs
        assert msgs[0]["op"] == "hello" and msgs[0]["status"] == "warming"
        assert msgs[-1] == {"op": "drain", "addr": rep[0].addr}
        beat = msgs[-2]
        assert beat["op"] == "heartbeat" and "status" not in beat
        beats[which] = (beat, msgs[0])
    jbeat, pbeat = beats["jax"][0], beats["port"][0]
    assert set(pbeat) == set(jbeat)
    assert set(beats["port"][1]) == set(beats["jax"][1])
    for key in jbeat:
        if key != "addr":
            assert pbeat[key] == jbeat[key], key
    assert pbeat["gen"] == 3 and pbeat["node"] == "replica:2"
    assert pbeat["role"] == "unified" and pbeat["kv_headroom"] > 0
    assert pbeat["prefix_cache"]["hashes"]
    infos = []
    for beat in (jbeat, pbeat):
        reg = ReplicaRegistry(token=TOKEN)
        reg.observe(dict(beat, op="hello"))
        info = reg.members()[0]
        infos.append({k: v for k, v in vars(info).items()
                      if k not in ("addr", "last_beat")})
    assert infos[1] == infos[0]
