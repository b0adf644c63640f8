"""The port's wire (``tfmesos_tpu_torch/wire.py``) against the JAX
package's, byte for byte and both ways: JSON frames and raw frames
(with a bf16 KV artifact body) one side encodes the other decodes to the
same object; a wrong token, an oversized meta, an oversized length and a
raw frame on a plain stream are refused by both; the token env contract
and the limits are the same.  The port's ``MuxConnection`` and
``ReplicaServer`` talk to the JAX package's (calls by id, partial
frames, raw replies, ``ping``, unknown ops, ``fabric_rpc``)."""

import socket
import threading

import numpy as np
import pytest
import torch

from tfmesos_tpu import wire as jw
from tfmesos_tpu_torch import wire as tw

TOKEN = "wire-parity-token"
SIDES = {"jax": jw, "port": tw}
PAIRS = [("jax", "port"), ("port", "jax")]

OBJECTS = [
    {"op": "generate", "id": 7, "prompt": [1, 2, 3], "max_new_tokens": 4,
     "stream": True, "deadline_ms": 12.5, "trace_id": "abc"},
    {"op": "hello", "addr": "127.0.0.1:1", "capacity": 4,
     "prefix_cache": {"page": 64, "hashes": ["00ff", "a1"]}},
    {"op": "error", "id": 3, "kind": "bad_request",
     "error": "unicode é中 and \"quotes\""},
    [1, "two", None, 3.25, True],
]


def _artifact():
    """A bf16 export-shaped artifact of the port (pages as bf16 CPU
    tensors)."""
    g = torch.Generator().manual_seed(3)
    k = torch.randn((2, 1, 2, 4, 8), generator=g).to(torch.bfloat16)
    v = torch.randn((2, 1, 2, 4, 8), generator=g).to(torch.bfloat16)
    return {"version": 1, "page_size": 4, "prefix_len": 0, "shared_len": 0,
            "pos": 3, "prompt_len": 3, "first_token": 5, "step": 1,
            "tokens": [5], "rid": 0, "quantized": False,
            "model": {"n_layers": 2, "kv_heads": 2, "head_dim": 8},
            "k": k, "v": v}


@pytest.mark.parametrize("i", range(len(OBJECTS)))
@pytest.mark.parametrize("enc,dec", PAIRS)
def test_json_frame_decodes_on_the_other_side(enc, dec, i):
    obj = OBJECTS[i]
    frame = SIDES[enc].encode(obj, TOKEN)
    assert frame == SIDES[dec].encode(obj, TOKEN)
    assert SIDES[dec].Framer(TOKEN).feed(frame) == [obj]
    a, b = socket.socketpair()
    try:
        SIDES[enc].send_msg(a, obj, TOKEN)
        assert SIDES[dec].recv_msg(b, TOKEN) == obj
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("enc,dec", PAIRS)
def test_raw_frame_with_a_bf16_artifact(enc, dec):
    """A port artifact packed (``pack_prefilled``) and framed raw by one
    side decodes on the other to the same meta and body; each side's
    ``unpack_prefilled`` reads the same bf16 bits."""
    from tfmesos_tpu import serving as js
    from tfmesos_tpu_torch import serving as ts

    art = _artifact()
    meta, body = ts.pack_prefilled(art)
    jmeta, jbody = js.pack_prefilled(js.unpack_prefilled(meta, body))
    assert jmeta == meta and bytes(jbody) == bytes(body)
    head = dict(meta, op="suspended", id=9)
    frame = SIDES[enc].encode_raw(head, body, TOKEN)
    assert frame == SIDES[dec].encode_raw(head, body, TOKEN)
    (got,) = SIDES[dec].Framer(TOKEN, allow_raw=True).feed(frame)
    assert got.meta == head and got.body == bytes(body)
    a, b = socket.socketpair()
    try:
        SIDES[enc].send_raw_msg(a, head, body, TOKEN)
        got = SIDES[dec].recv_msg(b, TOKEN, allow_raw=True)
    finally:
        a.close()
        b.close()
    assert got.meta == head and got.body == bytes(body)
    port_art = ts.unpack_prefilled(got.meta, got.body)
    jax_art = js.unpack_prefilled(got.meta, got.body)
    for name in ("k", "v"):
        assert torch.equal(port_art[name], art[name])
        assert np.array_equal(np.asarray(jax_art[name]).view(np.int16),
                              art[name].view(torch.int16).numpy())


@pytest.mark.parametrize("raw", [False, True], ids=["json", "raw"])
@pytest.mark.parametrize("enc,dec", PAIRS)
def test_wrong_token_is_rejected(enc, dec, raw):
    frame = (SIDES[enc].encode_raw({"op": "x"}, b"body", TOKEN) if raw
             else SIDES[enc].encode({"op": "x"}, TOKEN))
    with pytest.raises(SIDES[dec].WireError, match="bad auth tag"):
        SIDES[dec].Framer("another", allow_raw=True).feed(frame)
    a, b = socket.socketpair()
    try:
        a.sendall(frame)
        with pytest.raises(SIDES[dec].WireError, match="bad auth tag"):
            SIDES[dec].recv_msg(b, "another", allow_raw=True)
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("side", sorted(SIDES))
def test_oversized_meta_is_refused(side):
    w = SIDES[side]
    meta = {"op": "x", "pad": "m" * w.MAX_RAW_META}
    with pytest.raises(w.WireError, match="raw meta of"):
        w.encode_raw(meta, b"", TOKEN)
    a, b = socket.socketpair()
    try:
        with pytest.raises(w.WireError, match="raw meta of"):
            w.send_raw_msg(a, meta, b"", TOKEN)
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("enc,dec", PAIRS)
def test_crafted_oversized_meta_length_is_refused(enc, dec):
    """A tagged raw frame whose meta length field claims more than
    ``MAX_RAW_META``: refused after the tag check by both."""
    import hashlib
    import hmac
    import struct

    rest = struct.pack(">I", SIDES[enc].MAX_RAW_META + 1) + b"{}"
    tag = hmac.new(TOKEN.encode(), rest, hashlib.sha256).digest()
    payload = tag + rest
    frame = struct.pack(">I", 0x80000000 | len(payload)) + payload
    with pytest.raises(SIDES[dec].WireError, match="bad raw meta length"):
        SIDES[dec].Framer(TOKEN, allow_raw=True).feed(frame)


@pytest.mark.parametrize("side", sorted(SIDES))
def test_oversized_lengths_and_raw_on_a_plain_stream(side):
    import struct

    w = SIDES[side]
    with pytest.raises(w.WireError, match="exceeds limit"):
        w.Framer(TOKEN).feed(struct.pack(">I", w.MAX_FRAME + 1))
    with pytest.raises(w.WireError, match="exceeds limit"):
        w.Framer(TOKEN, allow_raw=True).feed(
            struct.pack(">I", 0x80000000 | (w.MAX_RAW_FRAME + 1)))
    with pytest.raises(w.WireError, match="not accepted"):
        w.Framer(TOKEN).feed(w.encode_raw({"op": "x"}, b"b", TOKEN))


def test_limits_and_token_contract_are_the_same(tmp_path):
    for name in ("MAX_FRAME", "MAX_RAW_FRAME", "MAX_RAW_META", "RAW_FLAG",
                 "TAG_SIZE", "TOKEN_ENV", "TOKEN_FILE_ENV"):
        assert getattr(tw, name) == getattr(jw, name), name
    path = tmp_path / "token"
    path.write_text("from-file\n")
    for env in ({}, {"TPUMESOS_TOKEN": "from-env"},
                {"TPUMESOS_TOKEN": "from-env",
                 "TPUMESOS_TOKEN_FILE": str(path)}):
        assert tw.load_token(env) == jw.load_token(env)
    assert tw.load_token({"TPUMESOS_TOKEN_FILE": str(path)}) == "from-file"
    assert len(tw.new_token()) == 32


def _echo_handler(msg, reply):
    """A stub replica handler: two partials then the echo; raw frames
    come back raw."""
    head = msg.meta if hasattr(msg, "meta") else msg
    if head.get("stream"):
        reply.partial({"op": "tokens", "id": head["id"], "off": 0,
                       "tokens": [1]})
        reply.partial({"op": "tokens", "id": head["id"], "off": 1,
                       "tokens": [2, 3]})
    if hasattr(msg, "meta"):
        reply(type(msg)(dict(head, op="echoed"), msg.body[::-1]))
    else:
        reply(dict(head, op="echoed"))


@pytest.mark.parametrize("server,client", PAIRS)
def test_mux_against_the_other_replica_server(server, client):
    from tfmesos_tpu.fleet import client as jc
    from tfmesos_tpu.fleet import replica as jr
    from tfmesos_tpu_torch.fleet import client as tc
    from tfmesos_tpu_torch.fleet import kvtier as tk
    from tfmesos_tpu_torch.fleet import replica as tr

    srv_mod = {"jax": jr, "port": tr}[server]
    mux_mod = {"jax": jc, "port": tc}[client]
    srv = srv_mod.ReplicaServer(_echo_handler, token=TOKEN).start()
    link = mux_mod.MuxConnection(srv.addr, TOKEN)
    try:
        parts = []
        out = [None] * 4

        def call(i):
            out[i] = link.call({"op": "generate", "n": i,
                                "stream": i % 2 == 0}, timeout=10.0,
                               on_partial=parts.append)

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10.0)
        assert sorted(r["n"] for r in out) == [0, 1, 2, 3]
        assert all(r["op"] == "echoed" for r in out)
        assert len(parts) == 4 and {p["id"] for p in parts} == {
            r["id"] for r in out if r["stream"]}
        raw = link.call_raw({"op": "generate"}, b"abc", timeout=10.0)
        assert raw.meta["op"] == "echoed" and raw.body == b"cba"
        assert link.call({"op": "ping"}, timeout=10.0)["op"] == "pong"
        bad = link.call({"op": "nope"}, timeout=10.0)
        assert bad["kind"] == "bad_request" and "nope" in bad["error"]
        assert link.notify({"op": "cancel", "target": 99})
        staged = tk.fabric_rpc(srv.addr, {"op": "kv_stage", "id": 5},
                               b"xyz", token=TOKEN)
        assert staged.meta["op"] == "echoed" and staged.body == b"zyx"
    finally:
        srv.stop()
    with pytest.raises(mux_mod.ConnectionLost):
        link.call({"op": "ping"}, timeout=10.0)
    link.close()
