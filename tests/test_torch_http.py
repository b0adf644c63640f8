"""The port's HTTP/SSE edge (``tfmesos_tpu_torch/fleet/http.py`` over the
port's ``WireServer.add_ingress``): the JAX ``tests/test_http.py`` cases
run on it, and one request battery sent to the JAX ``HttpIngress`` and
the port's, each on its own package's ``WireServer`` in front of the
same echo gateway, gets byte-equal answers (status line, headers, body,
SSE frames, and where the connection closes)."""

import json
import socket
import time

import pytest

import test_http as jax_cases
from torch_jax_cases import port_cases

globals().update(port_cases("test_http.py"))



def _post(body_obj, extra=b"Connection: close\r\n"):
    body = json.dumps(body_obj).encode()
    return (b"POST /v1/completions HTTP/1.1\r\n"
            b"Content-Type: application/json\r\n" + extra
            + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)


#: (id, raw bytes sent on one connection); every answer ends in a close.
BATTERY = [
    ("healthz", b"GET /healthz HTTP/1.1\r\nConnection: close\r\n\r\n"),
    ("healthz 1.0", b"GET /healthz HTTP/1.0\r\n\r\n"),
    ("json", _post({"prompt": [5, 6, 7], "max_tokens": 8})),
    ("json string prompt", _post({"prompt": "hi", "max_tokens": 8})),
    ("json max_tokens cuts", _post({"prompt": [1, 2, 3, 4, 5],
                                    "max_tokens": 2})),
    ("sse", _post({"prompt": [1, 2, 3, 4], "max_tokens": 8,
                   "stream": True})),
    ("sse one token", _post({"prompt": [9], "max_tokens": 8,
                             "stream": True})),
    ("keep-alive then close",
     _post({"prompt": [1, 2], "max_tokens": 8}, extra=b"")
     + _post({"prompt": [3], "max_tokens": 8})),
    ("headers route", _post({"prompt": [4, 4], "max_tokens": 8},
                            extra=b"X-Priority: batch\r\nX-Model: m1\r\n"
                                  b"X-Deadline-Ms: 500\r\n"
                                  b"Connection: close\r\n")),
    ("header overflow", b"GET /healthz HTTP/1.1\r\nX-Pad: "
                        + b"a" * 2048 + b"\r\n\r\n"),
] + [(f"hostile {i}", raw) for i, (raw, _) in enumerate(
    jax_cases.HOSTILE)]


def _edge(wire_mod, http_mod, gateway):
    srv = wire_mod.WireServer(lambda conn, msg: None, token="battery",
                              name="http-battery")
    srv.add_ingress(http_mod.HttpIngress(gateway, max_header=1024,
                                         max_body=2048, header_timeout=2.0,
                                         body_timeout=2.0))
    return srv.start()


def _exchange(addr, raw):
    host, _, port = addr.rpartition(":")
    with socket.create_connection((host, int(port)), timeout=10.0) as s:
        s.sendall(raw)
        s.settimeout(10.0)
        buf = b""
        t0 = time.monotonic()
        while True:
            try:
                chunk = s.recv(65536)
            except ConnectionResetError:
                return buf + b"<reset>"
            if not chunk:
                return buf
            buf += chunk
            assert time.monotonic() - t0 < 10.0


@pytest.fixture(scope="module")
def edges():
    from tfmesos_tpu import wire as jax_wire
    from tfmesos_tpu.fleet import http as jax_http
    from tfmesos_tpu_torch import wire
    from tfmesos_tpu_torch.fleet import http

    gateway = jax_cases._EchoGateway()
    jax_srv = _edge(jax_wire, jax_http, gateway)
    port_srv = _edge(wire, http, gateway)
    try:
        yield jax_srv.ingress_addrs[0], port_srv.ingress_addrs[0]
    finally:
        jax_srv.stop()
        port_srv.stop()


@pytest.mark.parametrize("raw", [r for _, r in BATTERY],
                         ids=[i for i, _ in BATTERY])
def test_battery_answers_byte_equal_to_jax(edges, raw):
    jax_addr, port_addr = edges
    want = _exchange(jax_addr, raw)
    got = _exchange(port_addr, raw)
    assert want.startswith(b"HTTP/1.")
    assert got == want
