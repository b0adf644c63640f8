"""The port's log pump (``tfmesos_tpu_torch/logpump.py`` over its own
``native/logpump.cpp``, built with g++ at first use): the JAX
``tests/test_logpump.py`` cases run on it (the native path, and the
pure-Python path where the case asks for it), and on the same child
output its local mirror and forwarded stream are byte-equal to the JAX
pump's."""

import os
import socket
import threading

import pytest

from torch_jax_cases import port_cases

globals().update(port_cases("test_logpump.py"))


def _pump(mod, chunks, forward=True):
    """Feed ``chunks`` through ``mod.pump_lines`` from a pipe (a writer
    thread, so a chunk may end mid-line); (local bytes, forwarded)."""
    r_fd, w_fd = os.pipe()
    out_r, out_w = os.pipe()
    fwd_a, fwd_b = socket.socketpair()

    def writer():
        for c in chunks:
            os.write(w_fd, c)
        os.close(w_fd)

    got = {}

    def reader(name, fd_or_sock):
        buf = b""
        while True:
            b = (fd_or_sock.recv(65536) if isinstance(fd_or_sock,
                                                      socket.socket)
                 else os.read(fd_or_sock, 65536))
            if not b:
                break
            buf += b
        got[name] = buf

    threads = [threading.Thread(target=writer),
               threading.Thread(target=reader, args=("local", out_r)),
               threading.Thread(target=reader, args=("fwd", fwd_b))]
    for t in threads:
        t.start()
    with os.fdopen(r_fd, "rb") as src, os.fdopen(out_w, "wb") as out:
        mod.pump_lines(src, out, fwd_a.fileno() if forward else -1,
                       b"[worker:7] ")
    fwd_a.close()
    for t in threads:
        t.join(timeout=10.0)
    os.close(out_r)
    fwd_b.close()
    return got["local"], got["fwd"]


PAYLOADS = {
    "lines": [b"a\nbb\nccc\n"],
    "split mid-line": [b"hel", b"lo\nwor", b"ld\n", b"tail"],
    "no newline": [b"just a tail"],
    "empty": [],
    "blank lines": [b"\n\n\nx\n\n"],
    "long line": [b"x" * 200000 + b"\n", b"y" * 70000],
    "binary": [bytes(range(256)) * 3 + b"\n"],
    "many chunks": [b"%d\n" % i for i in range(500)],
}


@pytest.mark.parametrize("forward", [True, False], ids=["fwd", "local"])
@pytest.mark.parametrize("name", sorted(PAYLOADS))
def test_native_pump_bytes_equal_jax(name, forward):
    from tfmesos_tpu import logpump as jax_logpump
    from tfmesos_tpu_torch import logpump

    assert logpump._load() is not None       # the native path
    want = _pump(jax_logpump, PAYLOADS[name], forward)
    got = _pump(logpump, PAYLOADS[name], forward)
    assert got == want
    assert got[0] == b"".join(PAYLOADS[name])
    if not forward:
        assert got[1] == b""


def test_native_pump_mirrors_whole_lines_only():
    """The local mirror never splits a line across writes (its stdout is
    shared with tfrun's forwarded lines): a partial line waits for its
    newline, and an unterminated tail goes out at EOF."""
    import select

    from tfmesos_tpu_torch import logpump

    assert logpump._load() is not None
    r_fd, w_fd = os.pipe()
    out_r, out_w = os.pipe()
    os.set_blocking(out_r, False)

    def pump():
        with os.fdopen(r_fd, "rb") as src, os.fdopen(out_w, "wb") as out:
            logpump.pump_lines(src, out, -1, b"")

    t = threading.Thread(target=pump)
    t.start()

    def drain(wait):
        select.select([out_r], [], [], wait)
        try:
            return os.read(out_r, 65536)
        except BlockingIOError:
            return b""

    os.write(w_fd, b"job name = ")
    assert drain(0.3) == b""                # held: no newline yet
    os.write(w_fd, b"worker\ntask ")
    assert drain(5.0) == b"job name = worker\n"
    os.write(w_fd, b"index = 0")
    assert drain(0.3) == b""
    os.close(w_fd)
    t.join(timeout=10.0)
    assert drain(5.0) == b"task index = 0"
    os.close(out_r)
