"""A fake Mesos master with one agent, and a fake ZooKeeper that names it.

Stdlib only (no package import), so the tests and ``chip_smoke.py``
share it.  :class:`FakeMesos` speaks the v1 scheduler HTTP API the way
``tests/test_mesos_backend.py``'s ``FakeMaster`` does (a chunked
RecordIO SUBSCRIBE stream, every other call a recorded POST) and adds
the agent a real cluster would have behind it:

- it offers ``cpus``, ``mem`` and a scalar ``gpus`` (what it has free);
  one offer is out at a time, re-sent after an ACCEPT, a REVIVE, a task
  exit or the end of a DECLINE's ``refuse_seconds``, and never while the
  framework has SUPPRESSed offers;
- on ACCEPT it runs each TaskInfo's ``command.value`` through the shell
  with its ``environment.variables`` (SECRET values decoded), in a
  sandbox directory and a process group of its own, as Mesos's command
  executor does; the output goes to ``stdout`` / ``stderr`` files in
  the sandbox;
- it sends UPDATE ``TASK_RUNNING`` once a task started and the exit
  state when it ends (``TASK_FINISHED`` for 0, ``TASK_KILLED`` after a
  KILL, else ``TASK_FAILED``), and answers KILL with SIGTERM to the
  task's process group (SIGKILL 10 s later if it still runs);
- TEARDOWN kills every task and ends the stream.

:class:`FakeZK` serves the jute frames ``backends/zk.py`` sends
(connect, getChildren, getData) for one Mesos master znode.
"""

from __future__ import annotations

import base64
import json
import os
import queue
import shutil
import signal
import socket
import struct
import subprocess
import tempfile
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

__all__ = ["FakeMesos", "FakeZK", "record"]


def record(event: dict) -> bytes:
    """One RecordIO record: ``<length>\\n<json>``."""
    data = json.dumps(event).encode()
    return f"{len(data)}\n".encode() + data


def _scalars(resources: List[dict]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for r in resources or []:
        if r.get("type") == "SCALAR":
            out[r["name"]] = out.get(r["name"], 0.0) \
                + float(r["scalar"]["value"])
    return out


class _Task:
    def __init__(self, info: dict, proc: subprocess.Popen, sandbox: str,
                 used: Dict[str, float]):
        self.info = info
        self.id = info["task_id"]["value"]
        self.proc = proc
        self.sandbox = sandbox
        self.used = used
        self.killed = False
        self.started = time.monotonic()
        self.running_at: Optional[float] = None
        self.state = "TASK_STAGING"
        self.exit_code: Optional[int] = None


class FakeMesos:
    """A v1 scheduler API master on ``127.0.0.1`` with one agent that
    runs the tasks it launches as processes of this host."""

    def __init__(self, cpus: float = 32.0, mem: float = 262144.0,
                 gpus: float = 8.0, agent_id: str = "agent-1",
                 hostname: str = "127.0.0.1", version: str = "1.11.0",
                 heartbeat_s: float = 5.0, env: Optional[dict] = None):
        self.total = {"cpus": float(cpus), "mem": float(mem),
                      "gpus": float(gpus)}
        self.free = dict(self.total)
        self.agent_id = agent_id
        self.hostname = hostname
        self.version = version
        self.heartbeat_s = float(heartbeat_s)
        #: extra environment every task gets under its own variables
        self.env = dict(env or {})
        self.calls: List[dict] = []
        self.subscribes: List[dict] = []
        self.tasks: Dict[str, _Task] = {}
        #: (monotonic time, event) of everything this master did
        self.log: List[tuple] = []
        self.subscribed_at: Optional[float] = None
        self.work_dir = tempfile.mkdtemp(prefix="fake-mesos-")
        self._events: "queue.Queue[dict]" = queue.Queue()
        self._lock = threading.RLock()
        self._outstanding: Optional[str] = None     # offer id out now
        self._suppressed = False
        self._refuse_until = 0.0
        self._closing = False
        self._stream_open = False
        master = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def do_GET(self):
                body = json.dumps({"version": master.version}).encode() \
                    if self.path == "/version" else b""
                self.send_response(200 if body else 404)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(length) or b"{}")
                if body.get("type") == "SUBSCRIBE":
                    master._serve_stream(self, body)
                    return
                master._on_call(body)
                self.send_response(202)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def chunk(self, data: bytes):
                self.wfile.write(f"{len(data):x}\r\n".encode() + data
                                 + b"\r\n")
                self.wfile.flush()

        class Server(ThreadingHTTPServer):
            daemon_threads = True

            def handle_error(self, request, client_address):
                pass        # a framework hanging up is not an error here

        self.server = Server(("127.0.0.1", 0), Handler)
        self._thread = threading.Thread(target=self.server.serve_forever,
                                        daemon=True)
        self._thread.start()
        self._ticker = threading.Thread(target=self._tick, daemon=True)
        self._ticker.start()

    # -- surface -----------------------------------------------------------

    @property
    def addr(self) -> str:
        return f"127.0.0.1:{self.server.server_port}"

    def calls_of(self, call_type: str) -> List[dict]:
        return [c for c in self.calls if c.get("type") == call_type]

    def running_times(self) -> List[float]:
        """Seconds from SUBSCRIBE to each task's TASK_RUNNING."""
        with self._lock:
            return sorted(t.running_at - self.subscribed_at
                          for t in self.tasks.values()
                          if t.running_at is not None
                          and self.subscribed_at is not None)

    def sandbox_output(self, task_id: str) -> str:
        t = self.tasks[task_id]
        out = []
        for name in ("stdout", "stderr"):
            try:
                with open(os.path.join(t.sandbox, name), "rb") as f:
                    out.append(f.read().decode(errors="replace"))
            except OSError:
                pass
        return "".join(out)

    def close(self) -> None:
        self._closing = True
        self._kill_all(signal.SIGKILL)
        for t in list(self.tasks.values()):
            try:
                t.proc.wait(timeout=10.0)
            except subprocess.TimeoutExpired:
                pass
        self.server.shutdown()
        self.server.server_close()
        shutil.rmtree(self.work_dir, ignore_errors=True)

    # -- the stream ----------------------------------------------------------

    def _push(self, event: dict) -> None:
        self.log.append((time.monotonic(), event.get("type")))
        self._events.put(event)

    def _serve_stream(self, handler, body: dict) -> None:
        self.subscribes.append(body)
        with self._lock:
            self.subscribed_at = time.monotonic()
            self._stream_open = True
            self._outstanding = None
        handler.send_response(200)
        handler.send_header("Mesos-Stream-Id", "stream-1")
        handler.send_header("Transfer-Encoding", "chunked")
        handler.end_headers()
        handler.chunk(record({"type": "SUBSCRIBED", "subscribed": {
            "framework_id": {"value": "FW-1"},
            "heartbeat_interval_seconds": self.heartbeat_s,
            "master_info": {"version": self.version}}}))
        self._maybe_offer()
        while not self._closing:
            try:
                event = self._events.get(timeout=0.1)
            except queue.Empty:
                continue
            try:
                handler.chunk(record(event))
            except OSError:
                break
            if event.get("type") == "_END":
                break
        with self._lock:
            self._stream_open = False

    def _tick(self) -> None:
        last_beat = time.monotonic()
        while not self._closing:
            time.sleep(0.1)
            now = time.monotonic()
            if self._stream_open and now - last_beat >= self.heartbeat_s:
                last_beat = now
                self._push({"type": "HEARTBEAT"})
            if self._refuse_until and now >= self._refuse_until:
                self._refuse_until = 0.0
                self._maybe_offer()

    def _maybe_offer(self) -> None:
        with self._lock:
            if (not self._stream_open or self._closing or self._suppressed
                    or self._outstanding is not None
                    or (self._refuse_until
                        and time.monotonic() < self._refuse_until)):
                return
            if self.free["cpus"] <= 0.0 or self.free["mem"] <= 0.0:
                return
            oid = f"offer-{uuid.uuid4().hex[:8]}"
            self._outstanding = oid
            resources = [{"name": name, "type": "SCALAR",
                          "scalar": {"value": self.free[name]}}
                         for name in ("cpus", "mem", "gpus")
                         if self.free[name] > 0.0]
        self._push({"type": "OFFERS", "offers": {"offers": [{
            "id": {"value": oid}, "agent_id": {"value": self.agent_id},
            "hostname": self.hostname, "resources": resources}]}})

    # -- calls ---------------------------------------------------------------

    def _on_call(self, body: dict) -> None:
        self.calls.append(body)
        self.log.append((time.monotonic(), body.get("type")))
        kind = body.get("type")
        if kind == "ACCEPT":
            acc = body["accept"]
            with self._lock:
                if self._outstanding in [o["value"]
                                         for o in acc["offer_ids"]]:
                    self._outstanding = None
            for op in acc.get("operations", []):
                if op.get("type") == "LAUNCH":
                    for info in op["launch"]["task_infos"]:
                        self._launch(info)
            self._maybe_offer()
        elif kind == "DECLINE":
            dec = body["decline"]
            refuse = float(dec.get("filters", {}).get("refuse_seconds", 5.0))
            with self._lock:
                if self._outstanding in [o["value"]
                                         for o in dec["offer_ids"]]:
                    self._outstanding = None
                # Mesos caps nothing here; a FOREVER filter lasts until
                # a REVIVE clears it.
                self._refuse_until = time.monotonic() + min(refuse, 1e9)
        elif kind == "REVIVE":
            with self._lock:
                self._suppressed = False
                self._refuse_until = 0.0
            self._maybe_offer()
        elif kind == "SUPPRESS":
            with self._lock:
                self._suppressed = True
        elif kind == "KILL":
            tid = body["kill"]["task_id"]["value"]
            t = self.tasks.get(tid)
            if t is not None and t.proc.poll() is None:
                t.killed = True
                self._signal(t, signal.SIGTERM)
                threading.Thread(target=self._reap_late, args=(t,),
                                 daemon=True).start()
            elif t is None:
                self._update(tid, "TASK_LOST", "unknown task")
        elif kind == "TEARDOWN":
            self._kill_all(signal.SIGTERM)
            self._push({"type": "_END"})

    def _launch(self, info: dict) -> None:
        tid = info["task_id"]["value"]
        want = _scalars(info.get("resources"))
        with self._lock:
            short = [k for k, v in want.items()
                     if v > self.free.get(k, 0.0) + 1e-9]
            if short:
                self._update(tid, "TASK_ERROR",
                             f"insufficient resources: {short}")
                return
            for k, v in want.items():
                self.free[k] -= v
        sandbox = os.path.join(self.work_dir, tid)
        os.makedirs(sandbox, exist_ok=True)
        env = dict(os.environ)
        env.update(self.env)
        env.update(MESOS_SANDBOX=sandbox, MESOS_TASK_ID=tid,
                   MESOS_AGENT_ID=self.agent_id)
        cmd = info["command"]
        for var in cmd.get("environment", {}).get("variables", []):
            if var.get("type") == "SECRET":
                env[var["name"]] = base64.b64decode(
                    var["secret"]["value"]["data"]).decode()
            else:
                env[var["name"]] = var["value"]
        with open(os.path.join(sandbox, "stdout"), "wb") as out, \
                open(os.path.join(sandbox, "stderr"), "wb") as err:
            proc = subprocess.Popen(
                cmd["value"] if cmd.get("shell", True)
                else [cmd["value"]] + list(cmd.get("arguments", [])[1:]),
                shell=bool(cmd.get("shell", True)), cwd=sandbox, env=env,
                stdout=out, stderr=err, stdin=subprocess.DEVNULL,
                start_new_session=True)
        task = _Task(info, proc, sandbox, want)
        with self._lock:
            self.tasks[tid] = task
            task.running_at = time.monotonic()
            task.state = "TASK_RUNNING"
        self._update(tid, "TASK_RUNNING")
        threading.Thread(target=self._watch, args=(task,),
                         daemon=True).start()

    def _watch(self, task: _Task) -> None:
        rc = task.proc.wait()
        with self._lock:
            task.exit_code = rc
            for k, v in task.used.items():
                self.free[k] += v
            if task.killed:
                state = "TASK_KILLED"
            else:
                state = "TASK_FINISHED" if rc == 0 else "TASK_FAILED"
            task.state = state
        self._update(task.id, state, f"exit code {rc}")
        self._maybe_offer()

    def _update(self, tid: str, state: str, message: str = "") -> None:
        self._push({"type": "UPDATE", "update": {"status": {
            "task_id": {"value": tid}, "state": state,
            "agent_id": {"value": self.agent_id}, "message": message,
            "uuid": base64.b64encode(uuid.uuid4().bytes).decode()}}})

    @staticmethod
    def _signal(task: _Task, sig: int) -> None:
        try:
            os.killpg(task.proc.pid, sig)
        except (ProcessLookupError, PermissionError):
            pass

    def _reap_late(self, task: _Task) -> None:
        try:
            task.proc.wait(timeout=10.0)
        except subprocess.TimeoutExpired:
            self._signal(task, signal.SIGKILL)

    def _kill_all(self, sig: int) -> None:
        for t in list(self.tasks.values()):
            if t.proc.poll() is None:
                t.killed = True
                self._signal(t, sig)


class FakeZK:
    """A one-thread ZooKeeper stand-in whose ``<path>`` holds one Mesos
    master znode (``json.info_0000000001``) naming ``master_addr``."""

    def __init__(self, master_addr: str):
        ip, _, port = master_addr.rpartition(":")
        self.znodes = {"json.info_0000000001": json.dumps(
            {"address": {"ip": ip, "port": int(port)},
             "hostname": ip}).encode()}
        self.requests: List[tuple] = []
        self.server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.server.bind(("127.0.0.1", 0))
        self.server.listen(8)
        self.port = self.server.getsockname()[1]
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def url(self, path: str = "/mesos") -> str:
        return f"zk://127.0.0.1:{self.port}{path}"

    @staticmethod
    def _read_frame(conn) -> Optional[bytes]:
        hdr = b""
        while len(hdr) < 4:
            chunk = conn.recv(4 - len(hdr))
            if not chunk:
                return None
            hdr += chunk
        (n,) = struct.unpack(">i", hdr)
        data = b""
        while len(data) < n:
            chunk = conn.recv(n - len(data))
            if not chunk:
                return None
            data += chunk
        return data

    @staticmethod
    def _send_frame(conn, payload: bytes) -> None:
        conn.sendall(struct.pack(">i", len(payload)) + payload)

    def _serve(self) -> None:
        while True:
            try:
                conn, _ = self.server.accept()
            except OSError:
                return
            with conn:
                if self._read_frame(conn) is None:      # ConnectRequest
                    continue
                self._send_frame(conn, struct.pack(">iiq", 0, 10000, 1)
                                 + struct.pack(">i", 16) + b"\x00" * 17)
                while True:
                    frame = self._read_frame(conn)
                    if frame is None:
                        break
                    xid, op = struct.unpack(">ii", frame[:8])
                    (plen,) = struct.unpack(">i", frame[8:12])
                    path = frame[12:12 + plen].decode()
                    self.requests.append((op, path))
                    header = struct.pack(">iqi", xid, 1, 0)
                    if op == 8:                         # getChildren
                        names = sorted(self.znodes)
                        body = struct.pack(">i", len(names))
                        for n in names:
                            body += struct.pack(">i", len(n)) + n.encode()
                        self._send_frame(conn, header + body)
                    elif op == 4:                       # getData
                        data = self.znodes.get(path.rsplit("/", 1)[1])
                        if data is None:
                            self._send_frame(conn, struct.pack(
                                ">iqi", xid, 1, -101))
                        else:
                            self._send_frame(conn, header + struct.pack(
                                ">i", len(data)) + data)
                    else:
                        self._send_frame(conn, header)

    def close(self) -> None:
        self.server.close()
