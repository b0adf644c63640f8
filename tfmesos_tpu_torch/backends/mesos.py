"""Mesos backend: the v1 HTTP scheduler API, spoken directly (port of
``tfmesos_tpu/backends/mesos.py``).

The protocol is implemented on the stdlib — a long-lived SUBSCRIBE
stream of RecordIO-framed JSON events plus one-shot POST calls — so the
backend needs no Mesos client library.  Protocol shape:

* ``POST /api/v1/scheduler`` with a SUBSCRIBE call opens a chunked response
  carrying ``<length>\\n<json>`` records (SUBSCRIBED, OFFERS, UPDATE,
  FAILURE, ERROR, HEARTBEAT ...) and a ``Mesos-Stream-Id`` header.
* Every subsequent call (ACCEPT/DECLINE/ACKNOWLEDGE/REVIVE/SUPPRESS/KILL/
  TEARDOWN) is a separate POST carrying the framework id and stream id.

Resource mapping: an offer's scalar ``tpus`` or ``gpus`` is read into
the chips dimension (on GPU agents, cards), and the TaskInfo asks for
chips under the name the agent advertised, including the Mesos
SET-type form (scheduler.py:244-250).

The reference's semantics are preserved: explicit status acknowledgements,
revive/suppress passthrough, decline with configurable refuse_seconds
(FOREVER once placed), teardown on stop (scheduler.py:459-472).
"""

from __future__ import annotations

import getpass
import http.client
import json
import socket
import threading
import time
import urllib.parse
from typing import Any, Dict, List, Optional, Sequence

from tfmesos_tpu_torch.backends import ResourceBackend
from tfmesos_tpu_torch.spec import Offer, TaskStatus
from tfmesos_tpu_torch.utils.logging import get_logger

API_PATH = "/api/v1/scheduler"


class RecordIOParser:
    """Incremental ``<length>\\n<bytes>`` record parser."""

    def __init__(self) -> None:
        self._buf = bytearray()

    def feed(self, data: bytes) -> List[bytes]:
        self._buf.extend(data)
        out = []
        while True:
            nl = self._buf.find(b"\n")
            if nl < 0:
                break
            try:
                length = int(bytes(self._buf[:nl]))
            except ValueError:
                raise IOError(f"bad RecordIO length {bytes(self._buf[:nl])!r}")
            end = nl + 1 + length
            if len(self._buf) < end:
                break
            out.append(bytes(self._buf[nl + 1:end]))
            del self._buf[:end]
        return out


def parse_master(master: str) -> tuple:
    """Accept ``host:port``, ``http://host:port``, or ``zk://.../mesos``
    (resolved to the leading master through the minimal ZooKeeper client in
    backends/zk.py — the reference gets the same capability transitively via
    pymesos, SURVEY §1)."""
    if master.startswith("zk://"):
        from tfmesos_tpu_torch.backends.zk import resolve_master
        master = resolve_master(master)
    if "//" in master:
        parsed = urllib.parse.urlparse(master)
        return parsed.hostname, parsed.port or 5050
    host, _, port = master.partition(":")
    return host, int(port or 5050)


def parse_offer(raw: dict) -> Offer:
    """Read cpus/mem plus accelerator chips.

    Chips come from the ``tpus`` custom scalar resource, or — so a plain GPU
    cluster still schedules — from a SCALAR ``gpus`` resource; either way the
    offer records WHICH name supplied them (``chips_resource``) and the
    TaskInfo requests chips under that same name, so launch cannot ask for a
    resource the agent never advertised.  SET-type ``gpus`` (the reference's
    nvidia-docker-v1 uuid lists, scheduler.py:244-250) have no valid scalar
    request shape and no TPU analogue: they are ignored, not matched.
    """
    cpus = mem = 0.0
    tpus = gpus = 0
    for res in raw.get("resources", []):
        name, rtype = res.get("name"), res.get("type")
        if name == "cpus" and rtype == "SCALAR":
            cpus = float(res["scalar"]["value"])
        elif name == "mem" and rtype == "SCALAR":
            mem = float(res["scalar"]["value"])
        elif name == "tpus" and rtype == "SCALAR":
            tpus += int(float(res["scalar"]["value"]))
        elif name == "gpus" and rtype == "SCALAR":
            gpus += int(float(res["scalar"]["value"]))
    attributes = {}
    for attr in raw.get("attributes", []):
        if attr.get("type") == "TEXT":
            attributes[attr["name"]] = attr["text"]["value"]
        elif attr.get("type") == "SCALAR":
            attributes[attr["name"]] = str(attr["scalar"]["value"])
    chips, chips_resource = (tpus, "tpus") if tpus or not gpus else (gpus,
                                                                     "gpus")
    return Offer(id=raw["id"]["value"], agent_id=raw["agent_id"]["value"],
                 hostname=raw.get("hostname", ""), cpus=cpus, mem=mem,
                 chips=chips, chips_resource=chips_resource,
                 attributes=attributes, raw=raw)


class MesosBackend(ResourceBackend):
    def __init__(self, master: str, framework_name: str = "tpumesos",
                 role: str = "*", user: Optional[str] = None,
                 failover_timeout: float = 3600.0,
                 reconnect_wait: float = 2.0):
        self.host, self.port = parse_master(master)
        self.framework_name = framework_name
        self.role = role
        self.user = user if user is not None else getpass.getuser()
        self.failover_timeout = failover_timeout
        self.reconnect_wait = reconnect_wait
        self.log = get_logger("tfmesos_tpu_torch.mesos")

        self._scheduler = None
        self.framework_id: Optional[str] = None
        self.stream_id: Optional[str] = None
        self._shutdown = threading.Event()
        self._subscribed = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._conn: Optional[http.client.HTTPConnection] = None

    # -- subscribe stream --------------------------------------------------

    def start(self, scheduler) -> None:
        self._scheduler = scheduler
        self._thread = threading.Thread(target=self._subscribe_loop,
                                        name="mesos-subscribe", daemon=True)
        self._thread.start()
        if not self._subscribed.wait(timeout=60.0):
            self.stop()     # stop the reconnect loop behind the raise
            raise RuntimeError(
                f"could not subscribe to Mesos master at "
                f"{self.host}:{self.port} within 60s")

    def _subscribe_loop(self) -> None:
        while not self._shutdown.is_set():
            try:
                self._run_stream()
            except Exception as e:
                if self._shutdown.is_set():
                    return
                self.log.warning("subscribe stream broke: %s; reconnecting "
                                 "in %.1fs", e, self.reconnect_wait)
                time.sleep(self.reconnect_wait)

    def _run_stream(self) -> None:
        try:
            self._stream_once()
        finally:
            # We are the reader thread, so closing here cannot deadlock on
            # the response buffer lock (unlike closing from stop()).
            if self._conn is not None:
                try:
                    self._conn.close()
                except Exception:
                    pass
                self._conn = None

    def _subscribe_body(self) -> Dict[str, Any]:
        """The v1 SUBSCRIBE call payload (golden-tested against the API
        shape in tests/test_mesos_golden.py)."""
        body: Dict[str, Any] = {
            "type": "SUBSCRIBE",
            "subscribe": {
                "framework_info": {
                    "user": self.user,
                    "name": self.framework_name,
                    "roles": [self.role],
                    "failover_timeout": self.failover_timeout,
                    "capabilities": [{"type": "MULTI_ROLE"}],
                },
            },
        }
        if self.framework_id:  # failover re-subscription keeps our tasks
            body["framework_id"] = {"value": self.framework_id}
            body["subscribe"]["framework_info"]["id"] = {
                "value": self.framework_id}
        return body

    def _accept_body(self, offer: Offer,
                     task_infos: Sequence[dict]) -> Dict[str, Any]:
        """The v1 ACCEPT call payload (golden-tested)."""
        return {
            "type": "ACCEPT",
            "accept": {
                "offer_ids": [{"value": offer.id}],
                "operations": [{
                    "type": "LAUNCH",
                    "launch": {"task_infos": list(task_infos)},
                }],
                "filters": {"refuse_seconds": 5.0},
            },
        }

    def _stream_once(self) -> None:
        body = self._subscribe_body()
        conn = http.client.HTTPConnection(self.host, self.port, timeout=60)
        self._conn = conn
        conn.request("POST", API_PATH, body=json.dumps(body),
                     headers={"Content-Type": "application/json",
                              "Accept": "application/json"})
        resp = conn.getresponse()
        if resp.status in (302, 307):  # not the leading master
            location = resp.getheader("Location", "")
            host, port = self._parse_redirect(location)
            if host:
                # Follow the leader: update our target and let the
                # reconnect loop re-subscribe there (reference parity: a
                # zk:// framework always lands on the leader).
                self.log.info("master redirected to %s:%d; following",
                              host, port)
                self.host, self.port = host, port
            raise IOError(f"master redirected to {location}")
        if resp.status != 200:
            raise IOError(f"SUBSCRIBE failed: HTTP {resp.status} "
                          f"{resp.read(200)!r}")
        self.stream_id = resp.getheader("Mesos-Stream-Id")
        parser = RecordIOParser()
        while not self._shutdown.is_set():
            chunk = resp.read1(65536)
            if not chunk:
                raise IOError("subscribe stream EOF")
            for record in parser.feed(chunk):
                self._dispatch(json.loads(record))

    @staticmethod
    def _parse_redirect(location: str):
        """``//host:port[/path]`` or a full URL -> (host, port)."""
        if not location:
            return None, None
        parsed = urllib.parse.urlparse(
            location if "//" in location else f"//{location}")
        return parsed.hostname, parsed.port or 5050

    def _master_version(self, sub: Dict[str, Any]) -> Optional[str]:
        """Master version from SUBSCRIBED metadata, else the /version
        endpoint (reference probes the version at registration to pick a
        containerizer, scheduler.py:378-382)."""
        version = sub.get("master_info", {}).get("version")
        if version:
            return version
        try:
            conn = http.client.HTTPConnection(self.host, self.port,
                                              timeout=10)
            try:
                conn.request("GET", "/version")
                resp = conn.getresponse()
                if resp.status == 200:
                    return json.loads(resp.read(4096)).get("version")
            finally:
                conn.close()
        except Exception as e:  # pure metadata; never fail bring-up on it
            self.log.debug("/version probe failed: %s", e)
        return None

    def _dispatch(self, event: Dict[str, Any]) -> None:
        etype = event.get("type")
        if etype == "SUBSCRIBED":
            sub = event["subscribed"]
            self.framework_id = sub["framework_id"]["value"]
            self.log.info("subscribed: framework %s", self.framework_id)
            self._subscribed.set()
            self._scheduler.on_registered(
                {"backend": "mesos", "framework_id": self.framework_id,
                 "master": f"{self.host}:{self.port}",
                 "master_version": self._master_version(sub)})
        elif etype == "OFFERS":
            offers = [parse_offer(o)
                      for o in event["offers"].get("offers", [])]
            if offers:
                self._scheduler.on_offers(offers)
        elif etype == "UPDATE":
            status = event["update"]["status"]
            self._scheduler.on_status(TaskStatus(
                task_id=status["task_id"]["value"],
                state=status["state"],
                message=status.get("message", ""),
                agent_id=status.get("agent_id", {}).get("value", ""),
                uuid=status.get("uuid", ""),
            ))
        elif etype == "FAILURE":
            failure = event.get("failure", {})
            agent = failure.get("agent_id", {}).get("value")
            if agent and not failure.get("executor_id"):
                self._scheduler.on_agent_lost(agent)
        elif etype == "ERROR":
            self._scheduler.on_error(event.get("error", {}).get("message",
                                                                "unknown"))
        elif etype == "RESCIND":
            # An outstanding offer was withdrawn.  If tasks were placed on
            # it and their launch never confirmed, the scheduler synthesizes
            # terminal statuses so the two-phase policy revives them instead
            # of idling until start_timeout (the reference ignored rescinds,
            # scheduler.py: no offerRescinded handler — a stale-offer launch
            # on a busy cluster would hang its bring-up).
            offer_id = event.get("rescind", {}).get("offer_id", {}).get(
                "value")
            if offer_id:
                self._scheduler.on_rescind(offer_id)
        elif etype == "HEARTBEAT":
            # Liveness backstop: a failed/rejected REVIVE while the stream
            # stays healthy would otherwise leave the offer tap closed.
            self._scheduler.on_heartbeat()
        else:
            self.log.debug("ignoring event %s", etype)

    # -- calls -------------------------------------------------------------

    def _with_envelope(self, body: Dict[str, Any]) -> Dict[str, Any]:
        """The call envelope every non-SUBSCRIBE POST carries (golden-
        tested: the goldens freeze exactly what goes on the wire)."""
        body = dict(body)
        if self.framework_id:
            body["framework_id"] = {"value": self.framework_id}
        return body

    def _call(self, body: Dict[str, Any]) -> int:
        """POST one scheduler call; returns the HTTP status (2xx = the
        master took it)."""
        body = self._with_envelope(body)
        headers = {"Content-Type": "application/json"}
        if self.stream_id:
            headers["Mesos-Stream-Id"] = self.stream_id
        conn = http.client.HTTPConnection(self.host, self.port, timeout=30)
        try:
            conn.request("POST", API_PATH, body=json.dumps(body),
                         headers=headers)
            resp = conn.getresponse()
            data = resp.read(4096)
            if resp.status not in (200, 202):
                self.log.warning("call %s failed: HTTP %d %r",
                                 body.get("type"), resp.status, data[:200])
            return resp.status
        finally:
            conn.close()

    def launch(self, offer: Offer, task_infos: Sequence[dict]) -> None:
        # A rejected or unreachable ACCEPT must not leave the placed tasks
        # in offered=True limbo (they would idle until start_timeout):
        # synthesize a terminal status per task so on_status routes them
        # through the normal two-phase revive/abort policy.
        task_ids = [info["task_id"]["value"] for info in task_infos]
        try:
            status = self._call(self._accept_body(offer, task_infos))
        except Exception as e:
            self._drop_launch(task_ids, f"ACCEPT failed: {e}")
            return
        if status not in (200, 202):
            self._drop_launch(task_ids, f"ACCEPT rejected: HTTP {status}")

    def _drop_launch(self, task_ids: List[str], why: str) -> None:
        self.log.warning("launch of %d task(s) failed (%s); reporting "
                         "TASK_DROPPED", len(task_ids), why)
        for tid in task_ids:
            # The failure may be AMBIGUOUS (e.g. the ACCEPT was delivered
            # but its response timed out): the task might actually be
            # launching.  Kill the soon-to-be-stale id first — a no-op if
            # it never ran, and it stops a zombie from holding resources
            # if it did.  Guarded separately: a failed kill must not skip
            # the drop, and neither may strand the remaining tasks.
            try:
                self.kill(tid)
            except Exception as e:
                self.log.warning("kill of %s failed: %s", tid[:8], e)
            try:
                self._scheduler.on_status(TaskStatus(tid, "TASK_DROPPED",
                                                     message=why))
            except Exception as e:
                # on_status's follow-up REVIVE can hit the same unreachable
                # master; EVERY task must still get its drop (or the rest
                # stay in the offered=True limbo this path exists to clear).
                self.log.warning("drop of %s partially failed: %s",
                                 tid[:8], e)

    def decline(self, offer: Offer, refuse_seconds: float = 5.0) -> None:
        self._call({
            "type": "DECLINE",
            "decline": {"offer_ids": [{"value": offer.id}],
                        "filters": {"refuse_seconds": float(refuse_seconds)}},
        })

    def suppress(self) -> None:
        self._call({"type": "SUPPRESS"})

    def revive(self) -> None:
        # Raise on rejection: REVIVE is the liveness backstop's lever, and
        # the scheduler's heartbeat gating only retries failures it can
        # SEE (a silently-dropped 500 would close the offer tap for good).
        status = self._call({"type": "REVIVE"})
        if status not in (200, 202):
            raise RuntimeError(f"REVIVE rejected: HTTP {status}")

    def kill(self, task_id: str) -> None:
        self._call({"type": "KILL", "kill": {"task_id": {"value": task_id}}})

    def acknowledge(self, status: TaskStatus) -> None:
        # Explicit acks are required on the v1 API whenever a status carries
        # a uuid (the analogue of pymesos' implicit acks the reference used).
        if not status.uuid or not status.agent_id:
            return
        self._call({
            "type": "ACKNOWLEDGE",
            "acknowledge": {
                "agent_id": {"value": status.agent_id},
                "task_id": {"value": status.task_id},
                "uuid": status.uuid,
            },
        })

    def stop(self) -> None:
        self._shutdown.set()
        if self.framework_id:
            try:
                self._call({"type": "TEARDOWN"})
            except Exception as e:  # master may already be gone
                self.log.warning("teardown failed: %s", e)
        if self._conn is not None:
            # Wake the reader thread blocked in recv: a raw shutdown() on the
            # socket interrupts it immediately, whereas HTTPConnection.close()
            # would deadlock on the response buffer lock the reader holds
            # (until the socket timeout fires, 60s later).
            sock = getattr(self._conn, "sock", None)
            if sock is not None:
                try:
                    sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        if self._conn is not None:
            try:
                self._conn.close()
            except Exception:
                pass
