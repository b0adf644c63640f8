"""The port's offline lane: ``FleetServer(batch_lane=True)`` (``tfserve
--batch-lane``) and ``tfserve batch``.

- The lane's class list equals the JAX ``FleetServer``'s for the same
  ``priority_classes``.
- ``tfserve batch`` against a CPU fleet prints one JSON line a prompt
  whose tokens are the JAX batcher's greedy streams on the same weights.
- A resident batch row yields its decode slot to an interactive arrival
  (one row: the replica preempts it, the interactive request finishes
  first, and the batch row resumes to the same greedy stream).

The fleet cases run behind the in-process gateway and behind two gateway
processes, which carry the fleet's class table (``--classes-json``)."""

import json
import threading
import time

import numpy as np
import pytest

from torch_parity import jax_compile_cache_off  # noqa: F401

NEW = 6


def _spec(mod, spec):
    if spec is None:
        return None
    return [mod.PriorityClass(n, weight=w, rank=r, batch=b)
            for n, w, r, b in spec]


@pytest.mark.parametrize("spec", [
    None,
    [("interactive", 1.0, 0, False)],
    [("gold", 4.0, 2, False), ("silver", 1.0, 1, False)],
    [("gold", 4.0, 2, False), ("bronze", 1.0, -3, False)],
    [("a", 1.0, 0, False), ("batch", 2.0, -1, True)],
], ids=["default", "interactive", "gold-silver", "negative-floor",
        "own-batch"])
def test_batch_lane_classes_equal_jax(spec):
    from tfmesos_tpu.fleet import admission as jax_admission
    from tfmesos_tpu.fleet.launcher import FleetServer as JaxFleet
    from tfmesos_tpu_torch.fleet import admission
    from tfmesos_tpu_torch.fleet.launcher import FleetServer

    def classes(Fleet, mod, lane):
        f = Fleet(replicas=1, batch_lane=lane,
                  priority_classes=_spec(mod, spec))
        return [repr(c) for c in f.priority_classes or ()]

    for lane in (False, True):
        assert classes(FleetServer, admission, lane) \
            == classes(JaxFleet, jax_admission, lane)
    mine = classes(FleetServer, admission, True)
    assert sum("name='batch'" in c for c in mine) == 1
    assert "batch=True" in [c for c in mine if "name='batch'" in c][0]


def _prompts(n=4, seed=21):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 97, rng.randint(3, 12)).tolist()
            for _ in range(n)]


def _jax_streams(prompts, new):
    """The JAX batcher's greedy streams on the port preset's weights."""
    from tfmesos_tpu import serving as js
    from tfmesos_tpu.fleet.replica import tiny_model as jax_tiny_model
    from tfmesos_tpu_torch import convert
    from tfmesos_tpu_torch.models import presets

    jcfg, _ = jax_tiny_model(seed=0)
    params = convert.params_to_numpy(presets.tiny_model(0)[1])
    b = js.ContinuousBatcher(jcfg, params, rows=2, max_len=64, page_size=16,
                             prefill_bucket=16)
    done = {c.rid: list(c.tokens) for c in b.run(
        [js.Request(prompt=np.asarray(p, np.int32), max_new_tokens=n)
         for p, n in zip(prompts, new)])}
    return [done[r] for r in sorted(done)]


@pytest.fixture(scope="module", params=[0, 2],
                ids=["in-process", "gateway-processes"])
def fleet(request):
    from tfmesos_tpu_torch.fleet.launcher import FleetServer

    f = FleetServer(replicas=1, tiny=True, max_len=64, page_size=16,
                    prefill_bucket=16, rows=1, device="cpu", batch_lane=True,
                    gateway_processes=request.param,
                    request_timeout=120.0, start_timeout=120.0,
                    heartbeat_interval=0.1).start()
    try:
        yield f
    finally:
        f.stop()


def test_tfserve_batch_prints_the_greedy_streams(fleet, capsys,
                                                 monkeypatch):
    from tfmesos_tpu_torch import cli

    prompts = _prompts()
    want = _jax_streams(prompts, [NEW] * len(prompts))
    monkeypatch.setenv("TPUMESOS_TOKEN", fleet.token)
    monkeypatch.delenv("TPUMESOS_TOKEN_FILE", raising=False)
    argv = ["batch", "-g", fleet.addrs[0], "-n", str(NEW), "--concurrency",
            "2"]
    for p in prompts:
        argv += ["--prompt", ",".join(map(str, p))]
    assert cli.main(argv) == 0
    rows = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert sorted(r["index"] for r in rows) == list(range(len(prompts)))
    assert [r["tokens"] for r in sorted(rows, key=lambda r: r["index"])] \
        == want
    counters = fleet.fleet_snapshot()["counters"]
    assert counters["completed"] >= len(prompts)


def _replica_counters(fleet):
    from tfmesos_tpu_torch.fleet.client import MuxConnection

    (rep,) = fleet.registry.alive()
    conn = MuxConnection(rep.addr, fleet.token)
    try:
        return conn.call({"op": "stats"}, timeout=60.0)["counters"]
    finally:
        conn.close()


def test_batch_row_yields_to_an_interactive_arrival(fleet):
    long_p, short_p = [5, 9, 2, 7], [3, 3, 8]
    want = _jax_streams([long_p, short_p], [40, 4])
    before = _replica_counters(fleet)
    client = fleet.client(timeout=120.0)
    out, order, streamed = {}, [], []
    try:
        def batch():
            out["batch"] = client.generate(long_p, 40, priority="batch",
                                           on_tokens=streamed.extend)
            order.append("batch")

        t = threading.Thread(target=batch)
        t.start()
        deadline = time.monotonic() + 60.0
        while len(streamed) < 2 and time.monotonic() < deadline:
            time.sleep(0.01)            # the batch row is resident now
        assert len(streamed) >= 2
        out["interactive"] = client.generate(short_p, 4)
        order.append("interactive")
        t.join(timeout=120.0)
    finally:
        client.close()
    after = _replica_counters(fleet)
    assert order == ["interactive", "batch"]
    assert after["preemptions"] - before["preemptions"] >= 1
    assert after["resumes"] - before["resumes"] >= 1
    assert out["interactive"]["tokens"] == want[1]
    assert out["batch"]["tokens"] == want[0] == streamed
