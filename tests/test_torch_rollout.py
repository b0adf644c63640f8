"""Blue-green rollouts in the port against the JAX package.

* The router's weights_version preference with the old version kept as
  fallback, and the gateway's ``rollout`` op over a stub control plane:
  the same calls through both packages' control planes give the same
  picks, replies and counters.
* ``bump_generation``: both schedulers stamp launches after a bump with
  the new generation, and the task sees it as ``TPUMESOS_GENERATION``.
* ``FleetServer``'s validation of the autoscale, catalog and version
  options: the same arguments give the same error message, or the same
  bounds, budget and targets.
* One tiny CPU fleet of real processes: a rollout whose new tier never
  leaves warming aborts with the old version serving, then
  ``FleetClient.rollout`` with requests in flight replaces the tier with
  no failed request, the in-process batcher's tokens throughout, and
  the registry fenced against the old generation.
"""

import threading
import time

import numpy as np
import pytest

from test_torch_front_door import Env, _wait, control_plane, failed

from tfmesos_tpu_torch import wire


# -- version preference and the rollout op ----------------------------------


def case_version_preference(env):
    env.feeder("v:1", weights_version="v1")
    env.feeder("v:2", weights_version="v2")
    assert _wait(lambda: len(env.reg.alive()) == 2)
    router = env.router()
    blind = sorted({router.pick(exclude=(a,)) for a in ("v:1", "v:2")})
    assert blind == ["v:1", "v:2"]
    router.set_preferred_version("v2")      # the shift
    shifted = [router.pick() for _ in range(8)]
    assert shifted == ["v:2"] * 8
    env.reg.mark_dead("v:2")                # the new tier gone: fallback
    assert _wait(lambda: router.pick() == "v:1")
    fallback = router.pick()
    assert env.metrics.get("version_fallbacks") >= 1
    router.set_preferred_version(None)
    return {"blind": blind, "shifted": shifted, "fallback": fallback,
            "counters": {k: min(v, 1) for k, v in env.counters().items()}}


def case_rollout_op(env):
    gw = env.gateway(env.router(), max_queue=4, workers=1)
    client = env.client(gw, timeout=10.0)
    out = [failed(lambda: client.rollout("v2", timeout=5.0))]
    calls = []
    gw.rollout_fn = lambda v: (calls.append(v), {"reaped": 3})[1]
    ok = client.rollout("v2", timeout=5.0)
    out.append({k: v for k, v in ok.items() if k != "id"})
    out.append(failed(lambda: client.rollout("", timeout=5.0)))

    def boom(v):
        raise RuntimeError("new tier never left warming")

    gw.rollout_fn = boom
    out.append(failed(lambda: client.rollout("v3", timeout=5.0)))
    # The op runs off the event loop: a slow rollout does not stall the
    # gateway's other ops.
    release = threading.Event()
    gw.rollout_fn = lambda v: (release.wait(10.0), {"reaped": 0})[1]
    slow = []
    t = threading.Thread(target=lambda: slow.append(
        client.rollout("v4", timeout=10.0)))
    t.start()
    time.sleep(0.1)
    t0 = time.monotonic()
    assert client.gateways(timeout=5.0) == [gw.addr]
    quick = time.monotonic() - t0 < 2.0
    release.set()
    t.join(timeout=10.0)
    assert quick and slow and slow[0]["ok"]
    assert [o.get("kind") for o in out if isinstance(o, dict)
            and "raised" in o] == ["bad_request", "bad_request",
                                   "rollout_failed"]
    assert out[1]["ok"] and out[1]["reaped"] == 3 and calls == ["v2"]
    return {"out": out, "calls": calls, "quick": quick}


CASES = [case_version_preference, case_rollout_op]


def run_case(case, side):
    env = Env(control_plane(side))
    try:
        return case(env)
    finally:
        env.close()


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__[5:])
def test_port_rollout_control_plane_equals_jax(case):
    assert run_case(case, "port") == run_case(case, "jax")


def test_bump_generation_stamps_later_launches(tmp_path):
    """Both schedulers: tasks added after ``bump_generation`` carry the
    new generation and see it as ``TPUMESOS_GENERATION``."""
    from tfmesos_tpu.backends.local import LocalBackend as JaxBackend
    from tfmesos_tpu.scheduler import TPUMesosScheduler as JaxScheduler
    from tfmesos_tpu_torch.scheduler import TPUMesosScheduler

    def run(make, side):
        sched = make()
        sched.start()
        try:
            marks, out = [], []
            for n in range(2):
                mark = tmp_path / f"{side}{n}"
                task = sched.add_task(
                    "svc", cmd=f"echo $TPUMESOS_GENERATION > {mark}; "
                               f"exec sleep 60")
                marks.append(mark)
                out.append(task.generation)
                if n == 0:
                    out.append(sched.bump_generation())
            assert _wait(lambda: all(m.exists() and m.read_text().strip()
                                     for m in marks), timeout=60.0)
            out += [m.read_text().strip() for m in marks]
            out.append(sched.generation)
            return out
        finally:
            sched.stop()

    mine = run(lambda: TPUMesosScheduler([], dynamic=True, quiet=True,
                                         start_timeout=60.0), "port")
    assert mine == [0, 1, 1, "0", "1", 1]
    assert mine == run(lambda: JaxScheduler([], dynamic=True,
                                            backend=JaxBackend(),
                                            start_timeout=60.0), "jax")


# -- FleetServer validation --------------------------------------------------


def _specs(side, *entries):
    if side == "jax":
        from tfmesos_tpu.fleet.catalog import ModelSpec
    else:
        from tfmesos_tpu_torch.fleet.catalog import ModelSpec
    return [ModelSpec(*e) for e in entries]


FLEETS = [
    dict(replicas=-1), dict(replicas=1, prefill_replicas=1),
    dict(replicas=0, decode_replicas=2), dict(replicas=0),
    dict(replicas=3, min_replicas=3, max_replicas=2),
    dict(replicas=5, min_replicas=1, max_replicas=3),
    dict(replicas=1, min_replicas=0, max_replicas=3),
    dict(replicas=2, autoscale=True), dict(replicas=2),
    dict(replicas=1, autoscale=True, max_replicas=4),
    dict(replicas=0, prefill_replicas=4, decode_replicas=1,
         autoscale=True),
    dict(replicas=2, kv_replicas=1, kv_tier_mb=64.0, autoscale=True),
    dict(replicas=1, weights_version="v2 $(touch /tmp/pwn)"),
    dict(replicas=1, weights_version=""),
    dict(replicas=1, weights_version="v1\n"),
    dict(models=[("chat", 1), ("code", 0, 7)], warm_pool=1),
    dict(models=[("chat", 1), ("code", 0, 7)], warm_pool=1,
         model_budget=4, autoscale=True),
    dict(models=[("a", 2)], model_budget=1),
    dict(models=[("a", 0)]), dict(models=[("a", 1)], warm_pool=-1),
    dict(replicas=1, warm_pool=1), dict(replicas=1, model_budget=3),
    dict(models=[("a", 1)], prefill_replicas=1, decode_replicas=1),
    dict(models=[("a", 1), ("a", 2)])]


def _fleet_summary(side, kw):
    if side == "jax":
        from tfmesos_tpu.fleet.launcher import FleetServer
    else:
        from tfmesos_tpu_torch.fleet.launcher import FleetServer
    kw = dict(kw)
    if "models" in kw:
        kw["models"] = _specs(side, *kw["models"])
    try:
        fs = FleetServer(**kw)
    except Exception as e:     # noqa: BLE001 - the error is the result
        return ("raised", type(e).__name__, str(e))
    keys = ["unified", "prefill", "decode", "kv"]
    if fs.catalog is not None:
        keys += [f"{m}/unified" for m in fs.catalog.ids()] \
            + ["_pool/unified"]
    return ("ok", fs.min_replicas, fs.max_replicas, fs.replica_budget,
            fs.warm_pool, fs.replicas, fs.weights_version, fs.autoscale,
            fs.catalog.ids() if fs.catalog else None,
            {k: fs.bounds(k) for k in keys})


@pytest.mark.parametrize("kw", FLEETS, ids=lambda kw: repr(kw)[:48])
def test_fleet_validation_matches_jax(kw):
    mine = _fleet_summary("port", kw)
    assert mine == _fleet_summary("jax", kw)


def test_fleet_validation_spot_checks():
    """What the parity above must read: the JAX test's own messages and
    per-tier default ceilings."""
    bad = {i: _fleet_summary("port", FLEETS[i]) for i in (0, 4, 5, 6, 12)}
    assert "replicas=-1" in bad[0][2]
    assert "max_replicas (2)" in bad[4][2] and "min_replicas (3)" in bad[4][2]
    assert "count 5" in bad[5][2] and "[1, 3]" in bad[5][2]
    assert "min_replicas must be >= 1" in bad[6][2]
    assert "security boundary" in bad[12][2]
    fs = _fleet_summary("port", FLEETS[10])
    assert fs[9]["prefill"] == (1, 8) and fs[9]["decode"] == (1, 2)
    cat = _fleet_summary("port", FLEETS[15])
    assert cat[3] == 2 and cat[9]["code/unified"] == (0, 2)


# -- one CPU fleet: an aborted rollout, then a rollout under traffic ---------


NEW = 4
SHAPE = dict(tiny=True, max_len=64, page_size=16, prefill_bucket=16,
             device="cpu", request_timeout=120.0, start_timeout=120.0,
             heartbeat_interval=0.1)


def _prompts(n=8, seed=7):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 97, rng.randint(3, 30)).tolist()
            for _ in range(n)]


def _in_process(prompts):
    from tfmesos_tpu_torch.fleet import replica
    from tfmesos_tpu_torch.serving import Request

    args = replica.build_parser().parse_args(
        ["--tiny", "--device", "cpu", "--rows", "2", "--max-len", "64",
         "--page-size", "16", "--prefill-bucket", "16"])
    batcher = replica.build_batcher(args)
    done = {c.rid: list(c.tokens) for c in batcher.run(
        [Request(np.asarray(p, np.int32), NEW) for p in prompts])}
    return [done[rid] for rid in sorted(done)]


def test_cpu_fleet_rollout_aborts_then_rolls_under_traffic():
    from tfmesos_tpu_torch.fleet import FleetServer, RolloutError

    prompts = _prompts()
    want = _in_process(prompts)
    fleet = FleetServer(replicas=1, rows=2, warmup=True,
                        weights_version="v1", **SHAPE).start()
    try:
        client = fleet.client(timeout=120.0)
        assert client.generate(prompts[0], NEW)["tokens"] == want[0]
        (old,) = [r.addr for r in fleet.registry.alive()]
        # A new tier that never becomes routable: the rollout aborts,
        # its tasks are reaped and the old version keeps serving.
        real_cmd = fleet._replica_cmd

        def broken_cmd(role="unified", weights_version=None, **kw):
            if weights_version == "v2":
                return "exit 7"
            return real_cmd(role, weights_version, **kw)

        fleet._replica_cmd = broken_cmd
        with pytest.raises(RolloutError, match="aborted"):
            fleet.rollout("v2", warm_timeout=3.0, bake_s=0.0)
        fleet._replica_cmd = real_cmd
        assert fleet.weights_version == "v1"
        assert fleet.router._preferred_version is None
        assert _wait(lambda: fleet.tier_actual("unified") == 1, 30.0)
        assert client.generate(prompts[1], NEW)["tokens"] == want[1]
        # The rollout proper, through the gateway op, requests in flight.
        stop, errors, served = threading.Event(), [], []

        def feeder(k):
            i = k
            while not stop.is_set():
                try:
                    out = client.generate(prompts[i % len(prompts)], NEW)
                except Exception as e:  # noqa: BLE001 - asserted below
                    errors.append(e)
                    return
                served.append((i % len(prompts), out["tokens"]))
                i += 2

        threads = [threading.Thread(target=feeder, args=(k,))
                   for k in range(2)]
        for t in threads:
            t.start()
        time.sleep(0.3)
        info = client.rollout("v2", timeout=120.0)
        stop.set()
        for t in threads:
            t.join(timeout=60.0)
        assert not errors and served
        assert all(tokens == want[i] for i, tokens in served)
        assert info["ok"] and info["old_version"] == "v1"
        assert info["new_version"] == "v2" and info["reaped"] == 1
        assert info["generation"] == 2      # the aborted try bumped once
        alive = fleet.registry.alive()
        assert [r.weights_version for r in alive] == ["v2"]
        assert old not in {r.addr for r in alive}
        assert all(fleet.router.pick() != old for _ in range(8))
        assert client.generate(prompts[2], NEW)["tokens"] == want[2]
        snap = fleet.snapshot()
        # The fence: a straggler of an older generation is dropped, a
        # hello of the current one lands.
        sock = wire.connect(fleet.registry.addr)
        try:
            wire.send_msg(sock, {"op": "hello", "addr": "zombie:1",
                                 "gen": 1, "weights_version": "v1"},
                          fleet.token)
            wire.send_msg(sock, {"op": "hello", "addr": "fresh:1",
                                 "gen": 2, "weights_version": "v2"},
                          fleet.token)
            assert _wait(lambda: "fresh:1" in
                         {r.addr for r in fleet.registry.members()})
            assert "zombie:1" not in \
                {r.addr for r in fleet.registry.members()}
        finally:
            sock.close()
        client.close()
    finally:
        fleet.stop()
    c = snap["counters"]
    assert (c.get("rollouts"), c.get("rollouts_aborted")) == (1, 1)
    assert c.get("failed", 0) == 0 and c.get("shed_queue", 0) == 0
    assert snap["gauges"]["roles"]["unified"]["versions"] == {"v2": 1}
