"""The port's ``tfserve`` (``python -m tfmesos_tpu_torch.cli``): its
parser carries every flag of the JAX ``build_serve_parser`` with the
same default, bad flags exit 2 with the JAX message, every flag and
subcommand not ported yet exits 2 naming its ROADMAP item, ``--draft``
and ``--n-draft`` reach the replica command line as the JAX fleet puts
them there, the control-loop flags (``--autoscale``, ``--min-replicas``,
``--max-replicas``, ``--models``, ``--warm-pool``, ``--model-budget``)
build the fleet the JAX ``tfserve`` builds, ``parse_model_spec`` agrees
with JAX's, ``rollout`` and ``swap-adapter`` against a stub gateway give
the JAX subcommands' exit codes and lines, ``serve`` brings up a tiny
CPU fleet and stops it on ctrl-c, and ``submit``, ``metrics``,
``trace`` and ``gateways`` work against it."""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

from tfmesos_tpu import cli as jax_cli
from tfmesos_tpu_torch import cli

ROOT = Path(__file__).resolve().parent.parent
TOKEN = "cli-serve-token"


def _options(parser):
    return {opt: a for a in parser._actions for opt in a.option_strings}


def test_every_jax_serve_flag_exists_with_its_default():
    jax_opts = _options(jax_cli.build_serve_parser())
    port_opts = _options(cli.build_serve_parser())
    assert set(jax_opts) <= set(port_opts)
    for opt, action in jax_opts.items():
        mine = port_opts[opt]
        assert (mine.dest, mine.default, mine.choices, mine.nargs) \
            == (action.dest, action.default, action.choices, action.nargs), \
            opt
    assert set(port_opts) - set(jax_opts) == {"--device"}


def _run(main, argv, capsys):
    try:
        rc = main(argv)
    except SystemExit as e:     # argparse rejects before main returns
        rc = e.code
    captured = capsys.readouterr()
    return rc, captured.err.strip().splitlines()[-1:]


@pytest.mark.parametrize("argv", [
    ["--replicas", "-1"], ["--rows", "0"], ["--gateways", "0"],
    ["--role", "prefill:1"], ["--role", "tpu:1,decode:1"],
    ["--classes", "interactive"], ["--classes", "a:1,a:2"],
    ["--gang-size", "0"], ["--kv-replication", "9"],
    ["--no-such-flag"], ["--pipeline-depth", "2"], ["--rows", "x"]],
    ids=lambda a: " ".join(a))
def test_bad_flags_exit_2_with_the_jax_message(argv, capsys):
    mine = _run(cli.serve_main, argv, capsys)
    theirs = _run(jax_cli.serve_main, argv, capsys)
    assert mine[0] == theirs[0] == 2
    assert mine[1] == theirs[1]


#: the control-loop flags, ported: each argv builds the fleet the JAX
#: ``tfserve`` builds from it.
CONTROL_FLAGS = {
    "--autoscale": ["--autoscale"],
    "--min-replicas": ["--autoscale", "--min-replicas", "2"],
    "--max-replicas": ["--autoscale", "--max-replicas", "3"],
    "--models": ["--models", "chat:1,code:0:7,draft:2"],
    "--warm-pool": ["--models", "chat:1,code:0", "--warm-pool", "2"],
    "--model-budget": ["--models", "chat:2", "--model-budget", "3"],
}


def _fleet_of(mod, argv):
    """What ``mod``'s ``tfserve`` builds from ``argv``: the fleet's
    bounds, budget, catalog and each target key's replica command."""
    args = mod.build_serve_parser().parse_args(argv + ["--tiny"])
    models = mod.parse_model_spec(args.models)
    fleet = mod._build_fleet(args, models, mod.parse_role_spec(args.role),
                             mod.parse_class_spec(args.classes), TOKEN)
    fleet.registry = SimpleNamespace(addr="127.0.0.1:1")
    cmds = [fleet._replica_cmd()]
    if fleet.catalog is not None:
        cmds += [fleet._replica_cmd(model=spec) for spec in fleet.catalog]
        cmds.append(fleet._replica_cmd(pool=True))
    keys = ["unified"] + [f"{m}/unified" for m in
                          (fleet.catalog.ids() if fleet.catalog else ())]
    return {"autoscale": fleet.autoscale, "min": fleet.min_replicas,
            "max": fleet.max_replicas, "budget": fleet.replica_budget,
            "warm_pool": fleet.warm_pool, "replicas": fleet.replicas,
            "catalog": [(s.model_id, s.replicas, s.seed) for s in
                        (fleet.catalog or ())],
            "bounds": {k: fleet.bounds(k) for k in keys},
            "cmds": [" ".join(c.split()[1:]).replace(
                "tfmesos_tpu_torch.", "tfmesos_tpu.") for c in cmds]}


@pytest.mark.parametrize(
    "flag,dest,default,item",
    cli.NOT_PORTED_FLAGS + tuple((f, None, None, None)
                                 for f in CONTROL_FLAGS),
    ids=[f[0] for f in cli.NOT_PORTED_FLAGS] + list(CONTROL_FLAGS))
def test_flags_not_ported_yet_exit_2(flag, dest, default, item, capsys):
    """Each flag still waiting exits 2 naming its ROADMAP item; each
    control-loop flag (ported) builds the fleet the JAX ``tfserve``
    builds."""
    if flag in CONTROL_FLAGS:
        assert flag not in {f[0] for f in cli.NOT_PORTED_FLAGS}
        mine = _fleet_of(cli, CONTROL_FLAGS[flag])
        assert mine == _fleet_of(jax_cli, CONTROL_FLAGS[flag])
        want = {"--autoscale": ("autoscale", True),
                "--min-replicas": ("min", 2), "--max-replicas": ("max", 3),
                "--models": ("catalog", [("chat", 1, 0), ("code", 0, 7),
                                         ("draft", 2, 2)]),
                "--warm-pool": ("warm_pool", 2),
                "--model-budget": ("budget", 3)}[flag]
        assert mine[want[0]] == want[1]
        return
    value = {bool: [], int: ["2"], float: ["8"]}.get(type(default))
    if value is None:
        value = ["loaded"] if dest == "kv_placement" else \
            ["chat:1"] if dest == "models" else ["x"]
    if dest in ("min_replicas", "max_replicas", "model_budget",
                "http_port"):
        value = ["2"]
    rc, err = _run(cli.serve_main, [flag] + value, capsys)
    assert rc == 2
    assert err == [f"tfserve: not ported yet: {flag} (ROADMAP {item})"]


@pytest.mark.parametrize("argv", [["--draft"], ["--draft", "--n-draft", "2"]],
                         ids=["--draft", "--n-draft"])
def test_draft_flags_reach_every_replica(argv):
    """``--draft`` / ``--n-draft`` (speculative decoding, ported) build a
    fleet whose replica command carries them as the JAX fleet's does."""
    from tfmesos_tpu.fleet import launcher as jax_launcher

    args = cli.build_serve_parser().parse_args(argv + ["--tiny"])
    fleet = cli._build_fleet(args, None, {}, None, TOKEN)
    jargs = jax_cli.build_serve_parser().parse_args(argv + ["--tiny"])
    jfleet = jax_launcher.FleetServer(replicas=1, tiny=True,
                                      draft=jargs.draft,
                                      n_draft=jargs.n_draft)
    stub = SimpleNamespace(addr="127.0.0.1:1")
    fleet.registry = jfleet.registry = stub
    want = f"--draft --n-draft {jargs.n_draft}"
    assert (fleet.draft, fleet.n_draft) == (jfleet.draft, jfleet.n_draft)
    assert want in fleet._replica_cmd() and want in jfleet._replica_cmd()


MODEL_SPECS = ["chat:2,code:1:7,draft:0", "a:1", " a:1 , b:0:3 ", "",
               "chat", "chat:x", "chat:1:y", "chat:1:2:3", ":1", "a;b:1",
               "a:1,a:2", "a:-1", ",", "a:0", "x" * 65 + ":1",
               "chat:1,code:2:9,long.name-v2:0:11"]


@pytest.mark.parametrize("spec", MODEL_SPECS, ids=repr)
def test_parse_model_spec_matches_jax(spec):
    def parsed(mod):
        try:
            out = mod.parse_model_spec(spec)
        except ValueError as e:
            return ("raised", str(e))
        return out if out is None else [
            (s.model_id, s.replicas, s.seed, s.floor, s.scale_to_zero)
            for s in out]

    assert parsed(cli) == parsed(jax_cli)


class _StubControl:
    """A port gateway over an empty fleet with stub control planes: the
    rollout answers a summary (or raises for version ``boom``), the
    adapter swap records what reached it."""

    def __init__(self):
        from tfmesos_tpu_torch.fleet.admission import AdmissionController
        from tfmesos_tpu_torch.fleet.gateway import Gateway
        from tfmesos_tpu_torch.fleet.metrics import FleetMetrics
        from tfmesos_tpu_torch.fleet.registry import ReplicaRegistry
        from tfmesos_tpu_torch.fleet.router import Router

        self.reg = ReplicaRegistry(token=TOKEN).start()
        metrics = FleetMetrics()
        self.gw = Gateway(Router(self.reg, metrics, token=TOKEN),
                          AdmissionController(max_queue=4), metrics,
                          token=TOKEN, workers=1).start()
        self.swaps = []

        def rollout(version):
            if version == "boom":
                raise RuntimeError("new tier not routable within 5s")
            return {"old_version": "v0", "new_version": version,
                    "replicas": 2, "reaped": 2, "generation": 1}

        def swap(model_id, version, meta, body):
            self.swaps.append((model_id, version, len(body)))
            return {"model_id": model_id, "adapter_version": version,
                    "replicas": 3}

        self.gw.rollout_fn = rollout
        self.gw.swap_adapter_fn = swap

    def close(self):
        self.gw.stop()
        self.reg.stop()


def _control_runs(tmp_path, monkeypatch, capsys, sub):
    """``sub`` through the port's and the JAX ``tfserve`` against the same
    stub gateway: [(exit code, last stdout line, last stderr line)] of
    each argv, port then JAX."""
    np_ = pytest.importorskip("numpy")
    npz = tmp_path / "delta.npz"
    np_.savez(npz, **{"embed": np_.ones((4, 4), np_.float32)})
    empty = tmp_path / "empty.npz"
    np_.savez(empty)
    stub = _StubControl()
    gone = "127.0.0.1:1"
    if sub == "rollout":
        argvs = [["-g", stub.gw.addr, "--version", "v2"],
                 ["-g", stub.gw.addr, "--version", "boom"],
                 ["-g", gone, "--version", "v2"]]
    else:
        argvs = [["-g", stub.gw.addr, "--model", "chat", "--version", "a1",
                  "--npz", str(npz)],
                 ["-g", stub.gw.addr, "--model", "bad;id", "--version",
                  "a1", "--npz", str(npz)],
                 ["-g", stub.gw.addr, "--model", "chat", "--version", "a1",
                  "--npz", str(tmp_path / "missing.npz")],
                 ["-g", stub.gw.addr, "--model", "chat", "--version", "a1",
                  "--npz", str(empty)],
                 ["-g", gone, "--model", "chat", "--version", "a1",
                  "--npz", str(npz)]]
    out = []
    try:
        for main in (cli.main, jax_cli.serve_main):
            for token in (None, TOKEN):
                for argv in argvs if token else argvs[:1]:
                    monkeypatch.delenv("TPUMESOS_TOKEN_FILE", raising=False)
                    if token:
                        monkeypatch.setenv("TPUMESOS_TOKEN", token)
                    else:
                        monkeypatch.delenv("TPUMESOS_TOKEN", raising=False)
                    try:
                        rc = main([sub] + argv)
                    except SystemExit as e:
                        rc = e.code
                    cap = capsys.readouterr()
                    out.append((rc, cap.out.strip().splitlines()[-1:],
                                cap.err.strip().splitlines()[-1:]))
    finally:
        stub.close()
    return out[:len(out) // 2], out[len(out) // 2:], stub.swaps


@pytest.mark.parametrize(
    "sub", sorted(list(cli.NOT_PORTED_SUBCOMMANDS)
                  + ["rollout", "swap-adapter"]))
def test_subcommands_not_ported_yet_exit_2(sub, capsys, tmp_path,
                                           monkeypatch):
    """Each subcommand still waiting exits 2 naming its ROADMAP item;
    ``rollout`` and ``swap-adapter`` (ported) answer as the JAX ones do
    against the same gateway: no cluster token, success, the control
    plane's failure, a bad input, an unreachable gateway."""
    if sub in ("rollout", "swap-adapter"):
        assert sub not in cli.NOT_PORTED_SUBCOMMANDS
        mine, theirs, swaps = _control_runs(tmp_path, monkeypatch, capsys,
                                            sub)
        assert mine == theirs
        assert mine[0][0] == 2 and "no cluster token" in mine[0][2][0]
        assert mine[1][0] == 0
        if sub == "rollout":
            assert mine[1][1] == ["tfserve rollout: fleet now serves "
                                  "weights_version v2 (was v0; 2 "
                                  "replica(s) launched, 2 reaped, "
                                  "generation fence 1)"]
            assert mine[2][0] == 1 and "rollout_failed" in mine[2][2][0]
            assert mine[3][0] == 1 and "cannot reach" in mine[3][2][0]
        else:
            assert mine[1][1] == ["tfserve swap-adapter: model chat now "
                                  "serves adapter a1 on 3 replica(s)"]
            assert [r[0] for r in mine[2:]] == [1, 2, 2, 1]
            assert swaps == [("chat", "a1", 64)] * 2
        return
    for argv in ([sub], ["serve", sub]):
        rc, err = _run(cli.main, argv, capsys)
        assert rc == 2
        assert err == [f"tfserve: not ported yet: {sub} (ROADMAP "
                       f"{cli.NOT_PORTED_SUBCOMMANDS[sub]})"]


def test_usage_and_tfrun(capsys):
    """No subcommand is a usage error naming ``run``; ``run`` is tfrun
    (ported: a Mode-B job runs to its end, with a tp mesh too, and an
    axis not ported yet exits 2 naming its ROADMAP item)."""
    rc, err = _run(cli.main, [], capsys)
    assert rc == 2 and "{run,serve," in err[0]
    rc, err = _run(cli.main, ["run", "-w", "1", "-s", "0", "--mesh", "tp=2",
                              "--", "true"], capsys)
    assert rc == 0
    rc, err = _run(cli.main, ["run", "-w", "1", "-s", "0", "--mesh", "sp=2",
                              "--", "true"], capsys)
    assert rc == 2
    assert err == ["tfrun: not ported yet: mesh axis sp (ROADMAP A.10)"]
    assert _run(cli.main, ["run", "-w", "1", "-s", "0", "--", "true"],
                capsys)[0] == 0


def test_serve_main_serves_and_stops_on_ctrl_c(monkeypatch, capsys):
    """``serve_main`` brings up one tiny CPU replica; the subcommands run
    against it from inside the serve loop's wait, which then raises
    KeyboardInterrupt (ctrl-c) and the fleet stops."""
    monkeypatch.setenv("TPUMESOS_TOKEN", TOKEN)
    monkeypatch.delenv("TPUMESOS_TOKEN_FILE", raising=False)
    seen = {}

    def interrupted_sleep(_seconds):
        banner = capsys.readouterr().out.strip().splitlines()[-1]
        seen["banner"] = banner
        gw = banner.split()[3]
        rc = cli.main(["submit", "-g", gw, "--prompt", "5,9,3", "-n", "4",
                       "--trace"])
        seen["submit"] = (rc, json.loads(
            capsys.readouterr().out.strip().splitlines()[-1]))
        seen["metrics"] = (cli.main(["metrics", "-g", gw, "--json"]),
                           json.loads(capsys.readouterr().out))
        rc = cli.main(["trace", "-g", gw, "--id",
                       seen["submit"][1]["trace_id"]])
        seen["trace"] = (rc, capsys.readouterr().out)
        seen["gateways"] = (cli.main(["gateways", "-g", gw]),
                            capsys.readouterr().out.split())
        raise KeyboardInterrupt

    monkeypatch.setattr(cli, "time", SimpleNamespace(sleep=interrupted_sleep))
    rc = cli.main(["serve", "--replicas", "1", "--tiny", "--device", "cpu",
                   "--rows", "2", "--max-len", "64", "-p", "0",
                   "--gateway-host", "127.0.0.1", "--metrics-interval",
                   "0"])
    assert rc == 0
    assert seen["banner"].startswith("tfserve: gateway on 127.0.0.1:")
    assert seen["banner"].endswith("fronting 1 unified replica(s); "
                                   "ctrl-c to stop")
    rc, out = seen["submit"]
    assert rc == 0 and len(out["tokens"]) == 4 and out["trace_id"]
    rc, snap = seen["metrics"]
    assert rc == 0
    assert snap["counters"]["received"] == snap["counters"]["completed"] \
        == 1
    rc, text = seen["trace"]
    assert rc == 0 and seen["submit"][1]["trace_id"] in text
    rc, addrs = seen["gateways"]
    assert rc == 0 and addrs == [seen["banner"].split()[3]]
    assert "tfserve: shutting down" in capsys.readouterr().err


def test_serve_process_exits_0_on_sigint_leaving_nothing():
    """The real process: ``python -m tfmesos_tpu_torch.cli serve``, its
    banner, a ``submit``, then SIGINT — exit 0, and no process of the
    task sessions it started is left."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    env["TPUMESOS_TOKEN"] = TOKEN
    env.pop("TPUMESOS_TOKEN_FILE", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "tfmesos_tpu_torch.cli", "serve",
         "--replicas", "1", "--tiny", "--device", "cpu", "--rows", "2",
         "--max-len", "64", "-p", "0", "--gateway-host", "127.0.0.1",
         "--metrics-interval", "0"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        deadline = time.monotonic() + 120.0
        banner = ""
        while time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            if line.startswith("tfserve: gateway on"):
                banner = line
                break
        assert banner, proc.stderr.read() if proc.poll() is not None else ""
        gw = banner.split()[3]
        out = subprocess.run(
            [sys.executable, "-m", "tfmesos_tpu_torch.cli", "submit", "-g",
             gw, "--prompt", "1,2,3", "-n", "3"],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        assert len(json.loads(out.stdout)["tokens"]) == 3
        replicas = _task_pids(proc.pid)
        assert len(replicas) >= 2      # the node runtime and the replica
        proc.send_signal(signal.SIGINT)
        _, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err
    assert "tfserve: shutting down" in err
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline and _alive(replicas):
        time.sleep(0.05)
    assert not _alive(replicas)


def _stat(pid):
    """(state, ppid, session) of a process, or None once it is gone."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
    except OSError:
        return None
    return fields[0], int(fields[1]), int(fields[3])


def _pids():
    return [int(n) for n in os.listdir("/proc") if n.isdigit()]


def _task_pids(parent):
    """Every process of the task sessions ``parent`` started: its
    LocalBackend children lead one session each (node runtime, shell,
    replica)."""
    stats = {pid: _stat(pid) for pid in _pids()}
    sids = {pid for pid, s in stats.items() if s and s[1] == parent}
    return [pid for pid, s in stats.items() if s and s[2] in sids]


def _alive(pids):
    return [pid for pid in pids
            if (_stat(pid) or ("Z",))[0] != "Z"]
