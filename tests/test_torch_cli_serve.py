"""The port's ``tfserve`` (``python -m tfmesos_tpu_torch.cli``): its
parser carries every flag of the JAX ``build_serve_parser`` with the
same default, bad flags exit 2 with the JAX message, every flag and
subcommand not ported yet exits 2 naming its ROADMAP item, ``serve``
brings up a tiny CPU fleet and stops it on ctrl-c, and ``submit``,
``metrics``, ``trace`` and ``gateways`` work against it."""

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


@pytest.mark.parametrize("flag,dest,default,item", cli.NOT_PORTED_FLAGS,
                         ids=[f[0] for f in cli.NOT_PORTED_FLAGS])
def test_flags_not_ported_yet_exit_2(flag, dest, default, item, capsys):
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


@pytest.mark.parametrize("sub", sorted(cli.NOT_PORTED_SUBCOMMANDS))
def test_subcommands_not_ported_yet_exit_2(sub, capsys):
    for argv in ([sub], ["serve", sub]):
        rc, err = _run(cli.main, argv, capsys)
        assert rc == 2
        assert err == [f"tfserve: not ported yet: {sub} (ROADMAP "
                       f"{cli.NOT_PORTED_SUBCOMMANDS[sub]})"]


def test_usage_and_tfrun(capsys):
    assert _run(cli.main, [], capsys)[0] == 2
    rc, err = _run(cli.main, ["run", "-w", "1", "--", "true"], capsys)
    assert rc == 2 and "not ported yet: tfrun" in err[0]


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
