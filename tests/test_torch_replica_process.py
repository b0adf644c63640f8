"""The port replica as a process, with JAX blocked from import:
``python -m tfmesos_tpu_torch.fleet.replica --tiny --device cpu
--registry <JAX registry> --prefix-cache-pages 8 --warmup`` registers,
prints its warmed and serving lines, serves through the JAX gateway the
completions of the port preset's own offline ``generate`` (its weights
are the torch draw of ``--seed``), and on SIGTERM sends ``drain`` and
exits 0.  Without ``--device`` it asks for the card and, with none
here, fails instead of serving on the CPU; an option not ported yet
exits 2."""

import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch
from torch_parity import JaxFleet, jax_compile_cache_off  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
TOKEN = "replica-process-token"
NEW = 6
BLOCKED = ("import runpy, sys\n"
           "for m in ('jax', 'jaxlib', 'tfmesos_tpu'):\n"
           "    sys.modules[m] = None\n"
           "sys.argv = ['replica'] + sys.argv[1:]\n"
           "runpy.run_module('tfmesos_tpu_torch.fleet.replica',\n"
           "                 run_name='__main__')\n")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    env["TPUMESOS_TOKEN"] = TOKEN
    env.pop("TPUMESOS_TOKEN_FILE", None)
    return env


def _replica(*argv, **kw):
    return subprocess.Popen([sys.executable, "-c", BLOCKED, *argv],
                            cwd=ROOT, env=_env(), text=True, **kw)


def _offline(prompts):
    """The port preset's own greedy ``generate`` (seed 0) of each
    prompt."""
    from tfmesos_tpu_torch.models import presets
    from tfmesos_tpu_torch.models.transformer import generate

    cfg, params = presets.tiny_model(0)
    out = []
    for p in prompts:
        seq = generate(cfg, params, torch.tensor([p]), NEW)
        out.append(seq[0, len(p):].tolist())
    return out


def test_replica_process_registers_serves_and_drains(tmp_path):
    fleet = JaxFleet(TOKEN)
    log = open(tmp_path / "stderr.log", "w+")
    proc = _replica("--tiny", "--device", "cpu", "--registry", fleet.addr,
                    "--prefix-cache-pages", "8", "--warmup",
                    "--heartbeat-interval", "0.05",
                    stdout=subprocess.PIPE, stderr=log)
    lines = []
    try:
        timer = threading.Timer(60.0, proc.kill)
        timer.start()
        for line in proc.stdout:
            lines.append(line.strip())
            if line.startswith("replica serving on"):
                break
        timer.cancel()
        assert lines and lines[-1].endswith("(role unified)"), lines
        assert any(x.startswith("replica warmed in") for x in lines), lines
        addr = lines[-1].split()[3]
        fleet.wait_routable(addr)
        rng = np.random.RandomState(5)
        prompts = [rng.randint(0, 97, n).tolist() for n in (4, 17, 70)]
        client = fleet.client()
        got = [client.generate(p, NEW)["tokens"] for p in prompts]
        assert got == _offline(prompts)
        info = fleet.info(addr)
        assert info.role == "unified" and info.prefix
        t0 = time.monotonic()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30.0) == 0, \
            (tmp_path / "stderr.log").read_text()
        assert time.monotonic() - t0 < 30.0
        assert fleet.info(addr).announced_drain
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
        fleet.close()


def test_default_device_is_the_card_with_no_fallback():
    out = subprocess.run([sys.executable, "-c", BLOCKED, "--tiny"],
                         cwd=ROOT, env=_env(), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert "no CUDA device is available" in out.stderr
    assert "replica serving on" not in out.stdout


def test_unported_option_exits_2_from_the_command_line():
    """A gang launch is ported; from the command line, with JAX blocked,
    its invalid forms exit 2 naming the rule, as the JAX replica's do: a
    ``--role prefill`` leader (rank 0), and a member (rank 1) with no
    ``--registry`` to find its leader through."""
    for rank, extra, want in (
            ("0", ["--role", "prefill"], "--role prefill cannot lead a gang"),
            ("1", [], "gang member needs --registry for leader "
                      "rendezvous")):
        env = dict(_env(), TPUMESOS_GANG_ID="g1", TPUMESOS_GANG_SIZE="2",
                   TPUMESOS_GANG_RANK=rank)
        out = subprocess.run([sys.executable, "-c", BLOCKED, "--tiny",
                              "--device", "cpu", "--draft"] + extra,
                             cwd=ROOT, env=env, capture_output=True,
                             text=True, timeout=120)
        assert out.returncode == 2, out.stderr
        assert want in out.stderr
