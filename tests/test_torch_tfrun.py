"""``tfrun`` on the port (``python -m tfmesos_tpu_torch.cli run``) and the
examples it launches: ports of the JAX ``tests/test_cli.py`` tfrun tests
against the local backend, ``plus`` printing 42 over two processes, and
``mnist_replica`` keeping the reference's output contract."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from tfmesos_tpu_torch.cli import (build_parser, forward_map, main,
                                   parse_mesh, parse_volumes, run_main)

ROOT = Path(__file__).resolve().parent.parent


def test_parser_full_flag_surface():
    args = build_parser().parse_args([
        "-w", "4", "-s", "2", "-m", "zk://zk/mesos", "-n", "myjob",
        "-C", "MESOS", "-f", "-Cw", "2.5", "-Gw", "4", "-Mw", "2048",
        "-Cs", "1.5", "-Gs", "0", "-Ms", "512", "-v",
        "-V", "/data:/mnt/data", "-V", "/tmp:/tmp2", "-r", "gpu",
        "--worker-logs", "*", "--gang", "--mesh", "dp=4,tp=1",
        "--restarts", "2", "--restart-policy", "elastic",
        "--max-cluster-restarts", "5", "--restart-window", "60",
        "--", "python", "train.py", "--ps_hosts", "{ps_hosts}"])
    assert args.nworker == 4 and args.nserver == 2
    assert args.worker_chips == 4 and args.worker_cpus == 2.5
    assert args.server_mem == 512.0 and args.role == "gpu"
    assert args.restart_policy == "elastic" and args.restarts == 2
    assert args.max_cluster_restarts == 5 and args.restart_window == 60.0
    assert args.cmd == ["--", "python", "train.py", "--ps_hosts",
                        "{ps_hosts}"]
    assert parse_volumes(args.volume) == {"/data": "/mnt/data",
                                          "/tmp": "/tmp2"}
    assert parse_mesh(args.mesh) == {"dp": 4, "tp": 1}


def test_parser_matches_jax_tfrun():
    """Every tfrun flag of the JAX package parses to the same values."""
    from tfmesos_tpu.cli import build_parser as jax_parser

    argv = ["-w", "3", "-s", "1", "-Gw", "1", "--worker-logs", "0,2",
            "--restart-policy", "elastic", "--", "echo", "x"]
    mine, theirs = (vars(p.parse_args(argv))
                    for p in (build_parser(), jax_parser()))
    assert mine == theirs


def test_forward_map():
    assert forward_map("0", 4, "h:1") == {"worker:0": "h:1"}
    assert forward_map("1,3", 4, "h:1") == {"worker:1": "h:1",
                                            "worker:3": "h:1"}
    assert forward_map("*", 2, "h:1") == {"worker:0": "h:1",
                                          "worker:1": "h:1"}
    with pytest.raises(ValueError, match="bad --worker-logs"):
        forward_map("a", 2, "h:1")


def test_bad_mesh_and_volume():
    with pytest.raises(ValueError):
        parse_mesh("dp4")
    with pytest.raises(ValueError):
        parse_volumes(["nodst"])
    assert parse_mesh("dp=4,tp=2") == {"dp": 4, "tp": 2}
    with pytest.raises(ValueError,
                       match=r"mesh axis pp \(ROADMAP A\.10\)"):
        parse_mesh("dp=4,pp=2")


@pytest.mark.parametrize("mesh,item", [("tp=2", None),
                                       ("dp=2,sp=2", "sp (ROADMAP A.10)"),
                                       ("dcn.dp=2,dp=1",
                                        "dcn.dp (ROADMAP A.9 (c))")])
def test_tfrun_refuses_a_later_mesh_axis(mesh, item, capfd):
    """sp and dcn. axes exit 2 naming their ROADMAP items; tp (item
    None) is ported and the job runs."""
    rc = main(["run", "-w", "2", "-s", "0", "--mesh", mesh, "--", "true"])
    if item is None:
        assert rc == 0
        return
    assert rc == 2
    assert capfd.readouterr().err.strip() == (f"tfrun: not ported yet: "
                                              f"mesh axis {item}")


def test_tfrun_end_to_end_forwards_logs(capfd):
    rc = run_main(["-w", "2", "-s", "0", "--worker-logs", "*", "--",
                   "echo", "task-{task_index}-of-{world_size}"])
    assert rc == 0
    out = capfd.readouterr().out
    assert "[worker:0] task-0-of-2" in out
    assert "[worker:1] task-1-of-2" in out


def test_tfrun_restarts_recovers(tmp_path, capfd):
    marker = tmp_path / "attempt-marker"
    cmd = f"test -f {marker} && echo RECOVERED || (touch {marker}; exit 3)"
    rc = run_main(["-w", "1", "-s", "0", "--restarts", "2",
                   "--worker-logs", "*", "--", cmd])
    assert rc == 0
    assert "RECOVERED" in capfd.readouterr().out


def test_tfrun_elastic_mode_b_relaunches_with_a_bumped_generation(capfd):
    """Under the elastic policy a failed Mode-B gang is relaunched whole
    with TPUMESOS_GENERATION bumped: this command fails in generation 0
    and succeeds in 1."""
    cmd = ('echo gen=$TPUMESOS_GENERATION; '
           'test "$TPUMESOS_GENERATION" = 1')
    rc = run_main(["-w", "2", "-s", "0", "--restart-policy", "elastic",
                   "--worker-logs", "*", "--", cmd])
    assert rc == 0
    out = capfd.readouterr().out
    assert "[worker:0] gen=0" in out and "[worker:1] gen=1" in out


def test_tfrun_cluster_failure_is_one_line(capfd):
    rc = run_main(["-w", "1", "-s", "0", "--", "exit 3"])
    assert rc == 1
    err = [line for line in capfd.readouterr().err.splitlines()
           if line.startswith("tfrun:")]
    assert len(err) == 1 and err[0].startswith("tfrun: cluster failed: ")


def test_tfrun_missing_extra_config(capfd):
    rc = run_main(["-w", "1", "-s", "0", "-e", "/nonexistent-config.json",
                   "--", "echo", "hi"])
    assert rc == 2
    assert "cannot read extra config" in capfd.readouterr().err


def test_tfrun_extra_config_hooks(tmp_path, capfd):
    marker = tmp_path / "init-ran"
    cfg = tmp_path / "extra.json"
    cfg.write_text(json.dumps({
        "initializer": f"touch {marker}",
        "finalizer": f"test -f {marker} && echo FINAL >> {marker}",
    }))
    rc = run_main(["-w", "1", "-s", "0", "-e", str(cfg), "--worker-logs",
                   "*", "--", "cat", str(marker), "&&", "echo",
                   "done-{job_name}"])
    assert rc == 0
    assert "FINAL" in marker.read_text()
    assert "[worker:0] done-worker" in capfd.readouterr().out


def test_tfrun_trains_the_transformer_over_two_ranks(capfd):
    """tfrun -> LocalBackend cluster -> a 2-rank gloo process group -> a
    dp mesh -> the trainer, each rank on half the global batch; both
    ranks print the same losses."""
    rc = run_main(["-w", "2", "-s", "0", "--mesh", "dp=-1", "--worker-logs",
                   "*", "--", sys.executable, "-m",
                   "tfmesos_tpu_torch.transformer_train", "--tiny",
                   "--steps", "2", "--device", "cpu", "--batch_size", "4",
                   "--seq_len", "32"])
    assert rc == 0
    out = capfd.readouterr().out
    assert "[worker:0] Training elapsed time" in out
    assert "[worker:0] tokens/sec" in out
    assert "mesh={'dp': 2}" in out
    losses = dict(re.findall(r"^\[worker:\d\] rank (\d)/2 step losses: "
                             r"(\[.*\])$", out, re.M))
    assert sorted(losses) == ["0", "1"] and losses["0"] == losses["1"]
    assert len(json.loads(losses["0"])) == 2


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_plus_prints_42_on_the_cpu():
    out = subprocess.run([sys.executable, "-m", "tfmesos_tpu_torch.plus",
                          "--device", "cpu"], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "42"


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    """No fallback: without a card, each new entry point raises naming
    the way out, unless it is given ``--device cpu``."""
    import torch

    from tfmesos_tpu_torch import mnist_replica, transformer_train

    if torch.cuda.is_available():
        return
    for entry, argv in ((mnist_replica.main, []),
                        (transformer_train.main, ["--tiny"])):
        with pytest.raises(RuntimeError, match="pass device='cpu'"):
            entry(argv)


def test_mnist_replica_under_tfrun_keeps_the_output_contract(capfd):
    """tfrun -w 2 -s 1: three ranks (ps:0, worker:0, worker:1) over an
    fsdp mesh; each worker's forwarded output keeps the reference's
    lines, and every rank reports the same validation cross entropy."""
    rc = run_main(["-w", "2", "-s", "1", "--worker-logs", "*", "--",
                   sys.executable, "-m", "tfmesos_tpu_torch.mnist_replica",
                   "--train_steps", "60", "--batch_size", "99", "--device",
                   "cpu"])
    assert rc == 0
    out = capfd.readouterr().out
    for i in (0, 1):
        for line in (f"job name = worker", f"task index = {i}",
                     "mesh = {'fsdp': 3} over 3 rank(s) on cpu",
                     "Training begins @",
                     f"Worker {i}: training step 50 done",
                     f"Worker {i}: training step 60 done",
                     "Training elapsed time:", "steps/sec:",
                     "After 60 training step(s), validation cross "
                     "entropy = ", "validation accuracy = "):
            assert re.search(rf"^\[worker:{i}\] .*{re.escape(line)}", out,
                             re.M), line
    # Raw (ps:0 and the workers' own mirrors) and forwarded lines alike.
    ce = re.findall(r"validation cross entropy = (\S+)$", out, re.M)
    assert len(ce) == 5 and len(set(ce)) == 1
    acc = re.findall(r"validation accuracy = (\S+)$", out, re.M)
    assert len(set(acc)) == 1 and float(acc[0]) > 0.5
