"""Package-level contracts of the PyTorch port: it imports with JAX
absent, no module of it (nor chip_smoke.py) imports JAX or the JAX
package, its serving and training entry points run end to end on the
CPU, and its kernel builds follow their sources."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "tfmesos_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "tfmesos_tpu"}
#: the front door's modules: the control plane (its autoscaler and model
#: catalog included), the scheduler and its backend, the node runtime
#: and tfserve.
FRONT_DOOR = ("tfmesos_tpu_torch.fleet.registry",
              "tfmesos_tpu_torch.fleet.router",
              "tfmesos_tpu_torch.fleet.gateway",
              "tfmesos_tpu_torch.fleet.admission",
              "tfmesos_tpu_torch.fleet.containment",
              "tfmesos_tpu_torch.fleet.metrics",
              "tfmesos_tpu_torch.fleet.launcher",
              "tfmesos_tpu_torch.fleet.autoscaler",
              "tfmesos_tpu_torch.fleet.catalog",
              "tfmesos_tpu_torch.scheduler", "tfmesos_tpu_torch.spec",
              "tfmesos_tpu_torch.backends",
              "tfmesos_tpu_torch.backends.local",
              "tfmesos_tpu_torch.server", "tfmesos_tpu_torch.runtime",
              "tfmesos_tpu_torch.logpump", "tfmesos_tpu_torch.cli")


#: the training slice's modules: the step and its loop, the optimizer,
#: the streams (the token file's native gather included), checkpoints
#: and restart supervision.
TRAINING = ("tfmesos_tpu_torch.train.trainer",
            "tfmesos_tpu_torch.train.optim",
            "tfmesos_tpu_torch.train.data",
            "tfmesos_tpu_torch.train.checkpoint",
            "tfmesos_tpu_torch.train.supervisor",
            "tfmesos_tpu_torch.transformer_train")


#: the reference's own surface: the data mesh, the MNIST model, and the
#: workloads tfrun and ``cluster()`` run.
SURFACE = ("tfmesos_tpu_torch.parallel", "tfmesos_tpu_torch.parallel.mesh",
           "tfmesos_tpu_torch.parallel.collectives",
           "tfmesos_tpu_torch.parallel.sharding", "tfmesos_tpu_torch.dryrun",
           "tfmesos_tpu_torch.models.mlp", "tfmesos_tpu_torch.plus",
           "tfmesos_tpu_torch.mnist_replica")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_every_module_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'tfmesos_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import importlib, pkgutil, tfmesos_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    tfmesos_tpu_torch.__path__, 'tfmesos_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "print(len(names), *names)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    count, *names = out.stdout.split()
    assert int(count) >= 10
    assert {"tfmesos_tpu_torch.wire", "tfmesos_tpu_torch.utils.logging",
            "tfmesos_tpu_torch.fleet.replica",
            "tfmesos_tpu_torch.fleet.client",
            "tfmesos_tpu_torch.fleet.tracing",
            "tfmesos_tpu_torch.fleet.kvtier"} <= set(names)
    assert set(FRONT_DOOR) <= set(names)
    assert set(TRAINING) <= set(names)
    assert set(SURFACE) <= set(names)


def test_public_surface_with_jax_blocked():
    """With JAX and the JAX package blocked: the package exports the
    JAX package's surface (``cluster`` and the rest) without importing
    torch; Mode A, the elastic policy and tfrun are no longer refused,
    nor are the tp and dp x fsdp meshes; what is still missing (the
    sp/pp/ep and dcn. axes among it) is refused by name."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'tfmesos_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import tfmesos_tpu_torch as t\n"
        "print(sorted(t.__all__), t.__VERSION__ == t.__version__,\n"
        "      'torch' in sys.modules)\n"
        f"for n in {SURFACE!r}:\n"
        "    __import__(n)\n"
        "from tfmesos_tpu_torch import cli, runtime\n"
        "from tfmesos_tpu_torch.parallel import mesh\n"
        "s = t.TPUMesosScheduler([t.Job(name='w', num=1)],\n"
        "                        restart_policy='elastic')\n"
        "print(callable(s.run_all), callable(s.wait_ready),\n"
        "      s.restart_stats['restart_budget_left'],\n"
        "      callable(runtime.initialize), callable(cli.run_main))\n"
        "def refused(f, *a):\n"
        "    try:\n"
        "        f(*a)\n"
        "    except Exception as e:\n"
        "        return str(e)\n"
        "print(refused(s.add_gang, 'r', ['true']))\n"
        "print(refused(t.TPUMesosScheduler, [], None, '10.0.0.1:5050'))\n"
        "for axis in ('dcn.dp', 'sp', 'pp', 'ep'):\n"
        "    print(refused(mesh.check_axes, {axis: 2}))\n"
        "print(mesh.check_axes({'dp': 2, 'fsdp': 2, 'tp': 2}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[0] == ("['ClusterError', 'Job', 'RemoteError', "
                        "'TPUMesosScheduler', '__VERSION__', '__version__', "
                        "'cluster'] True False")
    assert lines[1] == "True True 3 True True"
    assert lines[2:] == [
        "not ported yet: add_gang, gang replicas (ROADMAP A.9 (c))",
        "not ported yet: the Mesos backend (ROADMAP A.12 (g))",
        "not ported yet: mesh axis dcn.dp (ROADMAP A.9 (c))",
        "not ported yet: mesh axis sp (ROADMAP A.10)",
        "not ported yet: mesh axis pp (ROADMAP A.10)",
        "not ported yet: mesh axis ep (ROADMAP A.10)",
        "{'dp': 2, 'fsdp': 2, 'tp': 2}"]


def test_slice_modules_import_with_jax_blocked():
    """The slices' modules by name (the walk above covers them too; this
    names them so a rename cannot drop one): int8 generation, and the
    batcher's fleet surface with the prefix hashing and rolling caches."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'tfmesos_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import tfmesos_tpu_torch.ops.quant as q\n"
        "import tfmesos_tpu_torch.generate as g\n"
        "from tfmesos_tpu_torch.ops.attention import LAUNCHES\n"
        "print(sorted(q.LAUNCHES), 'flash_decode' in LAUNCHES,\n"
        "      callable(g.main))\n"
        "import tfmesos_tpu_torch.prefixhash as ph\n"
        "import tfmesos_tpu_torch.serving as s\n"
        "import tfmesos_tpu_torch.serve as sv\n"
        "from tfmesos_tpu_torch.models.transformer import (\n"
        "    _rolling_decode, init_cache)\n"
        "print(len(ph.prompt_digests(list(range(20)), 8)),\n"
        "      sorted(s.BYPASS_ALLOWLIST)[0], callable(s.pack_prefilled),\n"
        "      callable(s.unpack_prefilled), callable(sv.main),\n"
        "      all(hasattr(s.ContinuousBatcher, a) for a in (\n"
        "          'export_kv', 'preempt_all', 'kv_headroom',\n"
        "          'prefix_cache_summary')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["['quant_int8',", "'quant_int8_commit']",
                                  "True", "True", "2", "fused_prefill",
                                  "True", "True", "True", "True"]


def test_fleet_modules_import_with_jax_blocked():
    """The replica slice's modules by name: the wire, the logging copy
    and the fleet subpackage (client, tracing, kvtier, replica)."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'tfmesos_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import tfmesos_tpu_torch.wire as w\n"
        "import tfmesos_tpu_torch.utils.logging as lg\n"
        "import tfmesos_tpu_torch.fleet as f\n"
        "from tfmesos_tpu_torch.fleet import client, kvtier, replica, "
        "tracing\n"
        "print(w.MAX_FRAME, w.MAX_RAW_FRAME, w.MAX_RAW_META,\n"
        "      callable(lg.get_logger), callable(client.MuxConnection),\n"
        "      callable(kvtier.fabric_rpc), callable(replica.start_replica),\n"
        "      callable(tracing.TraceContext), sorted(f.__all__)[0],\n"
        "      replica.rid_seed_for_node('replica:3'))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [str(64 << 20), str(1 << 30), str(1 << 20),
                                  "True", "True", "True", "True", "True",
                                  "AdmissionController", "276169728"]


def test_front_door_modules_import_with_jax_blocked():
    """The front door's modules by name, with JAX and the JAX package
    blocked: each imports, the package exports the launcher surface,
    and the node runtime and the launcher name the port's modules."""
    code = (
        "import sys, importlib\n"
        "for m in ('jax', 'jaxlib', 'tfmesos_tpu'):\n"
        "    sys.modules[m] = None\n"
        f"for n in {FRONT_DOOR!r}:\n"
        "    importlib.import_module(n)\n"
        "import tfmesos_tpu_torch.fleet as f\n"
        "from tfmesos_tpu_torch import spec, wire\n"
        "from tfmesos_tpu_torch.fleet import client, launcher\n"
        "ti = spec.Task('replica', 0, cmd='true').to_task_info(\n"
        "    spec.Offer('o', 'a', 'h', 1, 1), '127.0.0.1:1', 't')\n"
        "print(all(hasattr(f, n) for n in ('FleetServer', 'FleetClient',\n"
        "      'Gateway', 'Router', 'ReplicaRegistry', 'FleetAutoscaler',\n"
        "      'AutoscalerConfig', 'ModelTrader', 'ModelSpec',\n"
        "      'RolloutError')),\n"
        "      client.Overloaded is f.admission.Overloaded,\n"
        "      '-m tfmesos_tpu_torch.server' in ti['command']['value'],\n"
        "      callable(wire.WireServer), sorted(launcher.TIER_JOBS))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["True", "True", "True", "True",
                                  "['decode',", "'kv',", "'prefill',",
                                  "'unified']"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


def test_no_jax_imports_in_port_or_chip_smoke():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    assert {"wire.py", "replica.py", "client.py", "logging.py"} <= {
        f.name for f in files}
    bad = {str(f.relative_to(ROOT)): sorted(FORBIDDEN & set(
        _imported_roots(f))) for f in files}
    assert not {k: v for k, v in bad.items() if v}


def _jax_package_names(path: Path):
    """Every name of the JAX package a file imports or asks an importer
    for by string (``import_module``, ``__import__``, ``run_module``,
    ``find_spec``), in any form."""
    tree = ast.parse(path.read_text(), filename=str(path))

    def jax_pkg(name):
        return isinstance(name, str) and (
            name == "tfmesos_tpu" or name.startswith("tfmesos_tpu."))

    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names if jax_pkg(a.name))
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and jax_pkg(node.module):
            yield node.module
        elif isinstance(node, ast.Call) and node.args:
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else \
                getattr(fn, "id", "")
            arg = node.args[0]
            if name in ("import_module", "__import__", "run_module",
                        "find_spec") and isinstance(arg, ast.Constant) \
                    and jax_pkg(arg.value):
                yield arg.value


def test_no_module_of_the_port_imports_the_jax_package():
    """No port module (nor chip_smoke.py) imports ``tfmesos_tpu`` or a
    module of it, by statement or by string, jax-free modules included
    (the port keeps its own copies)."""
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    checked = {".".join(f.relative_to(ROOT).with_suffix("").parts)
               for f in files}
    assert {n if n in checked else n + ".__init__"
            for n in FRONT_DOOR} <= checked
    bad = {str(f.relative_to(ROOT)): sorted(set(_jax_package_names(f)))
           for f in files}
    assert not {k: v for k, v in bad.items() if v}
    probe = ROOT / "tests" / "test_torch_replica.py"
    assert "tfmesos_tpu.fleet.client" in set(_jax_package_names(probe))


def test_no_port_file_names_the_native_library_of_the_jax_package():
    """The port's log pump is pure Python: no port file (nor
    chip_smoke.py) loads or names the JAX package's native build."""
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert not [str(f.relative_to(ROOT)) for f in files
                if "tfmesos_tpu/native/" in f.read_text()
                or "liblogpump" in f.read_text()]


def test_train_cli_runs_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "tfmesos_tpu_torch.transformer_train",
         "--tiny", "--device", "cpu", "--steps", "10"],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "step 10: loss=" in out.stdout and "tokens/sec" in out.stdout


def test_checkpointed_training_runs_with_jax_blocked(tmp_path):
    """With JAX and the JAX package blocked, the training slice imports,
    and ``transformer_train`` trains from a token file through the
    native gather, checkpoints, resumes and saves again."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'tfmesos_tpu', 'optax', 'orbax'):\n"
        "    sys.modules[m] = None\n"
        f"for m in {TRAINING!r}:\n"
        "    __import__(m)\n"
        "import numpy as np\n"
        "from tfmesos_tpu_torch import transformer_train as tr\n"
        "from tfmesos_tpu_torch.train.data import (TokenFileDataset,\n"
        "                                          _NativeTokenGather)\n"
        "from tfmesos_tpu_torch.train.checkpoint import CheckpointManager\n"
        "d = sys.argv[1]\n"
        "TokenFileDataset.write(d + '/t.bin', np.arange(4000) % 256)\n"
        "args = ['--tiny', '--device', 'cpu', '--batch_size', '2',\n"
        "        '--seq_len', '16', '--data', d + '/t.bin',\n"
        "        '--ckpt-dir', d + '/c', '--ckpt-every', '2']\n"
        "assert tr.main(args + ['--steps', '3']) == 0\n"
        "assert tr.main(args + ['--steps', '5']) == 0\n"
        "assert _NativeTokenGather._lib is not None\n"
        "print(CheckpointManager(d + '/c').all_steps())\n")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         cwd=ROOT, env=_env(), capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "resumed from step 3" in out.stdout
    assert out.stdout.strip().splitlines()[-1] == "[3, 4, 5]"


def test_serve_cli_writes_one_jsonl_row_per_prompt():
    out = subprocess.run(
        [sys.executable, "-m", "tfmesos_tpu_torch.serve", "--tiny",
         "--device", "cpu", "--n-prompts", "4", "--new-tokens", "4"],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    rows = [json.loads(line) for line in out.stdout.splitlines()]
    assert len(rows) == 4
    assert sorted(r["rid"] for r in rows) == [0, 1, 2, 3]
    assert all(len(r["tokens"]) == 4 for r in rows)


def test_generate_cli_runs_int8_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "tfmesos_tpu_torch.generate", "--tiny",
         "--device", "cpu", "--int8", "--int8-kv", "--ragged",
         "--new-tokens", "6"],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "generated 2x6 tokens in" in out.stdout
    assert "tok/s incl. prefill" in out.stdout
    assert "ragged prompt lens:" in out.stdout


def test_serve_cli_serves_int8_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "tfmesos_tpu_torch.serve", "--tiny",
         "--device", "cpu", "--int8", "--int8-kv", "--n-prompts", "3",
         "--new-tokens", "3"],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    rows = [json.loads(line) for line in out.stdout.splitlines()]
    assert sorted(r["rid"] for r in rows) == [0, 1, 2]
    assert all(len(r["tokens"]) == 3 for r in rows)


def test_serve_cli_chunked_prefill_with_the_prefix_cache():
    out = subprocess.run(
        [sys.executable, "-m", "tfmesos_tpu_torch.serve", "--tiny",
         "--device", "cpu", "--n-prompts", "3", "--new-tokens", "3",
         "--prefill-chunk", "16", "--prefix-cache-pages", "8"],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    rows = [json.loads(line) for line in out.stdout.splitlines()]
    assert sorted(r["rid"] for r in rows) == [0, 1, 2]
    assert all(len(r["tokens"]) == 3 for r in rows)
    assert "prefix cache: {" in out.stderr


def test_kernel_sources_carry_their_note():
    """Each CUDA source names the TPU kernel it replaces, its bound and
    its design, and every source has a kernel library to build."""
    from tfmesos_tpu_torch.kernels import build

    srcs = build.sources()
    assert {p.stem for p in srcs} == {"flash_fwd", "flash_decode_paged",
                                      "flash_decode", "flash_bwd",
                                      "quant_int8"}
    for p in srcs:
        head = p.read_text()[:3000]
        assert "Replaces: tfmesos_tpu/ops/" in head
        assert "What bounds it on this card" in head
        assert "What this design does about it" in head
    assert build.build_dir().parent == build.BUILD_ROOT


def test_build_dir_follows_every_csrc_file(tmp_path, monkeypatch):
    """A change to a shared header (not compiled on its own) must move
    the build directory, as a change to a .cu does; only the .cu files
    are compiled."""
    import shutil

    from tfmesos_tpu_torch.kernels import build

    src = tmp_path / "csrc"
    shutil.copytree(build.SOURCE_DIR, src)
    monkeypatch.setattr(build, "SOURCE_DIR", src)
    before = build.build_dir()
    assert build.build_dir() == before
    header = src / "mma_bf16.cuh"
    assert header.is_file()
    header.write_text(header.read_text() + "\n// touched\n")
    after_header = build.build_dir()
    assert after_header != before
    cu = src / "flash_bwd.cu"
    cu.write_text(cu.read_text() + "\n")
    assert build.build_dir() not in (before, after_header)
    assert all(p.suffix == ".cu" for p in build.sources())
