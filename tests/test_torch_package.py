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
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 10


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
    bad = {str(f.relative_to(ROOT)): sorted(FORBIDDEN & set(
        _imported_roots(f))) for f in files}
    assert not {k: v for k, v in bad.items() if v}


def test_train_cli_runs_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "tfmesos_tpu_torch.transformer_train",
         "--tiny", "--device", "cpu", "--steps", "10"],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "step 10: loss=" in out.stdout and "tokens/sec" in out.stdout


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
