"""No fallback: without a CUDA device `chip_smoke.py` fails and prints no
result, in the repo and alone in a directory; and the port imports no jax
and nothing of the JAX package."""

import os
import re
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "datafusion_parallelism_tpu_torch")


def _run(args, cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_a_gpu(where, tmp_path):
    cwd = ROOT
    if where == "alone":
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    proc = _run(["chip_smoke.py"], cwd)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert '"kernels"' not in proc.stdout


def test_session_without_a_gpu_raises():
    """SessionContext() defaults to the card: with none visible it raises,
    and no query runs on the CPU in its place."""
    code = ("import datafusion_parallelism_tpu_torch as p\n"
            "try:\n"
            "    ctx = p.SessionContext()\n"
            "except RuntimeError as e:\n"
            "    print('raised:', e)\n"
            "else:\n"
            "    ctx.register_pydict('t', {'x': [1, 2, 3]})\n"
            "    print('collected:', ctx.sql('SELECT sum(x) AS s FROM t').collect().to_pylist())\n")
    proc = _run(["-c", code], ROOT)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("raised:") and "no CUDA device" in proc.stdout
    assert "collected" not in proc.stdout


def test_port_imports_no_jax():
    code = ("import sys, importlib, pkgutil, datafusion_parallelism_tpu_torch as p\n"
            "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
            "    importlib.import_module(m.name)\n"
            "import chip_smoke\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'datafusion_parallelism_tpu')]\n"
            "assert not bad, bad\n")
    proc = _run(["-c", code], ROOT)
    assert proc.returncode == 0, proc.stderr


def test_port_sources_name_no_jax_import():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|datafusion_parallelism_tpu)\b", re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PORT):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    for path in files:
        with open(path) as f:
            assert not pattern.search(f.read()), path
