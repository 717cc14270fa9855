"""In a fresh interpreter: a whole run loads neither JAX nor the JAX
package, and the references load nothing of the program."""
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _fresh(code: str) -> set:
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": f"{ROOT}:{ROOT / 'src'}"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    code = (
        "import io, contextlib, json, sys\n"
        "from bench.tests import smoke\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
        "    for cell in ('granite-chat', 'mamba2-docs'):\n"
        "        smoke.run(cell, seconds=1.0, trace=1)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    tops = _fresh(code)
    assert "repro_torch" in tops
    assert not tops & FORBIDDEN, tops & FORBIDDEN


def test_references_load_no_program():
    code = (
        "import json, sys\n"
        "import bench.reference.transformer, bench.reference.mamba2\n"
        "import bench.reference.quant\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    tops = _fresh(code)
    assert not tops & (FORBIDDEN | {"repro_torch"}), tops
