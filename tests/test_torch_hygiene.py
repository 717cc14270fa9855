"""Import and fallback guards of the PyTorch port.

* No file of ``src/repro_torch`` and not ``chip_smoke.py`` imports JAX or
  the reference package (an AST scan), and importing every port module in
  a fresh interpreter leaves ``jax`` out of ``sys.modules``.
* Entry points run on the card by default: without CUDA and without
  ``device="cpu"`` they raise and name the opt-in, never carrying on
  quietly on the CPU.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _modules():
    mods = []
    for f in sorted(PORT.rglob("*.py")):
        rel = f.relative_to(PORT.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        mods.append(".".join(parts))
    return mods


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_port_imports_without_jax():
    code = ("import sys\n"
            f"for m in {_modules()!r}:\n"
            "    __import__(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n"
            "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_entry_points_require_cuda_unless_cpu_is_asked(monkeypatch):
    from repro_torch.configs import ARCHS
    from repro_torch.models import LM
    from repro_torch.serve import ServeEngine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = LM(ARCHS["gemma2-2b"].smoke)
    for call in (lambda: model.init(0),
                 lambda: model.init_cache(1, 8),
                 lambda: ServeEngine(model, {})):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
    params = model.init(0, device="cpu")
    assert params["embed"].device.type == "cpu"
    eng = ServeEngine(model, params, max_len=8, device="cpu")
    assert eng.device.type == "cpu"


def test_wrappers_run_plain_versions_only_on_cpu_tensors():
    """CPU tensors take the plain version without counting a launch; a
    tensor on any other non-CUDA device is refused, not redirected."""
    from repro_torch import kernels
    from repro_torch.kernels.ops import quant_matmul
    kernels.reset_launch_counts()
    x = torch.randn(3, 8)
    qw = torch.randint(-5, 5, (8, 4), dtype=torch.int8)
    s = torch.rand(4)
    quant_matmul(x, qw, s)
    assert kernels.launch_counts() == {"flash_attention": 0,
                                       "quant_matmul": 0, "packed_matmul": 0}
    with pytest.raises(ValueError):
        quant_matmul(x.to("meta"), qw.to("meta"), s.to("meta"))
