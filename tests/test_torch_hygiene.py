"""Import and fallback guards of the PyTorch port.

* No file of ``src/repro_torch`` and not ``chip_smoke.py`` imports JAX or
  the reference package (an AST scan), and importing every port module in
  a fresh interpreter leaves ``jax`` out of ``sys.modules``.
* Entry points run on the card by default: without CUDA and without
  ``device="cpu"`` they raise and name the opt-in, never carrying on
  quietly on the CPU (the LM, the serving engine, the CNN, the DDPG
  controllers, both search agents, the Trainer, the QAT loss and a
  checkpoint's restore).
* Kernel wrappers run their plain versions only on CPU tensors, without
  counting a launch, and refuse tensors on any other non-CUDA device.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
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


def test_scan_covers_the_serving_modules():
    """The scan sees the serving modules and, since the search slice, the
    search modules; since the training slice, the optimizer, the training
    loop, checkpoints, QAT and the roofline models."""
    names = {str(p.relative_to(PORT)) for p in _port_files()
             if PORT in p.parents}
    core = ("__init__", "ddpg", "reward", "bound", "env", "agent", "flat",
            "search", "evaluate", "roofline")
    train = ("optim/__init__.py", "optim/adam.py", "optim/schedule.py",
             "train/__init__.py", "train/checkpoint.py", "train/loop.py",
             "train/qat.py")
    for mod in ("serve/paged_kv.py", "serve/scheduler.py",
                "serve/frontend.py", "serve/step_loop.py",
                "serve/engine.py", "kernels/attention.py",
                "kernels/fake_quant.py", "kernels/binary_matmul.py",
                "models/cnn.py", "quant/binarize.py", "data/synthetic.py",
                "data/__init__.py") + train + \
            tuple(f"core/{m}.py" for m in core):
        assert mod in names


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


def test_entry_points_require_cuda_unless_cpu_is_asked(monkeypatch,
                                                       tmp_path):
    from repro_torch.configs import ARCHS
    from repro_torch.models import LM
    from repro_torch.serve import ServeEngine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = LM(ARCHS["gemma2-2b"].smoke)
    params = model.init(0, device="cpu")
    from repro_torch.core import (DDPG, DDPGConfig, FlatAgent,
                                  HierarchicalAgent, QuantEnv, RewardCfg)
    from repro_torch.models.cnn import CNN, CNNConfig
    cnn = CNN(CNNConfig(name="t", img_size=8, channels=(4,), pool_after=()))
    cnn_params = cnn.init(0, device="cpu")
    env = QuantEnv(cnn.graph(), cnn_params, lambda policy: 50.0,
                   RewardCfg.accuracy_guaranteed())
    from repro_torch.optim import AdamW
    from repro_torch.quant.policy import QuantPolicy
    from repro_torch.train import CheckpointManager, Trainer
    from repro_torch.train.qat import make_qat_loss
    ckpt_dir = tmp_path
    CheckpointManager(ckpt_dir).save(1, {"x": torch.zeros(2)})

    def trainer(**kw):
        return Trainer(cnn, cnn_params, AdamW(), lambda step: {},
                       str(ckpt_dir / "t"), **kw)
    for call in (lambda: model.init(0),
                 lambda: model.init_cache(1, 8),
                 lambda: model.init_paged_cache(2, 5, 4),
                 lambda: model.init_paged_cache(2, 5, 4, device="cuda"),
                 lambda: ServeEngine(model, {}),
                 lambda: ServeEngine(model, params, device="cuda"),
                 lambda: cnn.init(0),
                 lambda: DDPG(DDPGConfig(state_dim=3, action_dim=1)),
                 lambda: HierarchicalAgent(env),
                 lambda: FlatAgent(env, device="cuda"),
                 lambda: trainer(),
                 lambda: trainer(device="cuda"),
                 lambda: make_qat_loss(cnn, cnn.graph(), QuantPolicy.uniform(
                     cnn.graph(), 4.0)),
                 lambda: CheckpointManager(ckpt_dir).restore(
                     {"x": torch.zeros(2)})):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
    assert cnn_params["conv0"]["w"].device.type == "cpu"
    assert trainer(device="cpu").params["conv0"]["w"].device.type == "cpu"
    agent = HierarchicalAgent(env, device="cpu")
    assert agent.llc.state["actor"][0]["w"].device.type == "cpu"
    log, _ = agent.run_episode(noise=0.5)
    assert np.isfinite(log.reward)
    assert params["embed"].device.type == "cpu"
    eng = ServeEngine(model, params, max_len=8, device="cpu")
    assert eng.device.type == "cpu"
    pool = model.init_paged_cache(2, 5, 4, device="cpu")
    assert pool[0]["k"].device.type == "cpu"
    # run() serves on the CPU only because the engine was asked to
    out = eng.run([(np.arange(3, dtype=np.int32), 2)], page_size=4,
                  max_slots=2)
    assert out["outputs"][0].shape == (2,)


def test_wrappers_run_plain_versions_only_on_cpu_tensors():
    """CPU tensors take the plain version without counting a launch; a
    tensor on any other non-CUDA device is refused, not redirected."""
    from repro_torch import kernels
    from repro_torch.kernels.ops import quant_matmul
    from repro_torch.kernels.attention import paged_prefill_attention
    kernels.reset_launch_counts()
    x = torch.randn(3, 8)
    qw = torch.randint(-5, 5, (8, 4), dtype=torch.int8)
    s = torch.rand(4)
    quant_matmul(x, qw, s)
    q = torch.randn(2, 3, 4, 8)
    pages = torch.randn(5, 4, 2, 8)
    pos = torch.full((5, 4), 2**31 - 1, dtype=torch.int32)
    pos[1] = torch.arange(4, dtype=torch.int32)
    bt = torch.tensor([[1, 0], [0, 0]], dtype=torch.int32)
    q_pos = torch.tensor([[1, 2, 3], [2**31 - 1] * 3], dtype=torch.int32)
    out = paged_prefill_attention(q, pages, pages, pos, bt, q_pos=q_pos)
    assert out.shape == q.shape
    from repro_torch.kernels.ops import binary_matmul, fake_quant_channels
    planes = torch.ones(2, 8, 4, dtype=torch.int8)
    alpha = torch.rand(2, 4)
    binary_matmul(x, planes, alpha)
    v = torch.ones(8)
    fake_quant_channels(x, v, v, v)
    assert kernels.launch_counts() == {
        "flash_attention": 0, "quant_matmul": 0, "packed_matmul": 0,
        "paged_attention": 0, "fake_quant": 0, "binary_matmul": 0}
    with pytest.raises(ValueError):
        quant_matmul(x.to("meta"), qw.to("meta"), s.to("meta"))
    with pytest.raises(ValueError, match="no kernel"):
        binary_matmul(x.to("meta"), planes.to("meta"), alpha.to("meta"))
    with pytest.raises(ValueError, match="no kernel"):
        fake_quant_channels(x.to("meta"), v.to("meta"), v.to("meta"),
                            v.to("meta"))
    with pytest.raises(ValueError, match="no kernel"):
        paged_prefill_attention(q.to("meta"), pages.to("meta"),
                                pages.to("meta"), pos.to("meta"),
                                bt.to("meta"), q_pos=q_pos.to("meta"))
    # the dispatcher hands impl="cuda" to the wrapper whatever the masks:
    # off the CPU it launches K4 or raises, never the plain version
    from repro_torch.models.layers import paged_attention
    with pytest.raises(ValueError, match="no kernel"):
        paged_attention(q.to("meta"), pages.to("meta"), pages.to("meta"),
                        pos.to("meta"), bt.to("meta"),
                        q_pos=q_pos.to("meta"), window=2, attn_cap=5.0,
                        impl="cuda")
