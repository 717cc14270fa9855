"""The port's train / serve launchers and the quant gaps, on the CPU.

* ``launch.train.make_data_fn`` gives, step for step, the arrays of the
  reference launcher's own ``data_fn`` (captured from
  ``repro.launch.train.main`` with its Trainer stubbed out), bit for bit:
  TokenStream batches, frame embeddings for the audio front end, image
  embeddings beside the tokens for the vision front end.
* ``launch.train.main`` trains 2 ``--smoke --device cpu`` steps of both
  families to finite losses; ``launch.serve.main`` generates on
  gemma2-smoke and refuses musicgen before building anything.
* ``quant.quantize_activation`` and ``quant.policy_metrics`` equal the
  reference's: the hook bit for bit (per-tensor fake quant), the metrics
  to f64 rounding.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import repro.launch.train as jtrain  # noqa: E402
from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.models import LM as JLM  # noqa: E402
from repro.quant import apply as japply  # noqa: E402
from repro.quant.policy import QuantMode as JMode  # noqa: E402
from repro.quant.policy import QuantPolicy as JPolicy  # noqa: E402
from repro_torch import quant  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.quant.policy import QuantMode, QuantPolicy  # noqa: E402

ARCH_IDS = ["musicgen-large", "llama-3.2-vision-90b", "gemma2-2b"]


def _reference_data_fn(arch, batch, seq, tmp_path, monkeypatch):
    """The reference launcher's data_fn for ``--smoke``, taken from the
    Trainer it builds (stubbed: no step runs)."""
    got = {}

    class Capture:
        def __init__(self, model, params, opt, data_fn, *a, **k):
            got["data_fn"] = data_fn

        def run(self):
            return {"history": []}

    monkeypatch.setattr(jtrain, "Trainer", Capture)
    monkeypatch.setattr("sys.argv", [
        "train", "--arch", arch, "--smoke", "--batch", str(batch), "--seq",
        str(seq), "--ckpt", str(tmp_path)])
    jtrain.main()
    return got["data_fn"]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_make_data_fn_equals_the_reference_draws(arch, tmp_path,
                                                 monkeypatch):
    want = _reference_data_fn(arch, 2, 6, tmp_path, monkeypatch)
    got = ttrain.make_data_fn(ARCHS[arch].smoke, 2, 6)
    for step in (0, 3):
        w, g = want(step), got(step)
        assert sorted(w) == sorted(g)
        for k in w:
            assert g[k].dtype == np.asarray(w[k]).dtype
            np.testing.assert_array_equal(g[k], np.asarray(w[k]))


@pytest.mark.parametrize("arch", ["musicgen-large", "llama-3.2-vision-90b"])
def test_train_launcher_runs_two_cpu_steps(arch, tmp_path, capsys):
    out = ttrain.main(["--arch", arch, "--smoke", "--steps", "2",
                       "--batch", "2", "--seq", "8", "--device", "cpu",
                       "--ckpt", str(tmp_path)])
    losses = [h["loss"] for h in out["history"]]
    assert losses and all(np.isfinite(losses))
    assert "step" in capsys.readouterr().out
    assert any(tmp_path.iterdir())                     # a checkpoint


def test_serve_launcher_generates_on_cpu(capsys):
    out = tserve.main(["--arch", "gemma2-2b", "--smoke", "--batch", "2",
                       "--prompt-len", "6", "--n-new", "3", "--bits", "6",
                       "--device", "cpu"])
    toks = out["tokens"]
    cfg = ARCHS["gemma2-2b"].smoke
    assert toks.shape == (2, 3) and toks.min() >= 0 and \
        toks.max() < cfg.vocab
    text = capsys.readouterr().out
    assert "tok/s" in text and "sample:" in text


def test_serve_launcher_refuses_the_audio_front_end():
    with pytest.raises(SystemExit, match="frame embeddings"):
        tserve.main(["--arch", "musicgen-large", "--smoke", "--device",
                     "cpu"])


def test_quantize_activation_and_policy_metrics_match_reference():
    x = np.random.default_rng(0).standard_normal((3, 5, 16)).astype(
        np.float32)
    ctx = {"p0.wq": 4.0, "p1.wq": 8.0}
    for name in ("p0.wq", "p1.wq", "p2.wq"):
        for c in (ctx, None):
            want = np.asarray(japply.quantize_activation(jnp.asarray(x), c,
                                                         name))
            got = quant.quantize_activation(torch.from_numpy(x), c, name)
            np.testing.assert_array_equal(got.numpy(), want)
    jg = JLM(JARCHS["jamba-1.5-large-398b"].smoke).graph(seq_len=8, batch=2)
    tg = LM(ARCHS["jamba-1.5-large-398b"].smoke).graph(seq_len=8, batch=2)
    rng = np.random.default_rng(1)
    wbits = {l.name: rng.choice([0, 2, 4, 8, 16], size=l.n_groups).astype(
        np.float32) for l in jg.layers}
    abits = {l.name: float(rng.choice([4, 8, 32])) for l in jg.layers}
    want = japply.policy_metrics(jg, JPolicy(JMode.QUANT, wbits, abits))
    got = quant.policy_metrics(tg, QuantPolicy(QuantMode.QUANT, wbits,
                                               abits))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-12)
