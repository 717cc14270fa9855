"""Training launcher (port of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \
        --smoke --steps 20 [--device cpu]

--smoke runs the reduced same-family config; without it the published
config.  The step runs on ``--device`` (the card by default).  The batches
are the reference's numpy draws (:func:`make_data_fn`): a TokenStream
batch, with frame embeddings in place of tokens for the audio front end and
image embeddings beside the tokens for the vision front end.
"""
import argparse
import tempfile

import numpy as np

from repro_torch.configs import get
from repro_torch.data import TokenStream
from repro_torch.models import LM
from repro_torch.optim import AdamW
from repro_torch.train import TrainConfig, Trainer


def make_data_fn(cfg, batch: int, seq: int):
    """``data_fn(step)`` -> a numpy batch, the reference launcher's draws:
    ``TokenStream(vocab).batch(step, batch, seq)``; for ``audio_stub``
    ``{"embeds": (batch, seq, d_model) f32 normal from default_rng(step),
    "labels"}``; for ``vision_stub`` the tokens and labels plus
    ``"img_embeds"`` (batch, n_img_tokens, d_model) f32 from the same
    generator."""
    stream = TokenStream(vocab=cfg.vocab)

    def data_fn(step):
        b = stream.batch(step, batch, seq)
        if cfg.frontend == "audio_stub":
            rng = np.random.default_rng(step)
            return {"embeds": rng.normal(size=(batch, seq, cfg.d_model)
                                         ).astype("f4"),
                    "labels": b["labels"]}
        if cfg.frontend == "vision_stub":
            rng = np.random.default_rng(step)
            b["img_embeds"] = rng.normal(
                size=(batch, cfg.n_img_tokens, cfg.d_model)).astype("f4")
        return b

    return data_fn


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--state-bits", type=int, default=32, choices=[8, 32])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    spec = get(args.arch)
    cfg = spec.smoke if args.smoke else spec.config
    model = LM(cfg)
    params = model.init(0, device=args.device)
    ckpt = args.ckpt or tempfile.mkdtemp(prefix=f"{args.arch}_ckpt_")
    trainer = Trainer(model, params, AdamW(lr=1e-3,
                                           state_bits=args.state_bits),
                      make_data_fn(cfg, args.batch, args.seq), ckpt,
                      TrainConfig(total_steps=args.steps,
                                  ckpt_every=max(args.steps // 2, 1),
                                  lr=1e-3, log_every=max(args.steps // 5, 1)),
                      device=args.device)
    out = trainer.run()
    for h in out["history"]:
        print(f"step {h['step']:5d} loss {h['loss']:.4f} "
              f"gnorm {h['grad_norm']:.3f}")
    print(f"checkpoints in {ckpt}")
    return out


if __name__ == "__main__":
    main()
