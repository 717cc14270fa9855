"""Serving launcher (port of ``repro/launch/serve.py``): batched
generation with an optional uniform AutoQ policy.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \
        --smoke --bits 8 --n-new 32 [--device cpu] [--attn-impl ref]

Runs on ``--device`` (the card by default), attention on the CUDA kernels
unless ``--attn-impl ref`` asks for the plain version.  Token prompts
only: the audio front end is refused here, as in the reference, and the
engine refuses the vision front end (both run through ``LM.prefill`` /
``LM.decode_step``).
"""
import argparse

from repro_torch.configs import get
from repro_torch.data import TokenStream
from repro_torch.models import LM
from repro_torch.quant.policy import QuantPolicy
from repro_torch.serve import ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--bits", type=float, default=0,
                    help="uniform weight QBN (0 = full precision)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--n-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--attn-impl", choices=("cuda", "ref"), default="cuda",
                    help="attention backend (ref = the plain version)")
    ap.add_argument("--kv-bits", type=int, default=0,
                    help="8 = int8 KV cache (dense and paged)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    spec = get(args.arch)
    cfg = spec.smoke if args.smoke else spec.config
    if cfg.frontend == "audio_stub":
        raise SystemExit("audio_stub archs need frame embeddings; drive "
                         "LM.prefill / LM.decode_step with batch['embeds']")
    model = LM(cfg)
    params = model.init(0, device=args.device)

    policy = graph = None
    if args.bits > 0:
        graph = model.graph(seq_len=args.prompt_len, batch=args.batch)
        policy = QuantPolicy.uniform(graph, args.bits)

    eng = ServeEngine(model, params, policy=policy, graph=graph,
                      max_len=args.prompt_len + args.n_new,
                      attn_impl=args.attn_impl,
                      kv_bits=args.kv_bits or None, device=args.device)
    prompts = TokenStream(vocab=cfg.vocab).batch(
        0, args.batch, args.prompt_len)["tokens"]
    out = eng.generate(prompts, n_new=args.n_new,
                       temperature=args.temperature)
    s = out["stats"]
    print(f"prefill {s.prefill_s*1e3:.1f} ms | decode "
          f"{s.decode_tok_per_s:.1f} tok/s | {s.tokens_out} tokens")
    print("sample:", out["tokens"][0][:24].tolist())
    return out


if __name__ == "__main__":
    main()
