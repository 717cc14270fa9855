#!/usr/bin/env python3
"""Compare the fp32 outputs of kernels B5 and B6 (``repro_torch``'s
``fake_quant_channels`` and ``binary_matmul``) bit for bit with another
checkout's, on one GPU.

    python3 scripts/torch_kernel_bits.py --against DIR [--out FILE]

``DIR`` is the root of another checkout (for example a parent commit
unpacked with ``git archive`` into a directory that ``.gitignore``
lists).  The script runs itself once for that checkout's
``src/repro_torch`` and once for this one's, each in its own process, so
each builds and loads its own kernels (into its own ``build/repro_torch``).
Each process draws seeded fp32 inputs on the card at the shapes that
``chip_smoke.py`` times, plus a ragged-N, a misaligned-pointer and a few
tile-width cases, runs every case once and hashes the output's bytes
(sha256).  The script prints one JSON object per case (``equal`` true or
false) and a summary line, and exits 1 if any case differs.

``--hashes SRC`` runs one side only: it prints the hashes of the
``repro_torch`` found under ``SRC`` as one JSON object.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 0

# (label, M, N): CIF10's conv5 and fc weights, gemma2-2b's stacked wg and
# unembed (as chip_smoke.py's fake_quant rows), a ragged N and an odd M
FAKE_QUANT = (("conv5", 9 * 128, 128), ("fc", 128, 10),
              ("wg", 13 * 2304, 9216), ("unembed", 2304, 256000),
              ("odd", 37, 10))
# (label, M, K, N, P): CIF10's conv0, conv1 and conv5 im2col products, the
# fc (chip_smoke.py's binary_matmul rows), one plane, and N that picks each
# tile width (16, 64, 128 with a ragged last tile)
BINARY_MATMUL = (("conv0", 512 * 32 * 32, 27, 32, 8),
                 ("conv1", 512 * 32 * 32, 288, 32, 8),
                 ("conv5", 512 * 8 * 8, 1152, 128, 8),
                 ("fc", 512, 128, 10, 8),
                 ("one_plane", 512 * 8 * 8, 1152, 128, 1),
                 ("n16", 4096, 100, 16, 3),
                 ("n64", 4096, 100, 64, 3),
                 ("n200", 4096, 100, 200, 3))


def _sha(torch, t) -> str:
    return hashlib.sha256(t.view(-1).view(torch.uint8).cpu().numpy()
                          .tobytes()).hexdigest()


def _offset(torch, shape, g, misalign):
    """A contiguous fp32 tensor whose data starts one element past a
    16-byte boundary when ``misalign``."""
    n = math.prod(shape)
    base = torch.randn(n + 1, generator=g, device="cuda")
    return (base[1:] if misalign else base[:n]).view(*shape)


def hashes(src: str) -> dict:
    sys.path.insert(0, src)
    import torch
    from repro_torch.kernels import ops
    g = torch.Generator(device="cuda").manual_seed(SEED)
    out = {}
    for label, M, N in FAKE_QUANT + (("misaligned", 1001, 130),):
        x = _offset(torch, (M, N), g, label == "misaligned")
        bits = torch.randint(0, 9, (N,), generator=g, device="cuda").float()
        bits[::16] = 32.0
        lv = torch.clamp(torch.pow(2.0, bits - 1.0) - 1.0, min=1.0)
        amax = x.abs().amax(dim=0)
        sc = torch.where(amax > 0, amax / lv, torch.ones_like(amax))
        out[f"fake_quant/{label}"] = _sha(
            torch, ops.fake_quant_channels(x, sc, lv, bits))
        del x
    for label, M, K, N, P in BINARY_MATMUL + (("misaligned", 999, 288, 32,
                                                 8),):
        x = _offset(torch, (M, K), g, label == "misaligned")
        planes = (torch.randint(0, 2, (P, K, N), generator=g, device="cuda")
                  * 2 - 1).to(torch.int8)
        alpha = torch.rand((P, N), generator=g, device="cuda") / math.sqrt(K)
        out[f"binary_matmul/{label}"] = _sha(
            torch, ops.binary_matmul(x, planes, alpha))
        del x, planes
    torch.cuda.synchronize()
    return out


def _side(root: str) -> dict:
    src = os.path.join(os.path.abspath(root), "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        raise SystemExit(f"no src/repro_torch under {root}")
    res = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--hashes", src], capture_output=True, text=True)
    if res.returncode != 0:
        sys.stderr.write(res.stdout + res.stderr)
        raise SystemExit(f"the run for {root} failed ({res.returncode})")
    return json.loads(res.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", help="root of the checkout to compare with")
    ap.add_argument("--hashes", help="print the hashes of SRC's repro_torch")
    ap.add_argument("--out", help="also write the comparison to this file")
    args = ap.parse_args(argv)
    if args.hashes:
        print(json.dumps(hashes(args.hashes)))
        return 0
    if not args.against:
        ap.error("give --against DIR or --hashes SRC")
    theirs, ours = _side(args.against), _side(ROOT)
    rows = [dict(case=k, equal=theirs[k] == ours[k], theirs=theirs[k],
                 ours=ours[k]) for k in ours]
    for r in rows:
        print(json.dumps(r))
    differ = [r["case"] for r in rows if not r["equal"]]
    summary = dict(cases=len(rows), differing=differ, against=args.against)
    print(json.dumps(summary))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(rows=rows, **summary), f, indent=1)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
