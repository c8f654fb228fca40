#!/usr/bin/env python3
"""NTT grid-size study of the port: B1 + B2 time per transform against the
limb count M, and a chunked M = 50.

    python3 scripts/bench_ntt_grid_torch.py [--out FILE]

The counterpart of scripts/bench_ntt_grid.py at set B (N = 2^16): for M
in 4, 8, 16, 24, 35, 50, 60 limbs (the first min(M, 45) main primes, then
specials, as the JAX script takes them), one iNTT then one NTT of [M, 256,
256] residues (B2 then B1, `ntt(intt(x, nb), nb)`), device time of the
pair (CUDA-graph replay, benchlib.device_ms) over 2M, in µs per
transform; then at M = 50 the same pair run as chunks of 8, 16 and 25
limbs, one launch pair a chunk. Each basis's B1 and B2 are first checked
bit for bit against their plain versions. Prints the card's name and
power limit, then one JSON line with the JAX script's keys (written to
--out too when given). Needs the card; imports no JAX and nothing of the
JAX package.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

MS = (4, 8, 16, 24, 35, 50, 60)
CHUNKS = (8, 16, 25)
N_MAIN = 45  # set B's main primes; rows from 45 on are specials


def grid_rows(M: int):
    """The JAX script's rows of an M-limb basis: mains, then specials."""
    return tuple(range(min(M, N_MAIN))) + tuple(
        range(N_MAIN, N_MAIN + max(0, M - N_MAIN)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the JSON line here")
    args = ap.parse_args()

    import torch

    from homulator_tpu_torch import benchlib, kernels
    from homulator_tpu_torch.context import DeviceContext
    from homulator_tpu_torch.ops.ntt import intt, intt_plain, ntt, ntt_plain
    from homulator_tpu_torch.params import get_params

    if not torch.cuda.is_available():
        raise SystemExit("bench_ntt_grid_torch: needs a CUDA card")
    kernels.build()
    kernels.load()
    card = benchlib.card_line()
    print(card, flush=True)
    dc = DeviceContext(get_params(n=1 << 16, max_level=45, alpha=15),
                       device="cuda")
    n1, n2 = dc.params.ntt.n1, dc.params.ntt.n2

    def checked(x, nb):
        if not (torch.equal(intt(x, nb), intt_plain(x, nb, 1))
                and torch.equal(ntt(x, nb), ntt_plain(x, nb, 1))):
            raise AssertionError(f"B1/B2 on {nb.q.shape[0]} limbs != plain")

    out = {"card": card}
    for M in MS:
        nb = dc.ntt_basis(grid_rows(M))
        x = benchlib.residues(nb.q, (M, n2, n1), rng=M)
        checked(x, nb)
        ms = benchlib.device_ms(lambda: ntt(intt(x, nb), nb))
        out[f"M{M}_us_per_transform"] = round(1e3 * ms / (2 * M), 3)
        print(f"M={M:3d}  {out[f'M{M}_us_per_transform']:7.3f} us/transform",
              flush=True)
    M = 50
    rows = grid_rows(M)
    x = benchlib.residues(dc.ntt_basis(rows).q, (M, n2, n1), rng=0)
    for chunk in CHUNKS:
        parts = [(i, dc.ntt_basis(rows[i:i + chunk]))
                 for i in range(0, M, chunk)]
        for i, nb in parts:
            checked(x[i:i + nb.q.shape[0]], nb)

        def fn(parts=parts):
            return torch.cat([ntt(intt(x[i:i + nb.q.shape[0]], nb), nb)
                              for i, nb in parts])

        key = f"M50_chunk{chunk}_us_per_transform"
        out[key] = round(1e3 * benchlib.device_ms(fn) / (2 * M), 3)
        print(f"M=50 chunk={chunk:3d}  {out[key]:7.3f} us/transform",
              flush=True)
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
