#!/usr/bin/env python3
"""
How far one sup batch through the attention and pin kernels (P, 18 x K)
drifts from the same batch through their plain versions, over several
random models.

    python3 scripts/sup_drift.py [seed ...]        (default: 1 2 3)

from the root of a checkout, on a machine with a CUDA card. For each seed
it builds the shipped sup model with random weights (as chip_smoke.py
does: CRF weight x SUP_CRF_SCALE, BatchNorm folded), draws one batch of
128 x 12000 samples from the same seed and, in bf16 and on an f32 copy,
prints the max and mean absolute difference of the move scores and the
share of frames on which the two decodes agree. chip_smoke.py's limits
(SUP_MOVES_*, SUP_MIN_EQUAL, SUP_F32_*) are held against this band.
"""

import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402
from bonito_tpu_torch import nn  # noqa: E402
from bonito_tpu_torch.models import MODELS  # noqa: E402
from bonito_tpu_torch.ops import decode as ops_decode  # noqa: E402
from bonito_tpu_torch.transformer.model import Model  # noqa: E402


def main():
    if not torch.cuda.is_available():
        raise SystemExit("sup_drift: no CUDA device")
    seeds = [int(a) for a in sys.argv[1:]] or [1, 2, 3]
    print(f"card: {chip_smoke.card_line()}")
    for seed in seeds:
        cfg = MODELS[chip_smoke.SUP]()
        bc = cfg["basecaller"]
        signal = np.random.default_rng(seed).normal(
            size=(bc["batchsize"], bc["chunksize"])).astype(np.float32)
        x = torch.from_numpy(signal).to("cuda")[..., None]
        for half in (True, False):
            model = Model(cfg).init(seed)
            with torch.no_grad():
                model.encoder.crf.w.mul_(chip_smoke.SUP_CRF_SCALE)
            nn.fuse_bn(model.encoder)
            if half:
                model.to_bf16()
            model.to("cuda")
            with torch.inference_mode():
                mv_k, mv_p, blank, worst, mean, launches = (
                    chip_smoke.moves_kernels_vs_plain(
                        torch, model, x.to(model.compute_dtype)))
                n_diff, n_all, out = chip_smoke.decodes_differ(
                    torch, model, mv_k, mv_p, blank, ops_decode,
                    qscale=1.05, qbias=1.3)
            print(f"seed {seed} {'bf16' if half else 'f32'}: launches "
                  f"{launches}; moves max |diff| {worst:.3g}, mean "
                  f"{mean:.3g}; decodes agree on {1 - n_diff / n_all:.5f} "
                  f"({n_diff} of {n_all} frames differ); "
                  f"{out['moves'].float().mean().item():.3f} of frames emit",
                  flush=True)
            del model, mv_k, mv_p, out
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
