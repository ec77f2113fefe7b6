#!/usr/bin/env python3
"""
The hac device steps (bf16 and int8, batch 96 x chunk 9996) of one checkout
of the PyTorch/CUDA port, timed as ``chip_smoke.py`` phase 7 times them
(upload, forward, decode, fetch of one prepared batch, 3 runs after a
warm-up), five times each, on the same random model and reads:

    python3 scripts/hac_device_step.py [CHECKOUT]

on a machine with a CUDA card and nvcc. CHECKOUT (the root of an unpacked
tree, by default this one) provides the package and ``chip_smoke.py``'s
helpers; its kernels are built there at first use. Run it for two trees in
turns (A, B, A, B, ...) in one call on the card to compare them outside
``chip_smoke.py``, whose phase 7 reads one batch a path after phases that
leave the card and the host in states that differ from run to run.
"""

import sys
from pathlib import Path

TREE = Path(sys.argv[1] if len(sys.argv) > 1
            else Path(__file__).resolve().parent.parent).resolve()
sys.path.insert(0, str(TREE))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from bonito_tpu_torch import checkpoint  # noqa: E402
from bonito_tpu_torch.config import save_config  # noqa: E402
from bonito_tpu_torch.crf.basecall import make_compute_fn  # noqa: E402
from bonito_tpu_torch.crf.model import Model  # noqa: E402
from bonito_tpu_torch.models import lstm_crf_config  # noqa: E402
from bonito_tpu_torch.ops import build  # noqa: E402
from bonito_tpu_torch.util import chunk, load_model  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("hac_device_step: no CUDA device", file=sys.stderr)
        return 1
    if not Path(build.__file__).resolve().is_relative_to(TREE):
        print(f"hac_device_step: the package came from {build.__file__}, "
              f"not {TREE}", file=sys.stderr)
        return 2
    build.library()
    rng = np.random.default_rng(cs.SEED)  # phase 5's hac reads
    lengths = np.concatenate([[3000, 9000], rng.integers(20000, 110000, 142)])
    reads = [cs.Read(f"read{i}", rng.normal(size=int(n)).astype(np.float32))
             for i, n in enumerate(lengths)]
    out = []
    for name, quantize in (("int8", True), ("bf16", False)):
        cfg = lstm_crf_config()
        cfg["basecaller"]["quantize"] = quantize
        model = Model(cfg).init(cs.SEED)
        _, (_, crf), _ = model.decode_head()
        with torch.no_grad():
            crf.w.mul_(cs.CRF_SCALE)
        d = build.BUILD / f"hac_device_step_{name}"
        d.mkdir(parents=True, exist_ok=True)
        save_config(cfg, d / "config.toml")
        checkpoint.save_params(d / "weights_1.npz", model)
        m = load_model(d, half=True, fuse_bn=True, quantize=None,
                       device="cuda")
        m.requires_grad_(False)
        ms = [cs.device_step(np, m, reads, make_compute_fn, chunk)[1]
              for _ in range(5)]
        out.append(f"{name} " + " ".join(f"{x:.4g}" for x in ms) + " ms")
        del m, model
        torch.cuda.empty_cache()
    print(f"{cs.card_line()}; {TREE.name}: " + "; ".join(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
