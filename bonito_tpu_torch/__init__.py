"""
bonito_tpu_torch — the PyTorch/CUDA port of bonito_tpu for NVIDIA Hopper.

Plain tensor code is PyTorch; every kernel that bonito_tpu wrote in Pallas
for the TPU is a CUDA C++ kernel written by hand for sm_90a (``csrc/``),
built with nvcc at first use and bound with ctypes (``ops/build.py``).
Each kernel's wrapper keeps a plain PyTorch version beside it, which is
what a tensor on the CPU runs; a tensor on the card launches the kernel
or raises.

Entry points (``util.load_model``, ``crf.basecall.basecall``) run on CUDA
unless the caller passes ``device="cpu"``. Activations keep bonito_tpu's
[N, T, C] layout at public functions, so the two packages compare like
with like.

The package imports torch where it is used, not here: the basecaller's
reader processes import only the readers (numpy), and torch's import cost
each of them seconds.
"""

__version__ = "0.1.0"


def resolve_device(device=None):
    """The torch.device an entry point runs on. ``None`` means the card;
    with no card that raises — nothing falls back to the CPU on its own."""
    import torch
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "bonito_tpu_torch runs on a CUDA device and none is "
                "available; pass device='cpu' for the plain PyTorch path")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           f"available")
    return device
