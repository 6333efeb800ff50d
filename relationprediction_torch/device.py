"""Device selection and float32 GEMM policy."""
from __future__ import annotations

import torch


def resolve_device(cpu: bool) -> torch.device:
    """``cpu`` if asked for, else the first CUDA card.

    Raises RuntimeError when the card is asked for and there is none: the
    port never falls back to the CPU on its own.
    """
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass cpu=True "
                           "(--cpu) to run on the CPU")
    return torch.device("cuda:0")


def exact_float32() -> None:
    """Keep float32 GEMMs and convolutions in full float32 (no TF32) on the
    card, any bf16 GEMM's sums in f32 (no reduced-precision reduction in
    cuBLAS), and cuDNN on its deterministic algorithms (a convolution's
    sums add in one order at every call).

    The JAX reference contracts in float32; TF32 keeps ~3 decimal digits,
    enough to reorder near-tied candidate scores and change ranks. Its
    bf16 products accumulate in f32 (``preferred_element_type``).
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
