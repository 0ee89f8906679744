"""The device an entry point runs on, and the fp32 precision it runs at.

The port is held against the JAX package's fp32 at full precision, so
every entry point resolves its device here: fp32 matmuls (cuBLAS) and
convolutions (cuDNN) then run in IEEE fp32, never in TF32, which PyTorch
allows for cuDNN convolutions by default.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch


def full_fp32() -> None:
    """Turn TF32 off for cuBLAS and cuDNN, through the ``allow_tf32`` flags
    and, where this torch has it, the ``fp32_precision`` API. The settings
    are process-wide and govern CUDA work only."""
    backends = torch.backends
    backends.cuda.matmul.allow_tf32 = False
    backends.cudnn.allow_tf32 = False
    for api in (backends.cuda.matmul, backends.cudnn, getattr(backends.cudnn, "conv", None),
                getattr(backends.cudnn, "rnn", None)):
        if api is not None and hasattr(api, "fp32_precision"):
            api.fp32_precision = "ieee"


def tf32_enabled() -> bool:
    """True if cuBLAS or cuDNN may run fp32 work in TF32."""
    return torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN held to its deterministic algorithms inside the block; its flag
    is restored after. On an H100, cuDNN's default choice for a transposed
    convolution's forward and for the backward of every convolution (the
    dgrad and wgrad of ``Conv2d`` and ``ConvTranspose2d``) sums in an order
    that changes from run to run, so two forwards or two training steps of
    one input differ in their last bits (``scripts/torch_forward_spread.py``
    and ``scripts/torch_backward_spread.py`` name the calls)."""
    cudnn = torch.backends.cudnn
    saved, cudnn.deterministic = cudnn.deterministic, True
    try:
        yield
    finally:
        cudnn.deterministic = saved


@contextlib.contextmanager
def deterministic_algorithms():
    """``torch.use_deterministic_algorithms(True)`` inside the block; the
    mode before it (and its warn-only flag) is restored after. Hold it for
    single calls whose default kernel sums in a changing order, such as
    ``index_put_(accumulate=True)``: with atomics on CUDA's default path
    and threads on the CPU's; in this mode both add each index's terms in
    a fixed order."""
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])


def rank_device(base, local_rank: int) -> torch.device:
    """The device of the rank with index ``local_rank`` on its host:
    ``cuda:{local_rank}`` for a CUDA ``base``, else the CPU."""
    return torch.device("cuda", local_rank) if torch.device(base).type == "cuda" \
        else torch.device("cpu")


def resolve_device(name, local_rank: Optional[int] = None) -> torch.device:
    """``torch.device(name)``, with fp32 at full precision (``full_fp32``);
    given the ``local_rank`` of a data-parallel rank, a CUDA device is the
    card of that index on this host (``cuda:{local_rank}``), the CPU stays
    the CPU. A CUDA device raises when CUDA is absent, or when the card is
    not there: no entry point falls back to the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: CUDA is not available")
    if local_rank is not None and device.type == "cuda":
        if local_rank >= torch.cuda.device_count():
            raise RuntimeError(f"rank {local_rank} of this host: only "
                               f"{torch.cuda.device_count()} CUDA device(s) are visible")
        device = rank_device(device, local_rank)
    full_fp32()
    return device
