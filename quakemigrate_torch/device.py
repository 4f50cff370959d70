# -*- coding: utf-8 -*-
"""
Device resolution for the port: every entry point takes an explicit
``device`` and passes it on; nothing reads a global default device.

"""

import torch

# Precision flags applied whenever a CUDA device is resolved. The detect
# path has no matmul or convolution, but a float32 product on the card
# must stay full float32 if one is ever added: TF32 keeps ~3 digits.
TF32_MATMUL = False
TF32_CUDNN = False


def resolve_device(device):
    """
    ``device`` (str or torch.device) -> torch.device. A CUDA device raises
    when CUDA is not available; it never degrades to the CPU. A CUDA
    device without an index gets the current one ("cuda" -> "cuda:0"),
    so it compares equal to the device of the tensors placed on it.

    """

    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device} requested but CUDA is not available"
            )
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.backends.cuda.matmul.allow_tf32 = TF32_MATMUL
        torch.backends.cudnn.allow_tf32 = TF32_CUDNN
    elif device.type != "cpu":
        raise ValueError(f"unsupported device type: {device.type!r}")
    return device
