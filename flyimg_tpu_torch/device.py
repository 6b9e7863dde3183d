"""Device selection for every entry point of the package.

Entry points take ``device`` (default ``"cuda"``). Asking for CUDA on a
host without a usable card raises instead of quietly running on the CPU:
a CPU run must be asked for by name (``device="cpu"``), as the tests do.

Float32 matrix products and convolutions run in full float32 here, not
TF32: the dense resample matmuls and any convolution yardstick must keep
the reference's f32 arithmetic (TF32 keeps ~3 decimal digits, enough to
move a u8 level or flip a smart-crop near-tie).
"""

from __future__ import annotations

from typing import Union

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises ``RuntimeError`` when a
    CUDA device is asked for and none is available."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} asked for, but CUDA is not "
                "available; pass device='cpu' to run on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise RuntimeError(f"unsupported device {str(device)!r}")
    return dev
