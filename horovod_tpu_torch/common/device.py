"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``, as the tests do).  With no card and no explicit
choice they raise: a serving or training run that quietly fell back to
the CPU would report CPU numbers under a GPU's name.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The ``torch.device`` an entry point should run on.

    ``None`` means the first CUDA card, and raises ``RuntimeError`` when
    there is none.  An explicit device is returned as is (a CUDA device
    that does not exist raises as well)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU through the kernels' plain PyTorch versions")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but no CUDA device "
                           f"is available")
    return dev
