"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU. Asking
for a card where there is none raises: the port never drops to the CPU on
its own. On the CPU every kernel wrapper runs its plain PyTorch version,
because the tensors it is given lie there.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = "cuda"
                   ) -> torch.device:
    """`None` and "cuda" mean the current card; "cpu" is taken only when
    asked for. Raises RuntimeError when a card is asked for and none is
    visible."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "opensearch_tpu_torch needs a CUDA device and none is "
                "available; pass device='cpu' to run the plain PyTorch "
                "versions of the kernels on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device [{dev}] (expected cuda or cpu)")
