"""The port's device rule: device=None means the card, and a missing card
raises.  The CPU runs only when the caller names it."""

import torch


def resolve_device(device) -> torch.device:
    """device=None means the card; a missing card raises (the CPU runs only
    when the caller names it)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "plain versions on the CPU")
    return dev
