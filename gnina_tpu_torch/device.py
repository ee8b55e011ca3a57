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


def device_from_flag(spec) -> torch.device:
    """A command line's --device: None is the card, a bare number gnina's
    GPU index, anything else a torch device name ('cpu', 'cuda:1')."""
    if spec is not None and str(spec).strip().isdigit():
        spec = f"cuda:{int(spec)}"
    return resolve_device(spec)
