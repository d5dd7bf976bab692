"""The device the port runs on, always named by the caller."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``"cuda"`` (or ``"cuda:N"``) or ``"cpu"`` as a :class:`torch.device`;
    ``"cuda"`` names the current card by its index, as the tensors made on
    it report their device.

    There is no automatic fallback: asking for CUDA on a machine without a
    usable card raises, so a run can never measure the CPU while it claims
    to measure the card."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() "
                "is false"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev
