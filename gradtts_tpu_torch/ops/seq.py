"""Sequence utilities: masks, duration -> alignment paths, duration loss.

Counterpart of gradtts_tpu/ops/seq.py:16-47, on time-major [B, T] masks.
"""

import torch


def sequence_mask(lengths: torch.Tensor, max_length: int) -> torch.Tensor:
    """[B] lengths -> [B, max_length] bool mask (True inside the sequence)."""
    pos = torch.arange(max_length, device=lengths.device, dtype=lengths.dtype)
    return pos[None, :] < lengths[:, None]


def generate_path(duration: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """[B, Tx] durations, [B, Tx, Ty] mask -> [B, Tx, Ty] binary path where
    row x covers frames [cumsum[x-1], cumsum[x])."""
    t_y = mask.shape[-1]
    cum = torch.cumsum(duration, dim=1)
    pos = torch.arange(t_y, device=cum.device, dtype=cum.dtype)
    path = (pos[None, None, :] < cum[:, :, None]).to(mask.dtype)
    path = path - torch.nn.functional.pad(path, (0, 0, 1, 0))[:, :-1]
    return path * mask


def duration_loss(logw: torch.Tensor, logw_hat: torch.Tensor,
                  lengths: torch.Tensor, n_tokens=None) -> torch.Tensor:
    """MSE between log-durations, normalized by the total token count
    (``duration_loss`` :44): ``n_tokens``, the global batch's where this
    process holds a part of it (:47 counts the global batch's under its
    mesh), or ``sum(lengths)`` where None."""
    if n_tokens is None:
        n_tokens = torch.sum(lengths)
    return torch.sum((logw - logw_hat) ** 2) / n_tokens
