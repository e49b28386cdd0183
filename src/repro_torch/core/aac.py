"""Activity-Aware Coreset construction (AAC — paper §5.2).

PyTorch counterpart of :mod:`repro.core.aac`.  :func:`select_k` works on
one node (0-d ``pred_class``/``energy_uj``) or a fleet (``(N,)``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .coreset import cluster_payload_bytes

__all__ = ["AACTable", "make_aac_table", "select_k", "aac_payload_bytes"]


class AACTable(NamedTuple):
    """``acc``: (n_classes, n_k) accuracy estimate per (class, k-index).
    ``ks``: (n_k,) int32 cluster counts the table indexes (ascending)."""

    acc: torch.Tensor
    ks: torch.Tensor


def make_aac_table(acc, ks, device=None) -> AACTable:
    ks = torch.as_tensor(ks, dtype=torch.int32, device=device)
    acc = torch.as_tensor(acc, dtype=torch.float32, device=device)
    if acc.shape[-1] != ks.shape[0]:
        raise ValueError(f"acc has {acc.shape[-1]} k columns, ks has "
                         f"{ks.shape[0]} entries")
    return AACTable(acc=acc, ks=ks)


def _cluster_energy_uj(k: torch.Tensor, base_cost: float, tx_per_byte: float,
                       bytes_center: int = 2,
                       bytes_radius: int = 1) -> torch.Tensor:
    """Energy of building + transmitting a k-cluster coreset."""
    kf = k.to(torch.float32)
    payload = kf * (bytes_center + bytes_radius) + torch.ceil(kf / 2.0)
    return base_cost * kf / 12.0 + tx_per_byte * payload


def select_k(table: AACTable, pred_class: torch.Tensor,
             energy_uj: torch.Tensor, acc_tol: float = 0.02,
             base_cost: float = 1.07, tx_per_byte: float = 0.38,
             class_aware: bool = True) -> torch.Tensor:
    """Smallest ``k`` whose accuracy is within ``acc_tol`` of the row's best
    and whose energy fits ``energy_uj``; the cheapest ``k`` when none does.
    Returns int32 with the shape of ``energy_uj``."""
    if class_aware:
        row = table.acc[pred_class.long()]                 # (..., n_k)
    else:
        row = table.acc.min(dim=0).values.expand(
            energy_uj.shape + table.ks.shape)
    best = row.max(dim=-1, keepdim=True).values
    acc_ok = row >= best - acc_tol
    cost = _cluster_energy_uj(table.ks, base_cost, tx_per_byte)
    energy_ok = cost <= energy_uj[..., None]
    ok = acc_ok & energy_ok
    # first True (ks ascending); argmax returns the first maximum
    idx = torch.argmax(ok.to(torch.int32), dim=-1)
    any_ok = ok.any(dim=-1)
    return torch.where(any_ok, table.ks[idx], table.ks[0])


def aac_payload_bytes(ks) -> torch.Tensor:
    """Payload bytes of a trace of selected k values, int32 (the paper's
    2 B center, 1 B radius and 4-bit count per cluster)."""
    ks = torch.as_tensor(ks)
    return torch.tensor([cluster_payload_bytes(int(k)) for k in ks.reshape(-1)],
                        dtype=torch.int32, device=ks.device)
