"""Metrics: PerfMetrics accumulation and streaming AUC.

PyTorch counterpart of `dlrm_flexflow_tpu/training/metrics.py`. One batch
gives a dict of tensors on the model's device; the running totals are the
same dict added up, and stay on the device until `summarize` reads them.
AUC is streaming: fixed-bin histograms of positive and negative scores,
integrated as a trapezoidal ROC curve on the host.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..ffconst import MetricsType

AUC_BINS = 8192
_EPS = 1e-7


def zero_perf_metrics(with_auc: bool = True, device="cpu") -> Dict[str, torch.Tensor]:
    z = {
        "train_all": torch.zeros((), dtype=torch.int32, device=device),
        "train_correct": torch.zeros((), dtype=torch.int32, device=device),
        "cce_loss": torch.zeros((), dtype=torch.float32, device=device),
        "sparse_cce_loss": torch.zeros((), dtype=torch.float32, device=device),
        "mse_loss": torch.zeros((), dtype=torch.float32, device=device),
        "rmse_loss": torch.zeros((), dtype=torch.float32, device=device),
        "mae_loss": torch.zeros((), dtype=torch.float32, device=device),
    }
    if with_auc:
        z["auc_pos_hist"] = torch.zeros((AUC_BINS,), dtype=torch.float32, device=device)
        z["auc_neg_hist"] = torch.zeros((AUC_BINS,), dtype=torch.float32, device=device)
    return z


def compute_perf_metrics(
    metrics: MetricsType, logits: torch.Tensor, labels: torch.Tensor, binary: bool
) -> Dict[str, torch.Tensor]:
    """One batch worth of PerfMetrics. `binary` selects 0.5-threshold
    accuracy (the reference DLRM accuracy, dlrm.cc:131-134) over argmax."""
    out = zero_perf_metrics(bool(metrics & MetricsType.METRICS_AUC_ROC), logits.device)
    logits = logits.detach().float()
    labels = labels.detach()
    b = logits.shape[0]
    out["train_all"] = torch.full((), b, dtype=torch.int32, device=logits.device)

    if metrics & MetricsType.METRICS_ACCURACY:
        if binary:
            pred = logits.reshape(b, -1)[:, 0] > 0.5
            truth = labels.reshape(b, -1)[:, 0] > 0.5
        else:
            pred = torch.argmax(logits.reshape(b, -1), dim=-1)
            lab = labels.reshape(b, -1)
            truth = lab[:, 0].long() if lab.shape[1] == 1 else torch.argmax(lab, dim=-1)
        out["train_correct"] = (pred == truth).sum().to(torch.int32)

    if metrics & MetricsType.METRICS_CATEGORICAL_CROSSENTROPY:
        lab = labels.float().reshape(logits.shape)
        out["cce_loss"] = -torch.sum(lab * torch.log(logits.clamp(_EPS, 1.0)))
    if metrics & MetricsType.METRICS_SPARSE_CATEGORICAL_CROSSENTROPY:
        idx = labels.reshape(b).long()
        p = logits.reshape(b, -1).clamp(_EPS, 1.0).gather(-1, idx[:, None])
        out["sparse_cce_loss"] = -torch.sum(torch.log(p))
    if metrics & (
        MetricsType.METRICS_MEAN_SQUARED_ERROR
        | MetricsType.METRICS_ROOT_MEAN_SQUARED_ERROR
        | MetricsType.METRICS_MEAN_ABSOLUTE_ERROR
    ):
        diff = logits - labels.float().reshape(logits.shape)
        dims = tuple(range(1, logits.dim()))
        per_sample_mse = torch.mean(diff * diff, dim=dims)
        out["mse_loss"] = torch.sum(per_sample_mse)
        out["rmse_loss"] = torch.sum(torch.sqrt(per_sample_mse))
        out["mae_loss"] = torch.sum(torch.mean(diff.abs(), dim=dims))

    if metrics & MetricsType.METRICS_AUC_ROC:
        score = logits.reshape(b, -1)[:, 0].clamp(0.0, 1.0 - 1e-6)
        lab = labels.float().reshape(b, -1)[:, 0]
        bins = (score * AUC_BINS).to(torch.int64)
        out["auc_pos_hist"].index_add_(0, bins, lab)
        out["auc_neg_hist"].index_add_(0, bins, 1.0 - lab)
    return out


def accumulate(total: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Fold one step into the running totals, in place."""
    for k, v in batch.items():
        total[k] += v
    return total


def auc_from_histograms(pos_hist, neg_hist) -> float:
    """Trapezoidal ROC-AUC from score histograms. With scores descending,
    AUC = sum over bins of TPR-average * FPR-increment."""
    pos = np.asarray(pos_hist, np.float64)[::-1]  # high score first
    neg = np.asarray(neg_hist, np.float64)[::-1]
    p, n = pos.sum(), neg.sum()
    if p == 0 or n == 0:
        return 0.5
    tpr = np.concatenate([[0.0], np.cumsum(pos) / p])
    fpr = np.concatenate([[0.0], np.cumsum(neg) / n])
    return float(np.trapezoid(tpr, fpr))


def summarize(total: Dict[str, torch.Tensor], metrics: MetricsType) -> Dict[str, float]:
    """Host-side report (reference: PerfMetrics::print, metrics_functions.cc:47)."""
    host = {k: v.cpu().numpy() for k, v in total.items()}
    n = max(int(host["train_all"]), 1)
    out: Dict[str, float] = {"samples": float(n)}
    if metrics & MetricsType.METRICS_ACCURACY:
        out["accuracy"] = float(host["train_correct"]) / n
    if metrics & MetricsType.METRICS_CATEGORICAL_CROSSENTROPY:
        out["cce"] = float(host["cce_loss"]) / n
    if metrics & MetricsType.METRICS_SPARSE_CATEGORICAL_CROSSENTROPY:
        out["sparse_cce"] = float(host["sparse_cce_loss"]) / n
    if metrics & MetricsType.METRICS_MEAN_SQUARED_ERROR:
        out["mse"] = float(host["mse_loss"]) / n
    if metrics & MetricsType.METRICS_ROOT_MEAN_SQUARED_ERROR:
        out["rmse"] = float(host["rmse_loss"]) / n
    if metrics & MetricsType.METRICS_MEAN_ABSOLUTE_ERROR:
        out["mae"] = float(host["mae_loss"]) / n
    if metrics & MetricsType.METRICS_AUC_ROC:
        out["auc"] = auc_from_histograms(host["auc_pos_hist"], host["auc_neg_hist"])
    return out
