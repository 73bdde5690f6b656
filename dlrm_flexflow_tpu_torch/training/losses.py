"""Loss functions.

PyTorch counterpart of `dlrm_flexflow_tpu/training/losses.py`: each loss is
a scalar function of (logits, labels) in f32, and autograd gives the
gradients (the reference's 1/batch scale_factor semantics,
loss_functions.h:47-49).
"""
from __future__ import annotations

import torch

from ..ffconst import LossType

EPS = 1e-7


def compute_loss(loss_type: LossType, logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Returns the scalar mean (or sum) loss. `logits` semantics per type:
    - CCE: post-softmax probabilities [B, C]; labels one-hot/prob [B, C]
    - sparse CCE: post-softmax probabilities [B, C] (or [B, T, C]); labels
      int [B] or [B, 1] (or [B, T])
    - MSE: predictions matching labels' shape
    - BCE: post-sigmoid probabilities in (0, 1); labels in {0, 1}
    """
    logits = logits.float()
    if loss_type is LossType.LOSS_CATEGORICAL_CROSSENTROPY:
        p = logits.clamp(EPS, 1.0)
        return -torch.mean(torch.sum(labels.float() * torch.log(p), dim=-1))
    if loss_type is LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY:
        if logits.dim() == 3:
            logits = logits.reshape(-1, logits.shape[-1])
        idx = labels.reshape(logits.shape[0]).long()
        p = logits.clamp(EPS, 1.0)
        return -torch.mean(torch.log(p).gather(-1, idx[:, None]))
    if loss_type is LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE:
        labels = labels.float().reshape(logits.shape)
        return torch.mean(torch.sum((logits - labels) ** 2, dim=tuple(range(1, logits.dim()))))
    if loss_type is LossType.LOSS_MEAN_SQUARED_ERROR_SUM_REDUCE:
        labels = labels.float().reshape(logits.shape)
        return torch.sum((logits - labels) ** 2)
    if loss_type is LossType.LOSS_BINARY_CROSSENTROPY:
        labels = labels.float().reshape(logits.shape)
        p = logits.clamp(EPS, 1.0 - EPS)
        return -torch.mean(labels * torch.log(p) + (1.0 - labels) * torch.log(1.0 - p))
    raise ValueError(f"unknown loss {loss_type}")
