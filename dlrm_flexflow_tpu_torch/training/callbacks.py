"""Training callbacks.

PyTorch counterpart of `dlrm_flexflow_tpu/training/callbacks.py` (after the
reference Keras callbacks, python/flexflow/keras/callbacks.py:49-88):
`LearningRateScheduler` through `FFModel.set_learning_rate`, the
`VerifyMetrics` / `EpochVerifyMetrics` accuracy gates, `EarlyStopping` and
`CheckpointCallback`. `FFModel.fit` calls the hooks. A failed gate raises
AssertionError, as the JAX package's does, but by an explicit raise that
`python -O` keeps.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional


class Callback:
    def on_train_begin(self, model) -> None: ...

    def on_epoch_begin(self, model, epoch: int) -> None: ...

    def on_epoch_end(self, model, epoch: int, metrics: Dict[str, float]) -> bool:
        """Return True to stop training early."""
        return False

    def on_train_end(self, model, metrics: Dict[str, float]) -> None: ...


class LearningRateScheduler(Callback):
    """schedule(epoch) -> lr, set through set_learning_rate (the rate lives
    in the optimizer state on the device: no recompile)."""

    def __init__(self, schedule: Callable[[int], float]):
        self.schedule = schedule

    def on_epoch_begin(self, model, epoch: int) -> None:
        model.set_learning_rate(float(self.schedule(epoch)))


def _gate(metrics: Dict[str, float], metric: str, threshold: float, failed: str) -> None:
    value = metrics.get(metric)
    if value is None or value < threshold:
        raise AssertionError(f"{failed}: {metric}={value} < {threshold}")


class VerifyMetrics(Callback):
    """A metric must clear a threshold at train end (the accuracy
    regression gate)."""

    def __init__(self, metric: str = "accuracy", threshold: float = 0.9):
        self.metric = metric
        self.threshold = threshold

    def on_train_end(self, model, metrics: Dict[str, float]) -> None:
        _gate(metrics, self.metric, self.threshold, "VerifyMetrics failed")


class EpochVerifyMetrics(Callback):
    """The same check at the end of every epoch from `start_epoch` on."""

    def __init__(self, metric: str = "accuracy", threshold: float = 0.9, start_epoch: int = 0):
        self.metric = metric
        self.threshold = threshold
        self.start_epoch = start_epoch

    def on_epoch_end(self, model, epoch: int, metrics: Dict[str, float]) -> bool:
        if epoch >= self.start_epoch:
            _gate(metrics, self.metric, self.threshold, f"EpochVerifyMetrics failed at epoch {epoch}")
        return False


class EarlyStopping(Callback):
    def __init__(self, metric: str = "accuracy", patience: int = 3, mode: str = "max"):
        self.metric = metric
        self.patience = patience
        self.mode = mode
        self.best: Optional[float] = None
        self.bad_epochs = 0

    def on_epoch_end(self, model, epoch: int, metrics: Dict[str, float]) -> bool:
        value = metrics.get(self.metric)
        if value is None:
            return False
        improved = (
            self.best is None
            or (self.mode == "max" and value > self.best)
            or (self.mode == "min" and value < self.best)
        )
        if improved:
            self.best = value
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
        return self.bad_epochs >= self.patience


class CheckpointCallback(Callback):
    """save_checkpoint every `every_epochs` epochs, the epoch and the
    metrics in the manifest's `extra`."""

    def __init__(self, path: str, every_epochs: int = 1):
        self.path = path
        self.every = every_epochs

    def on_epoch_end(self, model, epoch: int, metrics: Dict[str, float]) -> bool:
        if (epoch + 1) % self.every == 0:
            from .checkpoint import save_checkpoint

            save_checkpoint(self.path, model, extra={"epoch": epoch, **metrics})
        return False
