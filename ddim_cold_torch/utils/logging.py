"""Logging/metrics — train.log is the parity artifact (counterpart of
``ddim_cold_tpu/utils/logging.py``).

``print_log`` reproduces the reference's append-only logger
(multi_gpu_trainer.py:18-23) and the trainer emits the same line formats:

    Date: <asctime>
    TrainSet batchs:<n> / TestSet batchs:<n>
    steps: {steps:8d} loss: {ema:.4f} time_cost: {secs:.2f}
    epoch: {epoch:4d}    loss: {vloss:.5f}    time:<asctime>

``ScalarWriter`` replaces the rank-0 TensorBoard writer
(multi_gpu_trainer.py:15,108,151): it always appends machine-readable
``metrics.jsonl`` next to the log and also writes TensorBoard events when
``torch.utils.tensorboard`` imports.
"""

from __future__ import annotations

import json
import os
import time


def print_log(string: str, file_name: str) -> int:
    """Append one line (reference printLog, multi_gpu_trainer.py:18-23)."""
    with open(file_name, "a") as f:
        f.write(string + "\n")
    return 0


def asctime() -> str:
    return time.asctime(time.localtime(time.time()))


class ScalarWriter:
    """add_scalar → metrics.jsonl (always) + TensorBoard (when available)."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self.jsonl_path = os.path.join(log_dir, "metrics.jsonl")
        try:  # torch's SummaryWriter needs the tensorboard package
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            self._tb = None
        else:
            self._tb = SummaryWriter(log_dir=log_dir)

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps({"tag": tag, "value": float(value), "step": int(step),
                                "time": time.time()}) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
