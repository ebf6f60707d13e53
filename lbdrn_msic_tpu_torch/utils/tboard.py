"""Optional TensorBoard logging of training curves.

The reference writes `train/loss/{image}` per iteration and
`val/MSE/{image}` per epoch through torch's SummaryWriter
(reference encode.py:89-95,107).  The on-device loop here returns the full
loss history instead (FitResult.step_losses), so the same scalars are
emitted post-hoc — identical tags, zero cost in the hot loop.  Gated on the
torch tensorboard writer being importable.
"""

from __future__ import annotations

import numpy as np


def tensorboard_available() -> bool:
    try:
        from torch.utils.tensorboard import SummaryWriter  # noqa: F401

        return True
    except Exception:
        return False


def write_training_curves(
    log_dir: str,
    image_name: str,
    step_losses: np.ndarray,
    eval_mses: np.ndarray | None = None,
) -> None:
    """step_losses: (epochs, steps_per_epoch); eval_mses: (epochs,) or None."""
    from torch.utils.tensorboard import SummaryWriter

    writer = SummaryWriter(log_dir=log_dir)
    try:
        it = 0
        for epoch in range(step_losses.shape[0]):
            for s in range(step_losses.shape[1]):
                it += 1
                writer.add_scalar(
                    f"train/loss/{image_name}", float(step_losses[epoch, s]), it
                )
            if eval_mses is not None:
                writer.add_scalar(
                    f"val/MSE/{image_name}", float(eval_mses[epoch]), epoch + 1
                )
    finally:
        writer.close()
