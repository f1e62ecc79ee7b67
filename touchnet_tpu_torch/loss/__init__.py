# Copyright (c) 2026 touchnet_tpu authors.
# Loss registry (touchnet_tpu/loss/__init__.py).

from touchnet_tpu_torch.loss.cross_entropy import (  # noqa: F401
    IGNORE_INDEX,
    accuracy,
    cross_entropy_loss,
    per_position_cross_entropy,
)

LOSSES = {"ce": cross_entropy_loss}
