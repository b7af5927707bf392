"""Step builders (counterpart of ``esn_tpu/train/step.py``); the predict
step so far."""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ..nn import SegModel
from ..ops.classify import argmax_lastdim
from ..ops.resize import resize_bilinear


def make_predict_step(model: SegModel, *,
                      compute_dtype: torch.dtype = torch.float32,
                      output_size: Optional[Tuple[int, int]] = None,
                      ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Build ``predict(images) -> pred (N, H, W) int32`` for images
    ``(N, C, H, W)`` on the model's device.

    The model is put in eval mode. Images are cast to ``compute_dtype``
    in ``channels_last`` memory; parameters stay f32 and each op casts them
    to the activation dtype. With ``output_size`` the full-res logits are
    resized (f32 bilinear) to it before the argmax; otherwise the model's
    own ``predict`` runs (the fused resize + argmax tail where it has one).
    """
    model.eval()

    @torch.inference_mode()
    def predict(images: torch.Tensor) -> torch.Tensor:
        x = images.to(dtype=compute_dtype, memory_format=torch.channels_last)
        if output_size is not None:
            logits = resize_bilinear(model(x).float(), output_size)
            return argmax_lastdim(logits.permute(0, 2, 3, 1))
        return model.predict(x)

    return predict
