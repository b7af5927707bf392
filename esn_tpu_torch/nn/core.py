"""Model base class (counterpart of ``esn_tpu/nn/core.py``).

The reference's functional scope machinery (``init``/``apply`` over a
variables pytree addressed by path) is replaced by ``torch.nn.Module``:
submodule attribute names equal the reference's scope names, so a
``state_dict`` key is the reference's variable path joined with dots
(``esn_tpu_torch.convert`` maps one onto the other).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn


class SegModel(nn.Module):
    """Base of the segmentation models.

    ``LOGITS_TAIL`` says what produces a model's logits: ``"resize"``
    (forward ends in a bilinear upsample of ``logits_lowres``) or
    ``"conv"``. ``predict`` fuses the tail only for ``"resize"``.
    """

    LOGITS_TAIL = "conv"

    def init_weights(self, generator: torch.Generator) -> "SegModel":
        """Draw every parameter from ``generator`` in module order; BN
        running stats reset to mean 0 / var 1."""
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)
        return self

    def run(self, x: torch.Tensor, method: Optional[str] = None):
        """The forward, or the named forward ``method`` (e.g.
        ``"logits_lowres"``), as the reference's ``apply(..., method=)``."""
        return (getattr(self, method) if method else self)(x)

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        """Class-map prediction ``(N, H, W)`` int32 for images ``(N, C, H, W)``.

        Models whose forward ends in the bilinear-resize tail
        (``LOGITS_TAIL = "resize"``) expose the pre-resize logits as
        ``logits_lowres``; predict then runs the fused upsample + argmax
        (``ops.classify.resize_tail_argmax``), so full-resolution class
        logits never exist. The reference's other fused heads are
        algorithms, not TPU layout, and the port has them too: the seven
        models that end in a transposed conv override ``predict`` with
        ``models.blocks.subpixel_predict_tail`` (the class argmax per
        subpixel phase) and FPENet with
        ``ops.classify.resize2x_head_argmax``. The rest take the argmax of
        the full logits here.
        """
        from ..ops.classify import argmax_lastdim, resize_tail_argmax
        if self.LOGITS_TAIL == "resize" and hasattr(self, "logits_lowres"):
            y = self.logits_lowres(x)
            return resize_tail_argmax(y.permute(0, 2, 3, 1), tuple(x.shape[2:]))
        return argmax_lastdim(self(x).permute(0, 2, 3, 1))
