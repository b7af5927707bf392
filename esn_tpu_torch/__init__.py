"""esn_tpu_torch — the PyTorch/CUDA port of ``esn_tpu`` for one NVIDIA H100.

The JAX package ``esn_tpu`` is the reference; this package mirrors its
module layout so each counterpart sits at the same path. It imports
``torch`` and never ``jax`` or ``esn_tpu``.

    from esn_tpu_torch.models import build_model
    from esn_tpu_torch.train.step import make_predict_step

Models are NCHW tensors in ``torch.channels_last`` memory (physically the
reference's NHWC). The hand-written CUDA kernels live in ``csrc/`` and are
built at first use by ``ops.kernels``.
"""

__version__ = "0.1.0"

from .models import available_models, build_model  # noqa: F401,E402
