"""Core layers (counterpart of the plain path of ``esn_tpu/nn/layers.py``).

NCHW tensors; parameters stay f32 and are cast to the activation dtype
where they meet it, as in the reference. Attribute names follow torch
(``weight``/``bias``/``running_mean``/``running_var``);
``esn_tpu_torch.convert`` maps them to the reference's
``kernel``/``scale``/``bias``/``mean``/``var``/``alpha``.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterator, List, Optional, Tuple, Union

import torch
from torch import nn

from . import initializers as init
from ..ops import convolution as C
from ..ops import kernels as K
from ..parallel import mesh, spatial
from ..utils import profiling

IntOr2 = Union[int, Tuple[int, int]]


def _pair(v: IntOr2) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else (int(v[0]), int(v[1]))


def _at_least_f32(dtype: torch.dtype) -> torch.dtype:
    """f32 for f32 and narrower floats, f64 for f64."""
    return torch.promote_types(dtype, torch.float32)


def _copy_(dst: torch.Tensor, src: torch.Tensor) -> None:
    with torch.no_grad():
        dst.copy_(src)


class Conv(nn.Module):
    """2D convolution, OIHW weight, Kaiming fan-out init."""

    def __init__(self, in_ch: int, out_ch: int, kernel: IntOr2, *,
                 stride: IntOr2 = 1, padding: IntOr2 = 0, dilation: IntOr2 = 1,
                 groups: int = 1, bias: bool = True):
        super().__init__()
        if in_ch % groups or out_ch % groups:
            raise ValueError(f"channels {in_ch}->{out_ch} not divisible by "
                             f"groups={groups}")
        self.in_ch, self.out_ch, self.groups = in_ch, out_ch, groups
        self.kernel = _pair(kernel)
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch // groups,
                                               *self.kernel))
        self.bias = nn.Parameter(torch.empty(out_ch)) if bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        _copy_(self.weight, init.kaiming_normal("fan_out")(
            generator, self.weight.shape))
        if self.bias is not None:
            fan_in = self.kernel[0] * self.kernel[1] * self.in_ch // self.groups
            _copy_(self.bias, init.bias_for_fan_in(fan_in)(
                generator, self.bias.shape))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return C.conv2d(x, self.weight, stride=self.stride,
                        padding=self.padding, dilation=self.dilation,
                        groups=self.groups, bias=self.bias)


class ConvTranspose(nn.Module):
    """Transposed 2D convolution with torch shape semantics, weight
    ``(in, out, kh, kw)``, Kaiming fan-out init (``fan_out = kh*kw*out``,
    as the reference's)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: IntOr2, *,
                 stride: IntOr2 = 1, padding: IntOr2 = 0,
                 output_padding: IntOr2 = 0, bias: bool = True):
        super().__init__()
        self.in_ch, self.out_ch = in_ch, out_ch
        self.kernel = _pair(kernel)
        self.stride, self.padding = stride, padding
        self.output_padding = output_padding
        self.weight = nn.Parameter(torch.empty(in_ch, out_ch, *self.kernel))
        self.bias = nn.Parameter(torch.empty(out_ch)) if bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        # drawn in OIHW, where the initializer reads its fans, then put
        # into the (in, out, kh, kw) layout
        kh, kw = self.kernel
        _copy_(self.weight, init.kaiming_normal("fan_out")(
            generator, (self.out_ch, self.in_ch, kh, kw)).transpose(0, 1))
        if self.bias is not None:
            _copy_(self.bias, init.bias_for_fan_in(kh * kw * self.in_ch)(
                generator, self.bias.shape))

    def subpixel_eligible(self) -> bool:
        """Whether the subpixel decomposition computes this layer: a
        stride above 1, ``k >= s`` and ``k + output_padding - 2p == s``
        per axis (the output is ``s`` times the input), the reference's
        rule."""
        (sh, sw), (ph, pw) = _pair(self.stride), _pair(self.padding)
        (oph, opw), (kh, kw) = _pair(self.output_padding), self.kernel
        return ((sh > 1 or sw > 1) and kh >= sh and kw >= sw
                and kh + oph - 2 * ph == sh and kw + opw - 2 * pw == sw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return C.conv2d_transpose(x, self.weight, stride=self.stride,
                                  padding=self.padding,
                                  output_padding=self.output_padding,
                                  bias=self.bias)


class _Tape:
    """What one module keeps in the first run of a recomputed forward and
    reads back, in the same order, in its recompute (:class:`Recompute`)."""

    def __init__(self):
        self.values: List = []
        self.replaying = False
        self._next = 0

    def keep(self, make: Callable):
        """``make()`` in the first run, kept; the kept value in the
        recompute."""
        if not self.replaying:
            self.values.append(make())
            return self.values[-1]
        self._next += 1
        return self.values[self._next - 1]


class _Recomputable(nn.Module):
    """A module whose training forward has a side effect or draws, and so
    must know whether it runs for the first time or is recomputed."""

    _tape: Optional[_Tape] = None


class Recompute:
    """The contexts of a forward that ``torch.utils.checkpoint`` runs once
    and recomputes during the backward (the train step's ``remat``), so
    that the recompute gives the first run's tensors bit for bit and the
    step moves the running statistics once, as the reference's pure
    ``jax.checkpoint`` does.

    In the first run each training :class:`BatchNorm` keeps the running
    mean it centres on (a copy: its update overwrites the buffer) and each
    :class:`Dropout` its generator's state before its draw. In the
    recompute each BatchNorm centres on its kept mean and leaves the
    running statistics alone, and each Dropout draws from its kept state.
    ``contexts`` is the checkpoint's ``context_fn``: call it once a
    checkpointed call.
    """

    def __init__(self, model: nn.Module):
        self.modules = [m for m in model.modules()
                        if isinstance(m, _Recomputable)]

    @staticmethod
    @contextlib.contextmanager
    def _run(tapes: Dict[nn.Module, _Tape], replaying: bool) -> Iterator[None]:
        for m, tape in tapes.items():
            tape.replaying, tape._next = replaying, 0
            m._tape = tape
        try:
            yield
        finally:
            for m in tapes:
                m._tape = None

    def contexts(self):
        """(the first run's context, the recompute's), over fresh tapes."""
        tapes = {m: _Tape() for m in self.modules}
        return self._run(tapes, False), self._run(tapes, True)


class BatchNorm(_Recomputable):
    """BatchNorm2d with the reference's numerics.

    Eval applies ``x*scale + offset`` in the input dtype with f32-computed
    per-channel ``scale``/``offset``. Train normalises with the batch's
    biased variance (moments in f32, centred on the running mean) and moves
    the running stats by ``momentum`` toward the batch mean and the
    unbiased variance. A module in f64 (``.double()``) keeps all of it in
    f64, so an f64 run is free of f32 rounding. A recompute
    (:class:`Recompute`) centres on the running mean of the first run and
    moves nothing.

    Under a data-parallel group the moments are those of the global batch,
    as the reference's global view takes them: the per-channel sums are
    all-reduced (``parallel.mesh.global_sum``, whose backward sums the
    ranks' gradients), the unbiased factor takes the global count, and
    every rank centres on the same running mean, so the running statistics
    stay equal on every rank. A recompute reissues the all-reduce, so
    every rank recomputes the same layers in the same order.

    Under spatial sharding every rank holds its batch rows' shard of
    image rows, equal or not (``spatial.bounds``): the same world sums
    hold, over the global count ``N x n_data x T x W`` with ``T`` the
    global rows (``spatial.global_rows``). On a tensor replicated over the
    model group (``spatial.replicated``) each element is summed ``S``
    times: the moments' ratio is unchanged, and the unbiased factor counts
    each element once.

    A CUDA tensor takes K8 (``ops.kernels.batchnorm``): the same
    statistics (summed in f64), counts and world sums from hand-written
    kernels, the scale and offset applied as here in f32 and rounded once
    to x's dtype, and a backward that keeps x alone. A CPU tensor takes
    the composite :meth:`_normalise`.
    """

    def __init__(self, num_features: int, *, momentum: float = 0.1,
                 eps: float = 1e-5, affine: bool = True):
        super().__init__()
        self.num_features, self.momentum, self.eps = num_features, momentum, eps
        self.affine = affine
        c = num_features
        self.weight = nn.Parameter(torch.ones(c)) if affine else None
        self.bias = nn.Parameter(torch.zeros(c)) if affine else None
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def reset_parameters(self, generator: torch.Generator) -> None:
        c = self.num_features
        if self.affine:
            _copy_(self.weight, init.ones(generator, (c,)))
            _copy_(self.bias, init.zeros(generator, (c,)))
        _copy_(self.running_mean, init.zeros(generator, (c,)))
        _copy_(self.running_var, init.ones(generator, (c,)))

    def _affine(self, mean: torch.Tensor, var: torch.Tensor):
        scale = torch.rsqrt(var.to(_at_least_f32(var.dtype)) + self.eps)
        if self.affine:
            scale = scale * self.weight
            return scale, self.bias - mean * scale
        return scale, -mean * scale

    def eval_affine(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Eval-mode BN as f32 per-channel ``(scale, offset)``."""
        return self._affine(self.running_mean, self.running_var)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with profiling.span("bn"):
            if x.is_cuda:
                return self._kernels(x)
            return self._normalise(x)

    def _centre(self) -> Tuple[torch.Tensor, bool]:
        """The running mean a training forward centres on (in a recompute
        the first run's) and whether it moves the running statistics."""
        tape = self._tape
        if tape is None:
            return self.running_mean, True
        return tape.keep(self.running_mean.clone), not tape.replaying

    def _count(self, x: torch.Tensor) -> int:
        """The elements a channel the moments sum over: the global
        tensor's under a group (a shard's rows are not T/S)."""
        if not mesh.active():
            return x.shape[0] * x.shape[2] * x.shape[3]
        w, ax = mesh.world(), spatial.axis()
        rows = x.shape[2] * w.spatial if ax is None \
            else spatial.global_rows(ax, x.shape[2])[0]
        return x.shape[0] * w.n_data * rows * x.shape[3]

    def _unbias(self, n: int) -> float:
        """The running variance's unbiased factor: a replicated tensor's
        elements counted once."""
        rep = spatial.replicated_axis()
        if rep is not None:
            n //= rep.size
        return n / max(n - 1, 1)

    def _kernels(self, x: torch.Tensor) -> torch.Tensor:
        """A CUDA tensor's BN: K8's moments, apply and backward."""
        if not self.training:
            if not (torch.is_grad_enabled() and (x.requires_grad or (
                    self.affine and self.weight.requires_grad))):
                return K.bn_apply(x, self.running_mean, self.running_var,
                                  self.weight, self.bias, self.eps)
            return K.BatchNormFn.apply(
                x, self.weight, self.bias, self.running_mean,
                self.running_var, None, self.eps, self.momentum, (1, 1.0),
                False, None)
        centre, update = self._centre()
        n = self._count(x)
        return K.BatchNormFn.apply(
            x, self.weight, self.bias, self.running_mean, self.running_var,
            centre, self.eps, self.momentum, (n, self._unbias(n)), update,
            mesh.all_sum if mesh.active() else None)

    def _normalise(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            rm, update = self._centre()
            xf = x.to(_at_least_f32(x.dtype)) - rm[:, None, None]
            n = self._count(x)
            if mesh.active():
                # the moments over the global batch: one all-reduce of the
                # 2C sums, whose backward sums the ranks' gradients
                d, m2 = (mesh.global_sum(torch.cat([
                    xf.sum(dim=(0, 2, 3)), xf.square().sum(dim=(0, 2, 3))]))
                    / n).chunk(2)
            else:
                d = xf.mean(dim=(0, 2, 3))
                m2 = xf.square().mean(dim=(0, 2, 3))
            mean = rm + d
            var = torch.clamp(m2 - d.square(), min=0.0)
            if update:
                unbiased = var * self._unbias(n)
                m = self.momentum
                with torch.no_grad():
                    self.running_mean.copy_((1 - m) * rm + m * mean.detach())
                    self.running_var.copy_((1 - m) * self.running_var
                                           + m * unbiased.detach())
            scale, offset = self._affine(mean, var)
        else:
            scale, offset = self.eval_affine()
        return (x * scale.to(x.dtype)[:, None, None]
                + offset.to(x.dtype)[:, None, None])


class PReLU(nn.Module):
    """PReLU with 1 (torch default) or per-channel slopes, init 0.25."""

    def __init__(self, num_parameters: int = 1, init_value: float = 0.25):
        super().__init__()
        self.init_value = init_value
        self.weight = nn.Parameter(torch.full((num_parameters,), init_value))

    def reset_parameters(self, generator: torch.Generator) -> None:
        _copy_(self.weight, torch.full(self.weight.shape, self.init_value))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.weight.to(x.dtype)
        if a.numel() > 1:
            a = a[:, None, None]
        return torch.where(x >= 0, x, a * x)


class Dropout(_Recomputable):
    """Element dropout; identity in eval mode and at rate 0.

    In training the mask comes from ``self.generator``, an explicit
    ``torch.Generator`` on the tensor's device (the reference draws from
    the step's ``"dropout"`` rng); the train step sets it. Training with
    a positive rate and no generator raises, as the reference does
    without a ``"dropout"`` rng. Kept values are scaled by ``1/keep``. A
    recompute (:class:`Recompute`) draws the first run's mask again. Under
    a data-parallel group the mask is drawn at the global batch's shape
    and each rank keeps its rows, so the ranks draw what one process
    would: its data index's batch rows and, under spatial sharding, its
    model index's image rows (a :class:`SpatialDropout` mask has one row
    an image, so there only the batch rows).
    """

    # whether the mask has the input's rows (sharded under spatial)
    _rows_sharded = True

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate <= 0.0:
            return x
        if self.generator is None:
            raise RuntimeError("Dropout in training needs a generator: set "
                               "it with set_dropout_generator or train "
                               "through make_train_step")
        if self._tape is not None:
            state = self._tape.keep(self.generator.get_state)
            if self._tape.replaying:
                self.generator.set_state(state)
        keep = 1.0 - self.rate
        shape = self._mask_shape(x)
        if mesh.active():
            # drawn at the global batch's shape; this rank keeps its rows
            w = mesh.world()
            n = shape[0]
            ax = spatial.axis() if self._rows_sharded else None
            if ax is None:
                u = torch.rand((n * w.n_data,) + shape[1:],
                               generator=self.generator, device=x.device)
                u = u[w.data_index * n:(w.data_index + 1) * n]
            else:
                total = spatial.global_rows(ax, shape[2])[0]
                lo, hi = spatial.my_rows(total, ax)
                u = torch.rand((n * w.n_data, shape[1], total)
                               + shape[3:], generator=self.generator,
                               device=x.device)
                u = u[w.data_index * n:(w.data_index + 1) * n, :, lo:hi]
        else:
            u = torch.rand(shape, generator=self.generator, device=x.device)
        return torch.where(u < keep, x / keep, torch.zeros_like(x))

    def _mask_shape(self, x: torch.Tensor) -> Tuple[int, ...]:
        return tuple(x.shape)


class SpatialDropout(Dropout):
    """Channel dropout (Dropout2d): one mask value per (N, C), so whole
    feature maps drop together; drawn as ``Dropout`` draws."""

    _rows_sharded = False

    def _mask_shape(self, x: torch.Tensor) -> Tuple[int, ...]:
        return (x.shape[0], x.shape[1], 1, 1)


def set_dropout_generator(model: nn.Module,
                          generator: Optional[torch.Generator]) -> None:
    """Give every Dropout (and SpatialDropout) of ``model`` the generator
    its masks come from."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = generator


class Dense(nn.Module):
    """Fully connected layer with bias, ``(out, in)`` weight, torch's
    default init.

    The weight is cast to x's dtype, the product accumulates in f32 (in
    f64 for an f64 x) and is rounded to x's dtype, then the bias is added
    in x's dtype.
    """

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        _copy_(self.weight, init.torch_conv_default(generator,
                                                    self.weight.shape))
        _copy_(self.bias, init.bias_for_fan_in(self.in_features)(
            generator, self.bias.shape))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        wide = _at_least_f32(x.dtype)
        w = self.weight.to(x.dtype).to(wide)
        y = torch.matmul(x.to(wide), w.t()).to(x.dtype)
        return y + self.bias.to(x.dtype)


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x)


def relu6(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0, 6)
