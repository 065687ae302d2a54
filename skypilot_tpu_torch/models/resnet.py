"""ResNet (ResNet-50 and a thin ResNet-18) as torch ``nn.Module``s.

Counterpart of skypilot_tpu/models/resnet.py (flax.linen): the same
stage sizes, filters, bottleneck blocks with a ``conv_proj``/``norm_proj``
shortcut where the shape changes, and the zero-initialised scale of each
block's last norm.  Input is NHWC, as the reference's; it is viewed as
NCHW (``permute``, no copy: the view is ``channels_last``), the layout
cuDNN's NHWC convolutions take.

Numerics follow the reference: parameters and norm statistics in f32;
convolutions in the model's dtype (bf16 by default), their inputs and
kernels cast to it; batch norms and the head in f32.  Padding is flax's
'SAME', which pads (0, 1) where the total is odd (a 3x3 stride-2 window
over an even size), where ``padding=1`` in torch would pad (1, 1): each
window is padded explicitly with ``F.pad`` (-inf for the max pool).
Batch norm takes flax's statistics: the batch mean and the biased
variance E[x^2] - E[x]^2, in f32, and ra = momentum * ra + (1 - momentum)
* batch for the running ones (``torch.nn.BatchNorm2d`` moves the
unbiased variance, and ``F.batch_norm``'s own Welford variance rounds
otherwise, which moves a later norm's statistics off flax's).  The work
over the activations is fused all the same: the normalisation is
``F.batch_norm`` over those statistics, and its gradient ATen's
training-mode batch-norm backward from the same mean and 1/sqrt(var +
eps) (``_BatchNormFn``).  The convolutions stay
``torch.nn.functional.conv2d``, as the reference leaves them to XLA.

Submodules carry the flax module names (``conv_init``, ``bn_init``,
``ResNetBlock_<k>``, ``Conv_<i>``, ``BatchNorm_<i>``, ``Dense_0``) and
parameters the flax parameter names, so ``params_from_flax`` maps a flax
``{'params', 'batch_stats'}`` tree onto ``load_state_dict`` by name.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def _same_pads(size: int, k: int, stride: int):
    """(low, high) padding of flax/lax 'SAME' for one spatial dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, k: int, stride: int, value: float = 0.0):
    """x (N, C, H, W) padded for a k x k window at `stride`, 'SAME'."""
    top, bottom = _same_pads(x.shape[2], k, stride)
    left, right = _same_pads(x.shape[3], k, stride)
    if not (top or bottom or left or right):
        return x
    return F.pad(x, (left, right, top, bottom), value=value)


class Conv(nn.Module):
    """flax nn.Conv without bias: an f32 (O, I, kh, kw) ``kernel``,
    computed in `dtype`; padding 'SAME', or explicit (ph, pw)."""

    def __init__(self, in_ch: int, out_ch: int, k: int, stride: int = 1,
                 padding=None, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        fan_in = in_ch * k * k
        self.kernel = nn.Parameter(
            (torch.randn(out_ch, in_ch, k, k) * fan_in ** -0.5).contiguous(
                memory_format=torch.channels_last))
        self.k, self.stride, self.padding, self.dtype = k, stride, padding, \
            dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        if self.padding is None:
            x, pad = _pad_same(x, self.k, self.stride), 0
        else:
            pad = self.padding
        x = x.contiguous(memory_format=torch.channels_last)
        return F.conv2d(x, self.kernel.to(self.dtype), stride=self.stride,
                        padding=pad)


class _BatchNormFn(torch.autograd.Function):
    """Training-mode batch norm of x (N, C, H, W) over the batch's own
    `mean` and `var` (computed by the caller, outside the graph): the
    gradient to x goes through mean and var as well, as the batch
    statistics' own does."""

    @staticmethod
    def forward(ctx, x, scale, bias, mean, var, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, scale, mean, torch.rsqrt(var + eps))
        return F.batch_norm(x, mean, var, scale, bias, training=False,
                            eps=eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale, mean, invstd = ctx.saved_tensors
        dx, dscale, dbias = torch.ops.aten.native_batch_norm_backward(
            dy, x, scale, None, None, mean, invstd, True, ctx.eps,
            [True, True, True])
        return dx, dscale, dbias, None, None, None


class BatchNorm(nn.Module):
    """flax nn.BatchNorm over (N, H, W) in f32: ``scale``, ``bias`` and
    the running ``mean``/``var`` (batch_stats), momentum 0.9, eps 1e-5."""

    def __init__(self, ch: int, zero_scale: bool = False,
                 momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.scale = nn.Parameter(torch.zeros(ch) if zero_scale
                                  else torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer('mean', torch.zeros(ch))
        self.register_buffer('var', torch.ones(ch))
        self.momentum, self.eps = momentum, eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if not self.training:
            return F.batch_norm(x, self.mean, self.var, self.scale,
                                self.bias, training=False, eps=self.eps)
        with torch.no_grad():
            mean = x.mean(dim=(0, 2, 3))
            var = torch.clamp_min(x.square().mean(dim=(0, 2, 3))
                                  - mean * mean, 0.0)
            self.mean.lerp_(mean, 1 - self.momentum)
            self.var.lerp_(var, 1 - self.momentum)
        return _BatchNormFn.apply(x, self.scale, self.bias, mean, var,
                                  self.eps)


class ResNetBlock(nn.Module):
    """Bottleneck block: 1x1, 3x3 (at `stride`), 1x1 to 4 x filters, the
    last norm's scale zero; a projection shortcut where the shape
    changes."""

    def __init__(self, in_ch: int, filters: int, stride: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        conv = functools.partial(Conv, dtype=dtype)
        self.Conv_0 = conv(in_ch, filters, 1)
        self.BatchNorm_0 = BatchNorm(filters)
        self.Conv_1 = conv(filters, filters, 3, stride)
        self.BatchNorm_1 = BatchNorm(filters)
        self.Conv_2 = conv(filters, filters * 4, 1)
        self.BatchNorm_2 = BatchNorm(filters * 4, zero_scale=True)
        if in_ch != filters * 4 or stride != 1:
            self.conv_proj = conv(in_ch, filters * 4, 1, stride)
            self.norm_proj = BatchNorm(filters * 4)
        else:
            self.conv_proj = self.norm_proj = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        residual = x
        if self.conv_proj is not None:
            residual = self.norm_proj(self.conv_proj(x))
        return F.relu(residual + y)


class ResNet(nn.Module):
    """(N, H, W, 3) images -> (N, num_classes) f32 logits.  Train mode
    (``module.train()``, the default) normalises with batch statistics
    and moves the running ones; eval mode uses the running ones."""

    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 1000,
                 num_filters: int = 64, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.conv_init = Conv(3, num_filters, 7, 2, padding=3, dtype=dtype)
        self.bn_init = BatchNorm(num_filters)
        in_ch, k = num_filters, 0
        for i, block_size in enumerate(stage_sizes):
            for j in range(block_size):
                stride = 2 if i > 0 and j == 0 else 1
                filters = num_filters * 2 ** i
                self.add_module(f'ResNetBlock_{k}', ResNetBlock(
                    in_ch, filters, stride, dtype))
                in_ch, k = filters * 4, k + 1
        self.n_blocks = k
        # flax's Dense_0 kernel is (in, out); nn.Linear's weight (out, in).
        self.Dense_0 = nn.Linear(in_ch, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)                 # NHWC -> NCHW view
        x = F.relu(self.bn_init(self.conv_init(x)))
        x = F.max_pool2d(_pad_same(x, 3, 2, float('-inf')), 3, 2)
        for k in range(self.n_blocks):
            x = getattr(self, f'ResNetBlock_{k}')(x)
        x = x.float().mean(dim=(2, 3))
        return F.linear(x, self.Dense_0.weight, self.Dense_0.bias)


ResNet50 = functools.partial(ResNet, stage_sizes=[3, 4, 6, 3])
ResNet18Thin = functools.partial(ResNet, stage_sizes=[1, 1, 1, 1],
                                 num_filters=16, num_classes=10)


def params_from_flax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A flax ``{'params': ..., 'batch_stats': ...}`` tree of numpy
    arrays -> this module's state dict (``load_state_dict``, strict):
    HWIO conv kernels become OIHW, the Dense kernel (in, out) the
    Linear's (out, in) weight, and a norm's scale/bias and its
    batch_stats mean/var map by name."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        if isinstance(node, Mapping):
            for key, child in node.items():
                walk(child, path + [key])
            return
        arr = np.array(node, np.float32)       # a writable copy
        name = '.'.join(path)
        if path[-2] == 'Dense_0':
            name = name.replace('Dense_0.kernel', 'Dense_0.weight')
            arr = arr.T if path[-1] == 'kernel' else arr
        elif path[-1] == 'kernel':              # HWIO -> OIHW
            arr = arr.transpose(3, 2, 0, 1)
        out[name] = torch.from_numpy(np.ascontiguousarray(arr))

    walk(variables['params'], [])
    walk(variables.get('batch_stats', {}), [])
    return out
