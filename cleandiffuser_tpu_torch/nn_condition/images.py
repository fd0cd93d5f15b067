"""Image condition encoders (counterpart of
cleandiffuser_tpu/nn_condition/images.py): the GN-ResNet18 with its
SpatialSoftmax keypoint head or its average-pool head, the crop
randomiser and `MultiImageObsCondition` (the visual imitation pipelines'),
and `ResNet18ImageCondition`, `ResNet18MultiViewImageCondition`,
`SmallStem` and `EarlyConvViTMultiViewImageCondition`, which no pipeline
uses.

    cond = MultiImageObsCondition(shape_meta, emb_dim=256, crop_shape=(84, 84))
    emb = cond({"image": (b, 3, 96, 96), "agent_pos": (b, 2)})         # (b, 256)
    emb = cond(obs, train=True, generator=g)   # random crops drawn from g

The reference computes in NHWC; here the images stay NCHW, the layout
cuDNN's convolutions take, and the layers keep flax's arithmetic:

- convolutions without bias, 7x7 stride 2 padding 3 (the stem), 3x3
  padding 1, and 1x1 stride 2 for a downsampling block's skip (flax's
  "SAME" at a 1x1 kernel pads nothing at either parity of H);
- max-pooling 3x3 stride 2 padding 1 with -inf padding, as flax's;
- GroupNorm with max(C // 16, 1) groups and flax's eps 1e-6;
- SpatialSoftmax: a softmax over H*W per channel of x / temperature (a
  learned (1,) parameter), then the expected x (linspace(-1, 1) along W)
  and y (along H): (b, C, 2), flattened channel-major.

The residual block has no activation after its sum, as the reference's.

The average-pool head (`use_spatial_softmax=False`) is flax's
`avg_pool((7, 7), strides 1, VALID)` on the final map, flattened
channels-last, so its Dense reads (f - 6)^2 * 512 features for a final map
of f x f. flax sizes that Dense from the input at init; here it comes from
`image_sz`, and, where the reference's init fails (f < 7: images under
193 px), the constructor raises.

`SmallStem` is four conv 3x3 stride 2 (with bias) + GN + ReLU layers and a
patch conv (patch_size // 16, stride the same) to d_model, its map read as
tokens channels-last. `EarlyConvViTMultiViewImageCondition` puts the
lowdim tokens (Dense, plus a learned embedding), each view's stem tokens
(plus its learned embedding and sinusoidal positions over the view's To x
n_tok tokens) and a learned readout token in one sequence, runs the
pre-norm `Transformer` (utils/blocks.py) under a causal mask over the whole
sequence, and returns the readout token. The three embeddings start at
zero, as the reference's.

`random_crop` takes its per-sample offsets from an explicit generator (or
given ones, which is how the tests hand both packages the same crops) and
gathers the crop by index: exact, where the reference multiplies by
one-hot matrices. In training, `MultiImageObsCondition` crops every rgb
key at random, with the offsets in `condition[CROP_KEY][key]` when the
caller gives them; at sampling it crops the centre.

Under a bf16 cast of the params (the SDE sampler's `bf16_sampling` casts
the condition's too) the frames stay f32: the convs, norms, keypoints and
Dense layers promote as flax's do (utils/blocks.py), so the encoder
computes in f32 on the BF16-rounded weights, as the reference's does. The
crop is exact in any type (the reference's one-hot product in the image's
type selects one element per output, as the gather does).

Parameters carry across from the JAX package (utils/jax_params.py): a
conv's torch weight (Cout, Cin, KH, KW) is flax's kernel (KH, KW, Cin,
Cout) transposed; the children take flax's auto names (`ResNet18_<i>` per
sorted rgb key, `Conv_*`, `GroupNorm_*`, `_ResBlock2d_*`,
`SpatialSoftmax_0`, `Dense_*`).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.blocks import (
    Transformer,
    dense,
    generate_causal_mask,
    lecun_normal_init,
    promote,
    promoted_norm,
    silu,
)
from ..utils.embeddings import sinusoidal_features
from ..utils.ranks import batch_draw
from .base import BaseNNCondition

__all__ = ["ResNet18", "SpatialSoftmax", "MultiImageObsCondition", "random_crop",
           "center_crop", "CROP_KEY", "ResNet18ImageCondition",
           "ResNet18MultiViewImageCondition", "SmallStem",
           "EarlyConvViTMultiViewImageCondition"]

# the condition's entry for given crop offsets: {rgb key: (top, left)}
CROP_KEY = "crop_offsets"


class Conv2d(nn.Conv2d):
    """`nn.Conv2d` that promotes input, weight (and bias) to their common
    type, as flax's `nn.Conv` does."""

    def forward(self, x):
        if self.bias is None:
            return self._conv_forward(*promote(x, self.weight), None)
        return self._conv_forward(*promote(x, self.weight, self.bias))


def conv2d(in_channel: int, out_channel: int, kernel: int, stride: int = 1, padding: int = 0,
           generator: Optional[torch.Generator] = None, bias: bool = False) -> Conv2d:
    """A conv initialised as flax's `nn.Conv` (LeCun normal over the fan-in
    KH * KW * Cin; a zero bias with `bias`)."""
    layer = nn.utils.skip_init(Conv2d, in_channel, out_channel, kernel, stride=stride,
                               padding=padding, bias=bias)
    lecun_normal_init(layer.weight, generator, fan_in=kernel * kernel * in_channel)
    if bias:
        nn.init.zeros_(layer.bias)
    return layer


class GroupNorm2d(nn.Module):
    """flax `nn.GroupNorm(num_groups)` on (b, C, H, W); flax's eps 1e-6."""

    def __init__(self, channels: int, groups: int, eps: float = 1e-6):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return promoted_norm(lambda x, s, b: F.group_norm(x, self.groups, s, b, self.eps),
                             x, self.scale, self.bias)


def _gn(channels: int, group_channels: int = 16) -> GroupNorm2d:
    return GroupNorm2d(channels, max(channels // group_channels, 1))


class ResBlock2d(nn.Module):
    """conv 3x3 (stride 2 when downsampling), GN, activation, conv 3x3, GN,
    plus the skip (conv 1x1 stride 2 and GN when downsampling)."""

    def __init__(self, in_channel: int, out_channel: int, downsample: bool = False,
                 group_channels: int = 16, activation: Callable = F.relu,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        stride = 2 if downsample else 1
        g = generator
        self.conv1 = conv2d(in_channel, out_channel, 3, stride, 1, g)
        self.norm1 = _gn(out_channel, group_channels)
        self.conv2 = conv2d(out_channel, out_channel, 3, 1, 1, g)
        self.norm2 = _gn(out_channel, group_channels)
        self.downsample, self.activation = downsample, activation
        if downsample:
            self.skip_conv = conv2d(in_channel, out_channel, 1, 2, 0, g)
            self.skip_norm = _gn(out_channel, group_channels)
        self.JAX_NAMES = {"conv1": "Conv_0", "norm1": "GroupNorm_0", "conv2": "Conv_1",
                          "norm2": "GroupNorm_1", "skip_conv": "Conv_2", "skip_norm": "GroupNorm_2"}

    def forward(self, x):
        h = self.activation(self.norm1(self.conv1(x)))
        h = self.norm2(self.conv2(h))
        skip = self.skip_norm(self.skip_conv(x)) if self.downsample else x
        return h + skip


class SpatialSoftmax(nn.Module):
    """(b, C, H, W) -> (b, C, 2) soft-argmax keypoints (module note)."""

    def __init__(self):
        super().__init__()
        self.temperature = nn.Parameter(torch.ones(1))

    def forward(self, x):
        b, c, h, w = x.shape
        smax = torch.softmax(x.reshape(b, c, h * w) / self.temperature, -1).reshape(b, c, h, w)
        xr = torch.linspace(-1.0, 1.0, w, dtype=x.dtype, device=x.device)
        yr = torch.linspace(-1.0, 1.0, h, dtype=x.dtype, device=x.device)
        ex = (smax.sum(2) * xr).sum(-1)
        ey = (smax.sum(3) * yr).sum(-1)
        return torch.stack([ex, ey], -1)


RESNET18_STAGES = ((64, False), (64, False), (128, True), (128, False), (256, True),
                   (256, False), (512, True), (512, False))


def resnet18_final_size(image_sz: int) -> int:
    """The side of the GN-ResNet18's final map for square images of side
    `image_sz`: the stem conv and max-pool, then three stride-2 blocks."""
    f = (image_sz + 6 - 7) // 2 + 1
    for _ in range(4):
        f = (f + 2 - 3) // 2 + 1
    return f


class ResNet18(nn.Module):
    """GN-ResNet18: (B, C, H, W) -> (B, emb): stem (conv 7x7 stride 2, GN,
    activation, max-pool 3x3 stride 2), eight residual blocks (64, 64, 128,
    128, 256, 256, 512, 512 channels), the head, Dense, SiLU, Dense. The
    head is the 512 keypoints (1024 numbers), or with
    `use_spatial_softmax=False` the 7 x 7 average pool of the final map of
    `image_sz` images (module note)."""

    def __init__(self, in_channel: int, emb_dim: int, group_channels: int = 16,
                 activation: Callable = F.relu, generator: Optional[torch.Generator] = None,
                 image_sz: Optional[int] = None, use_spatial_softmax: bool = True):
        super().__init__()
        if use_spatial_softmax:
            head_dim = 2 * RESNET18_STAGES[-1][0]
        else:
            if image_sz is None:
                raise ValueError("the average-pool head needs image_sz")
            pooled = resnet18_final_size(image_sz) - 6
            if pooled < 1:
                raise ValueError(f"the average-pool head needs a final map of at least 7 x 7; "
                                 f"{image_sz} px images end at "
                                 f"{resnet18_final_size(image_sz)} x "
                                 f"{resnet18_final_size(image_sz)}")
            head_dim = pooled * pooled * RESNET18_STAGES[-1][0]
        self.use_spatial_softmax = use_spatial_softmax
        g = generator
        self.stem_conv = conv2d(in_channel, 64, 7, 2, 3, g)
        self.stem_norm = _gn(64, group_channels)
        blocks, c_in = [], 64
        for c, down in RESNET18_STAGES:
            blocks.append(ResBlock2d(c_in, c, down, group_channels, activation, g))
            c_in = c
        self.blocks = nn.ModuleList(blocks)
        if use_spatial_softmax:
            self.softmax = SpatialSoftmax()
        self.dense1 = dense(head_dim, emb_dim, generator=g)
        self.dense2 = dense(emb_dim, emb_dim, generator=g)
        self.activation = activation
        self.JAX_NAMES = {"stem_conv": "Conv_0", "stem_norm": "GroupNorm_0",
                          "blocks": "_ResBlock2d_{}", "softmax": "SpatialSoftmax_0",
                          "dense1": "Dense_0", "dense2": "Dense_1"}

    def forward(self, x):
        x = self.activation(self.stem_norm(self.stem_conv(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        for block in self.blocks:
            x = block(x)
        if self.use_spatial_softmax:
            feat = self.softmax(x)
        else:
            feat = F.avg_pool2d(x, 7, 1).permute(0, 2, 3, 1)
        return self.dense2(silu(self.dense1(feat.reshape(x.shape[0], -1))))


def random_crop(img, crop_h: int, crop_w: int, generator: Optional[torch.Generator] = None,
                offsets: Optional[Tuple] = None):
    """An independent crop per sample of (B, ..., H, W) images: offsets
    top in [0, H - crop_h], left in [0, W - crop_w], drawn from `generator`
    (top first) unless `offsets` = (top, left), each (B,), gives them."""
    *lead, h, w = img.shape
    b = img.shape[0]
    flat = img.reshape(b, -1, h, w)
    if offsets is None:
        top = batch_draw(lambda s: torch.randint(0, h - crop_h + 1, s, generator=generator,
                                                 device=img.device), (b,))
        left = batch_draw(lambda s: torch.randint(0, w - crop_w + 1, s, generator=generator,
                                                  device=img.device), (b,))
    else:
        top, left = (torch.as_tensor(o, device=img.device).long() for o in offsets)
    rows = top[:, None] + torch.arange(crop_h, device=img.device)
    cols = left[:, None] + torch.arange(crop_w, device=img.device)
    c = flat.shape[1]
    out = flat.gather(2, rows[:, None, :, None].expand(b, c, crop_h, w))
    out = out.gather(3, cols[:, None, None, :].expand(b, c, crop_h, crop_w))
    return out.reshape(*lead, crop_h, crop_w)


def center_crop(img, crop_h: int, crop_w: int):
    h, w = img.shape[-2], img.shape[-1]
    top, left = (h - crop_h) // 2, (w - crop_w) // 2
    return img[..., top:top + crop_h, left:left + crop_w]


class MultiImageObsCondition(BaseNNCondition):
    """shape_meta-driven dict observation encoder: each rgb key (sorted)
    through its own GN-ResNet18 (random crop in training, centre crop at
    sampling), the low_dim keys (sorted) flattened beside them, then Dense,
    SiLU, Dense to `emb_dim`. With `use_seq` the inputs are (b, To, ...)
    and the output (b, To, emb) with `keep_horizon_dims`, else (b, To *
    emb); without it (b, ...) -> (b, emb).

    shape_meta example:
        {"obs": {"image": {"shape": [3, 96, 96], "type": "rgb"},
                 "agent_pos": {"shape": [2], "type": "low_dim"}}}
    """

    def __init__(self, shape_meta: Dict, emb_dim: int = 256, rgb_model_emb_dim: int = 64,
                 crop_shape: Optional[Tuple[int, int]] = (76, 76), group_channels: int = 16,
                 use_seq: bool = False, keep_horizon_dims: bool = False, dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        obs_meta = shape_meta["obs"]
        self.rgb_keys = sorted(k for k, v in obs_meta.items() if v["type"] == "rgb")
        self.low_dim_keys = sorted(k for k, v in obs_meta.items() if v["type"] == "low_dim")
        self.crop_shape = None if crop_shape is None else tuple(crop_shape)
        self.use_seq, self.keep_horizon_dims = use_seq, keep_horizon_dims
        self.emb_dim, self.dropout = emb_dim, dropout
        self.nets = nn.ModuleList(
            ResNet18(obs_meta[k]["shape"][0], rgb_model_emb_dim, group_channels,
                     generator=generator) for k in self.rgb_keys)
        in_dim = rgb_model_emb_dim * len(self.rgb_keys) + sum(
            math.prod(obs_meta[k]["shape"]) for k in self.low_dim_keys)
        self.dense1 = dense(in_dim, emb_dim, generator=generator)
        self.dense2 = dense(emb_dim, emb_dim, generator=generator)
        self.JAX_NAMES = {"nets": "ResNet18_{}", "dense1": "Dense_0", "dense2": "Dense_1"}

    def _frames(self, x):
        """(b, To, ...) -> (b * To, ...) with `use_seq`; returns (x, b)."""
        b = x.shape[0]
        return (x.reshape(b * x.shape[1], *x.shape[2:]) if self.use_seq else x), b

    def forward(self, condition: Dict, mask=None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        crops = condition.get(CROP_KEY) or {}
        feats = []
        for key, net in zip(self.rgb_keys, self.nets):
            img, b = self._frames(condition[key])
            if self.crop_shape is not None:
                ch, cw = self.crop_shape
                img = (random_crop(img, ch, cw, generator, crops.get(key)) if train else
                       center_crop(img, ch, cw))
            feats.append(net(img))
        for key in self.low_dim_keys:
            x, b = self._frames(condition[key])
            feats.append(x.reshape(x.shape[0], -1))
        h = self.dense2(silu(self.dense1(torch.cat(feats, -1))))
        if self.use_seq:
            h = h.reshape(b, -1, self.emb_dim)
            if not self.keep_horizon_dims:
                h = h.reshape(b, -1)
        return self._apply_mask(h, self.get_mask(h, mask, train, generator))


def _frames(x, lead: int):
    """(b, ..., C, H, W) with `lead` leading axes before (C, H, W) -> the
    frames (b * ..., C, H, W) and the leading shape."""
    shape = tuple(x.shape[:lead])
    return x.reshape(-1, *x.shape[lead:]), shape


class ResNet18ImageCondition(BaseNNCondition):
    """(b, C, H, W) -> (b, emb) or (b, N, C, H, W) -> (b, N, emb): one
    GN-ResNet18 over the frames, with condition dropout."""

    JAX_NAMES = {"net": "ResNet18_0"}

    def __init__(self, image_sz: int, in_channel: int, emb_dim: int, group_channels: int = 16,
                 use_spatial_softmax: bool = True, dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.net = ResNet18(in_channel, emb_dim, group_channels, generator=generator,
                            image_sz=image_sz, use_spatial_softmax=use_spatial_softmax)
        self.dropout = dropout

    def forward(self, condition, mask=None, train: bool = False, generator=None):
        if condition.ndim not in (4, 5):
            raise ValueError(f"expected a 4D or 5D condition, got {tuple(condition.shape)}")
        frames, lead = _frames(condition, condition.ndim - 3)
        emb = self.net(frames).reshape(*lead, -1)
        return self._apply_mask(emb, self.get_mask(emb, mask, train, generator))


class ResNet18MultiViewImageCondition(BaseNNCondition):
    """(b, V, C, H, W) -> (b, V, emb) or (b, V, N, C, H, W) -> (b, V, N,
    emb): one GN-ResNet18 per view, with condition dropout."""

    JAX_NAMES = {"nets": "ResNet18_{}"}

    def __init__(self, image_sz: int, in_channel: int, emb_dim: int, n_views: int,
                 group_channels: int = 16, use_spatial_softmax: bool = True,
                 dropout: float = 0.0, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.nets = nn.ModuleList(
            ResNet18(in_channel, emb_dim, group_channels, generator=generator,
                     image_sz=image_sz, use_spatial_softmax=use_spatial_softmax)
            for _ in range(n_views))
        self.dropout = dropout

    def forward(self, condition, mask=None, train: bool = False, generator=None):
        if condition.ndim not in (5, 6):
            raise ValueError(f"expected a 5D or 6D condition, got {tuple(condition.shape)}")
        embs = []
        for i, net in enumerate(self.nets):
            frames, lead = _frames(condition[:, i], condition.ndim - 4)
            embs.append(net(frames).reshape(*lead, -1))
        emb = torch.stack(embs, 1)
        return self._apply_mask(emb, self.get_mask(emb, mask, train, generator))


class SmallStem(nn.Module):
    """Shallow-CNN patchifier: (B, C, H, W) -> (B, tokens, d_model)
    (module note)."""

    def __init__(self, in_channel: int, d_model: int, patch_size: int = 16,
                 channels_per_group: int = 16, kernel_sizes: Sequence[int] = (3, 3, 3, 3),
                 strides: Sequence[int] = (2, 2, 2, 2),
                 features: Sequence[int] = (32, 64, 128, 256),
                 padding: Sequence[int] = (1, 1, 1, 1),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        convs, norms, c_in = [], [], in_channel
        for k, s, f, p in zip(kernel_sizes, strides, features, padding):
            convs.append(conv2d(c_in, f, k, s, p, generator, bias=True))
            norms.append(_gn(f, channels_per_group))
            c_in = f
        ps = max(patch_size // 16, 1)
        convs.append(conv2d(c_in, d_model, ps, ps, 0, generator, bias=True))
        self.convs, self.norms, self.d_model = nn.ModuleList(convs), nn.ModuleList(norms), d_model
        self.JAX_NAMES = {"convs": "Conv_{}", "norms": "GroupNorm_{}"}

    def forward(self, x):
        for conv, norm in zip(self.convs, self.norms):
            x = F.relu(norm(conv(x)))
        x = self.convs[-1](x)
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1, self.d_model)


class EarlyConvViTMultiViewImageCondition(BaseNNCondition):
    """Octo-style early-CNN ViT over multi-view images and lowdim tokens;
    returns the readout token (module note).

    condition: {"image": (b, V, To, C, H, W), "lowdim": (b, To, lowdim_sz)
    (with `lowdim_sz`)} -> (b, d_model)."""

    def __init__(self, image_sz: Sequence[int] = (64, 64), in_channels: Sequence[int] = (3, 3),
                 lowdim_sz: Optional[int] = None, To: int = 1, d_model: int = 384,
                 nhead: int = 6, num_layers: int = 2, attn_dropout: float = 0.0,
                 ffn_dropout: float = 0.0, patch_size: Sequence[int] = (16, 16),
                 channels_per_group: Sequence[int] = (16, 16), dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.n_views, self.d_model, self.dropout = len(image_sz), d_model, dropout
        self.JAX_NAMES = {"stems": "SmallStem_{}", "transformer": "Transformer_0"}
        if lowdim_sz is not None:
            self.lowdim_emb = nn.Parameter(torch.zeros(1, 1, d_model))
            self.lowdim_proj = dense(lowdim_sz, d_model, generator=g)
            self.JAX_NAMES["lowdim_proj"] = "Dense_0"
        self.has_lowdim = lowdim_sz is not None
        self.stems = nn.ModuleList(
            SmallStem(c, d_model, p, cpg, generator=g)
            for c, p, cpg in zip(in_channels, patch_size, channels_per_group))
        for i in range(self.n_views):
            self.register_parameter(f"view_emb_{i}", nn.Parameter(torch.zeros(1, 1, d_model)))
        self.readout_emb = nn.Parameter(torch.zeros(1, 1, d_model))
        self.transformer = Transformer(d_model, nhead, num_layers, 4, attn_dropout, ffn_dropout,
                                       generator=g)

    def forward(self, condition: Dict, mask=None, train: bool = False, generator=None):
        image = condition["image"]
        b, v, t = image.shape[:3]
        if v != self.n_views:
            raise ValueError(f"{v} views given, the encoder has {self.n_views}")
        tokens = []
        if self.has_lowdim:
            tokens.append(self.lowdim_proj(condition["lowdim"]) + self.lowdim_emb)
        for i, stem in enumerate(self.stems):
            view = stem(image[:, i].reshape(b * t, *image.shape[3:]))
            n = t * view.shape[1]
            pos = sinusoidal_features(torch.arange(n, device=image.device), self.d_model)
            tokens.append(view.reshape(b, n, self.d_model) + getattr(self, f"view_emb_{i}")
                          + pos[None])
        tokens.append(self.readout_emb.expand(b, 1, self.d_model))
        tokens = torch.cat(tokens, 1)
        causal = generate_causal_mask(tokens.shape[1], image.device)
        out, _ = self.transformer(tokens, causal, train, generator)
        emb = out[:, -1]
        return self._apply_mask(emb, self.get_mask(emb, mask, train, generator))
