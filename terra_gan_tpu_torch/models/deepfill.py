"""DeepFill v2's gated-convolution generator with contextual attention.

The published model (Yu et al., "Free-Form Image Inpainting with Gated
Convolution", ICCV 2019, arXiv:1806.03589, on "Generative Image
Inpainting with Contextual Attention", CVPR 2018, arXiv:1801.07892;
github.com/JiahuiYu/generative_inpainting v2, ``inpaint_model.py``
``build_inpaint_net`` and ``inpaint_ops.py`` ``gen_conv``,
``gen_deconv``, ``contextual_attention``): ``cnum`` 48, a coarse
network, then a refinement network of two parallel branches (dilated
convolutions; contextual attention) merged into one decoder; every
convolution but the two output ones gated. With this system's ends (3
channels in, 1 out) its 42 convolutions hold 4.045 M parameters.

  * ``gen_conv(n, k, stride, rate, act)``: TF "SAME" zero padding (for
    kernel extent ``ke = rate (k - 1) + 1`` and output ``ceil(H / s)``
    the total is ``max((out - 1) s + ke - H, 0)``, its floor half
    before: at stride 2 and an even side, 0 before and 1 after), a k x k
    conv with bias and dilation ``rate`` to n channels; without ``act``
    that is the output, else ``act(feature) * sigmoid(gate)`` over its
    two halves, n / 2 channels (ELU, ReLU at pmconv6);
  * ``gen_deconv(n)``: nearest x2 (``out[i] = in[i // 2]``), then
    ``gen_conv(n, 3)``;
  * contextual attention (``ContextualAttention``, rate 2, ksize 3,
    fuse_k 3, scale 10) between the attention branch's features and
    themselves: queries are the 3x3 patches of the features taken at
    every other pixel, keys the same patches each divided by its norm
    (at least 1e-4), values the 4x4 patches of the full map at stride 2;
    the L x L scores are fused twice by a 3-tap diagonal sum over the
    flat indices (row-major, then column-major), keys whose patch
    touches the hole are zeroed before and after a softmax at scale 10,
    and the values are pasted back by the stride-2 transposed
    convolution, over 4.

Departures from the published model, shared with the program's
contract: the input is ``[xin, ones, ones * hole]`` with ``xin = (2x -
1) m`` (3 channels where DeepFill has 5), the output one channel where
it has 3, and ``y = (x2 + 1) / 2`` goes back to [0, 1]; each image's
attention takes its own mask, where the published code takes batch
element 0's for the whole batch; the attention's offset flow, an argmax
kept for visualisation, is not computed; nearest resizing samples
``in[floor(i * in / out)]``.

The port's forward contract is PConvUNet's: ``forward(x * m, m)`` on
NHWC [B,H,W,1] with m = 1 where kept, returning the composite
``y (1 - m) + x m``. ``forward_stages`` returns the coarse stage's raw
output ``x1`` (NHWC, in [-1, 1]) beside it, for the objective's coarse
term. H and W must divide by 8. Internally the tensors are NCHW; every
operation is stock PyTorch (cuDNN's convolutions, cuBLAS's batched
products for the attention).

Under a profiler (utils/trace.py) the forward's parts are the ranges
``tg.df_coarse`` (the input and stage 1), ``tg.df_refine`` (stage 2 and
the composite) and, inside it, ``tg.ctx_attn`` (the contextual
attention). ``ContextualAttention.calls`` counts the attentions run
(one a forward) and ``ContextualAttention.scores`` the score elements
they made (B L_q L_k, from the shapes).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.trace import span

# the published DeepFill v2 generator (inpaint.yml, inpaint_ops.contextual_attention)
DEEPFILL_V2 = {"cnum": 48}
ATTENTION = {"rate": 2, "ksize": 3, "fuse_k": 3, "softmax_scale": 10.0}
SIDE_STEP = 8  # two stride-2 convs, then the attention's rate 2
COARSE_L1_WEIGHT = 1.0  # inpaint.yml's l1_loss_alpha on the coarse output

ACTIVATIONS = {"elu": F.elu, "relu": torch.relu}


def same_pad(size: int, k: int, stride: int, rate: int) -> Tuple[int, int]:
    """TF "SAME" padding of one side: (before, after)."""
    extent = rate * (k - 1) + 1
    out = -(-size // stride)
    total = max((out - 1) * stride + extent - size, 0)
    return total // 2, total - total // 2


class GenConv(nn.Conv2d):
    """``gen_conv``: a gated convolution (or, without ``act``, a plain one)."""

    def __init__(self, cin: int, n: int, k: int, stride: int = 1, rate: int = 1,
                 act: Optional[str] = "elu"):
        # at stride 1 "SAME" is symmetric and the conv pads itself
        pad = rate * (k - 1) // 2 if stride == 1 else 0
        super().__init__(cin, n, k, stride, pad, dilation=rate)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stride[0] != 1:
            k, s, r = self.kernel_size[0], self.stride[0], self.dilation[0]
            top, bottom = same_pad(x.shape[-2], k, s, r)
            left, right = same_pad(x.shape[-1], k, s, r)
            x = F.pad(x, (left, right, top, bottom))
        y = super().forward(x)
        if self.act is None:
            return y
        feature, gate = y.chunk(2, 1)
        return ACTIVATIONS[self.act](feature) * torch.sigmoid(gate)


class GenDeconv(GenConv):
    """``gen_deconv``: nearest x2, then a 3x3 ``gen_conv``."""

    def __init__(self, cin: int, n: int):
        super().__init__(cin, n, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(F.interpolate(x, scale_factor=2, mode="nearest"))


class ContextualAttention(nn.Module):
    """Contextual attention of ``f`` on ``b`` (NCHW, the same size), keys
    masked by ``hole`` ([B,1,H,W], 1 in the hole); returns b's shape."""

    calls = 0  # forwards run, all instances
    scores = 0  # score elements made: B * L_q * L_k

    def __init__(self, rate: int = 2, ksize: int = 3, fuse_k: int = 3,
                 softmax_scale: float = 10.0):
        super().__init__()
        if rate != 2 or ksize % 2 == 0 or fuse_k % 2 == 0:
            raise ValueError("the attention is built at rate 2 with odd ksize and fuse_k")
        self.rate, self.ksize, self.softmax_scale = rate, ksize, softmax_scale
        # the published fuse: a conv of the flat [L, L] scores with an identity kernel
        self.register_buffer("fuse_weight", torch.eye(fuse_k).view(1, 1, fuse_k, fuse_k),
                             persistent=False)

    def _fuse(self, s: torch.Tensor) -> torch.Tensor:
        n, length = s.shape[0], s.shape[-1]
        pad = self.fuse_weight.shape[-1] // 2
        return F.conv2d(s.view(n, 1, length, length), self.fuse_weight,
                        padding=pad).view(n, length, length)

    def weights(self, f: torch.Tensor, b: torch.Tensor, hole: torch.Tensor) -> torch.Tensor:
        """[B, L_q, L_k]: the weight each query (f's patches at every r-th
        pixel, row-major) gives each key (b's)."""
        n = b.shape[0]
        r, k = self.rate, self.ksize
        f_d, b_d = f[:, :, ::r, ::r], b[:, :, ::r, ::r]
        h, w = f_d.shape[-2:]
        length = h * w
        q = F.unfold(f_d, k, padding=k // 2)  # [B, C k^2, L]
        keys = F.unfold(b_d, k, padding=k // 2)
        keys = keys / keys.norm(dim=1, keepdim=True).clamp_min(1e-4)
        s = torch.bmm(q.transpose(1, 2), keys)  # [B, L_q, L_k]
        s = self._fuse(s)  # row-major flat indices
        # column-major: (y, x) flattened as x h + y, on both sides
        s = s.view(n, h, w, h, w).permute(0, 2, 1, 4, 3).reshape(n, length, length)
        s = self._fuse(s)
        s = s.view(n, w, h, w, h).permute(0, 2, 1, 4, 3).reshape(n, length, length)
        # keys whose k x k patch of the hole (zero outside) holds no hole pixel
        m_d = hole[:, :, ::r, ::r]
        valid = (F.max_pool2d(m_d, k, 1, k // 2) == 0).to(s.dtype).view(n, 1, length)
        return torch.softmax(s * valid * self.softmax_scale, dim=2) * valid

    def forward(self, f: torch.Tensor, b: torch.Tensor, hole: torch.Tensor) -> torch.Tensor:
        with span("tg.ctx_attn"):
            n, _, height, width = b.shape
            r = self.rate
            # values: b's 2r x 2r patches at stride r, "SAME" (1 each side) [B, C 4r^2, L]
            raw = F.unfold(b, 2 * r, padding=r // 2, stride=r)
            a = self.weights(f, b, hole)
            pasted = torch.bmm(raw, a.transpose(1, 2))  # [B, C 4r^2, L_q]
            out = F.fold(pasted, (height, width), 2 * r, padding=r // 2, stride=r) / 4.0
            ContextualAttention.calls += 1
            ContextualAttention.scores += n * a.shape[1] * a.shape[2]
            return out


class DeepFillV2Generator(nn.Module):
    """DeepFill v2's generator at this system's ends: 3 channels in
    (``[xin, ones, ones * hole]``), 1 out. The default is the published
    width (``DEEPFILL_V2``); submodules carry the published layer names."""

    def __init__(self, cnum: int = 48):
        super().__init__()
        self.sizes = {"cnum": cnum}
        c = cnum
        # stage 1, the coarse network
        self.conv1 = GenConv(3, c, 5)
        self.conv2 = GenConv(c // 2, 2 * c, 3, 2)
        self.conv3 = GenConv(c, 2 * c, 3)
        self.conv4 = GenConv(c, 4 * c, 3, 2)
        self.conv5 = GenConv(2 * c, 4 * c, 3)
        self.conv6 = GenConv(2 * c, 4 * c, 3)
        self.conv7 = GenConv(2 * c, 4 * c, 3, rate=2)
        self.conv8 = GenConv(2 * c, 4 * c, 3, rate=4)
        self.conv9 = GenConv(2 * c, 4 * c, 3, rate=8)
        self.conv10 = GenConv(2 * c, 4 * c, 3, rate=16)
        self.conv11 = GenConv(2 * c, 4 * c, 3)
        self.conv12 = GenConv(2 * c, 4 * c, 3)
        self.conv13 = GenDeconv(2 * c, 2 * c)
        self.conv14 = GenConv(c, 2 * c, 3)
        self.conv15 = GenDeconv(c, c)
        self.conv16 = GenConv(c // 2, c // 2, 3)
        self.conv17 = GenConv(c // 4, 1, 3, act=None)
        # stage 2: the dilated branch
        self.xconv1 = GenConv(1, c, 5)
        self.xconv2 = GenConv(c // 2, c, 3, 2)
        self.xconv3 = GenConv(c // 2, 2 * c, 3)
        self.xconv4 = GenConv(c, 2 * c, 3, 2)
        self.xconv5 = GenConv(c, 4 * c, 3)
        self.xconv6 = GenConv(2 * c, 4 * c, 3)
        self.xconv7 = GenConv(2 * c, 4 * c, 3, rate=2)
        self.xconv8 = GenConv(2 * c, 4 * c, 3, rate=4)
        self.xconv9 = GenConv(2 * c, 4 * c, 3, rate=8)
        self.xconv10 = GenConv(2 * c, 4 * c, 3, rate=16)
        # stage 2: the attention branch
        self.pmconv1 = GenConv(1, c, 5)
        self.pmconv2 = GenConv(c // 2, c, 3, 2)
        self.pmconv3 = GenConv(c // 2, 2 * c, 3)
        self.pmconv4 = GenConv(c, 4 * c, 3, 2)
        self.pmconv5 = GenConv(2 * c, 4 * c, 3)
        self.pmconv6 = GenConv(2 * c, 4 * c, 3, act="relu")
        self.attention = ContextualAttention(**ATTENTION)
        self.pmconv9 = GenConv(2 * c, 4 * c, 3)
        self.pmconv10 = GenConv(2 * c, 4 * c, 3)
        # stage 2: the merged decoder
        self.allconv11 = GenConv(4 * c, 4 * c, 3)
        self.allconv12 = GenConv(2 * c, 4 * c, 3)
        self.allconv13 = GenDeconv(2 * c, 2 * c)
        self.allconv14 = GenConv(c, 2 * c, 3)
        self.allconv15 = GenDeconv(c, c)
        self.allconv16 = GenConv(c // 2, c // 2, 3)
        self.allconv17 = GenConv(c // 4, 1, 3, act=None)

    def _chain(self, x: torch.Tensor, *names: str) -> torch.Tensor:
        for name in names:
            x = getattr(self, name)(x)
        return x

    def forward_stages(self, x: torch.Tensor,
                       mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [B,H,W,1] in [0,1], already multiplied by the mask; mask
        [B,H,W,1], 1 = preserved. Returns (the composite, the coarse
        stage's raw output x1 in [-1, 1]), both NHWC."""
        if x.shape[1] % SIDE_STEP or x.shape[2] % SIDE_STEP:
            raise ValueError(f"DeepFillV2Generator takes sides that divide by {SIDE_STEP}, "
                             f"got {tuple(x.shape[1:3])}")
        with span("tg.df_coarse"):
            m = mask.permute(0, 3, 1, 2)
            hole = 1.0 - m
            xin = (2.0 * x.permute(0, 3, 1, 2) - 1.0) * m  # the hole at 0
            h = torch.cat([xin, torch.ones_like(m), hole], 1).contiguous()
            x1 = torch.tanh(self._chain(h, *(f"conv{i}" for i in range(1, 18))))
        with span("tg.df_refine"):
            xs = x1 * hole + xin * m
            dilated = self._chain(xs, *(f"xconv{i}" for i in range(1, 11)))
            pm = self._chain(xs, *(f"pmconv{i}" for i in range(1, 7)))
            pm = self.attention(pm, pm, hole[:, :, ::4, ::4])
            pm = self._chain(pm, "pmconv9", "pmconv10")
            h = self._chain(torch.cat([dilated, pm], 1), *(f"allconv{i}" for i in range(11, 18)))
            y = ((torch.tanh(h) + 1.0) * 0.5).permute(0, 2, 3, 1)
            return y * (1.0 - mask) + x * mask, x1.permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """The composite (``forward_stages``' first)."""
        return self.forward_stages(x, mask)[0]


def coarse_l1(x1: torch.Tensor, real: torch.Tensor) -> torch.Tensor:
    """DeepFill's ae_loss on the coarse output: mean |real - x1| over every
    pixel, real mapped to [-1, 1] as x1 is."""
    return (2.0 * real - 1.0 - x1).abs().mean()


def is_deepfill_state(state: Mapping[str, torch.Tensor]) -> bool:
    """Whether a state dict is a DeepFillV2Generator's (by its layer names)."""
    return "pmconv1.weight" in state and "allconv17.weight" in state


def sizes_from_state(state: Mapping[str, torch.Tensor]) -> Dict[str, int]:
    """The constructor's sizes that a generator's state dict was built with."""
    return {"cnum": int(state["conv1.weight"].shape[0])}
