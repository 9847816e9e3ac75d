"""PConv U-Net generator (counterpart of terra_gan_tpu/models/generator.py).

Architecture contract (reference: mvp_gan/src/models/generator.py):
  * 7 encoder PConv stages, widths w, 2w, 4w, 8w x4, kernels
    7,5,5,3,3,3,3, all stride 2, padding k//2;
  * 6 decoder steps: bilinear x2 of the features, nearest x2 of the
    mask, pad-to-match, an implicit concat with the skip, an element-max
    mask merge, then a stride-1 k3 PConv;
  * the tail: bilinear x2, the mask merged with the input mask, a dec1
    PConv over the upsampled features alone, a 64->1 conv, a sigmoid and
    the composite ``out * (1 - mask) + x * mask``.

The eval forward runs the tail as one ``fused_decoder_tail(...,
k_skip=None)`` call (K3): it replaces the last upsample, dec1's stage,
the final conv, the sigmoid and the composite, and on the H100 it is
faster than those at every batch measured. K3 needs the tail to be an
exact 2x; at an input size where it is not (enc1 rounds an odd size
up, so pad-to-match crops), and in train mode (K3 has no backward),
the forward runs the unfused tail, ``tail_forward``.

In eval mode every PConv stage outside K3 is one ``fused_pconv_eval``
call (K2); in train mode a stage is ``fused_pconv_train``, K2's train
variant with cuDNN's dgrad and wgrad as its backward, whose output is
``ops.pconv.partial_conv2d_split``'s, then ``nn.BatchNorm2d`` on the
batch statistics (torch's own train-mode semantics, which the JAX
package's ``TorchBatchNorm`` emulates), then ReLU. In both modes the
forward packs K2's TF32 weight planes for all stages in one launch first
(``packed_weights``), so they are never older than the weights, and
every bilinear x2 outside K3 is
``upsample2x_bilinear``: K1 forward, and in training K1 backward, on a
card; their plain versions on the CPU. The nearest upsample,
pad-to-match, mask merge and, in the unfused tail, the final conv,
sigmoid and composite are plain torch, as the JAX package leaves them
to XLA.

Tensors are NHWC, as in the JAX package; parameters carry the
reference's state-dict keys and its ``.parameters()`` order
(``encN.input_conv.*``, the frozen ``encN.mask_conv.weight``,
``encN.bn.*``, ..., ``final.*``: 72 entries), which the torch Adam
state of a reference ``.pth`` is numbered by.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.cuda.pconv_kernel import (
    fold_batch_norm,
    fused_pconv_eval,
    fused_pconv_eval_plain,
    pack_pconv_weights,
)
from ..ops.cuda.tail_kernel import fused_decoder_tail, fused_decoder_tail_plain
from ..ops.cuda.upsample_kernel import upsample2x_fwd_plain
from ..ops.resize import pad_to_match, upsample2x_bilinear, upsample2x_nearest

StageFn = Callable[..., Tuple[torch.Tensor, torch.Tensor]]
STAGES = tuple(f"enc{i}" for i in range(1, 8)) + tuple(f"dec{n}" for n in range(7, 0, -1))


class _MaskConv(nn.Module):
    """The reference's all-ones mask conv: a frozen parameter, as there.

    It is never read (the box-sum of the mask is computed directly) but
    keeps the reference's state-dict key and parameter order.
    """

    def __init__(self, k: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(1, 1, k, k), requires_grad=False)


def _batch_norm(bn: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    """``bn`` on NHWC ``x``. On the CPU the batch goes in NCHW-contiguous:
    torch's CPU kernel sums a channels-last batch's statistics in one float
    run per thread, whose error grows with the rows each thread takes
    (2.1e-5 of float64 on a 4x128x128x16 batch at one thread, against
    2.1e-7 NCHW-contiguous). On a card the batch goes in as it comes."""
    x = x.permute(0, 3, 1, 2)
    if x.device.type == "cpu":
        x = x.contiguous()
    return bn(x).permute(0, 2, 3, 1)


class PConv2d(nn.Module):
    """Partial conv + BatchNorm + ReLU (reference pconv.py:25-50)."""

    def __init__(self, in_ch: int, out_ch: int, k: int, stride: int, padding: int):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.input_conv = nn.Conv2d(in_ch, out_ch, k, stride, padding, bias=True)
        self.mask_conv = _MaskConv(k)
        self.bn = nn.BatchNorm2d(out_ch)

    def packed_weight(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """K2's TF32 planes of ``input_conv.weight`` as it is now
        (``pack_pconv_weight``; on a card one launch). Nothing caches them:
        a cache keyed on the weight's version would miss an in-place write
        through ``.data``."""
        return pack_pconv_weights([self.input_conv.weight])[0]

    def forward(
        self,
        x: torch.Tensor,
        mask: torch.Tensor,
        skip: Optional[torch.Tensor] = None,
        stage: StageFn = fused_pconv_eval,
        packed: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(x, skip) are the two halves of an implicit channel concat.

        ``stage`` is the eval-mode stage (K2 or its plain version, both
        taking ``packed``, the weight's planes packed in this forward; K2
        packs its own without them); train mode takes its partial conv
        from ``stage.train`` (K2's train Function, or the plain
        ``partial_conv2d_split``), then BatchNorm on the batch statistics
        and ReLU.
        """
        if self.training:
            out, new_mask = stage.train(
                x, mask, self.input_conv.weight, self.input_conv.bias, self.stride,
                self.padding, x_skip=skip, packed=packed,
            )
            return torch.relu(_batch_norm(self.bn, out)), new_mask
        bn = self.bn
        a, bb = fold_batch_norm(
            bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps
        )
        return stage(
            x, mask, self.input_conv.weight, self.input_conv.bias, self.stride,
            self.padding, a, bb, x_skip=skip, packed=packed,
        )


class PConvUNet(nn.Module):
    """Partial-convolution U-Net for DSM inpainting.

    forward(x, mask): x [B,H,W,1] in [0,1] (already multiplied by the
    mask, as the callers do), mask [B,H,W,1] with 1 = preserved. Returns
    the composited image, same shape as x.
    """

    def __init__(self, base_width: int = 64):
        super().__init__()
        w = base_width
        self.base_width = w
        enc = [(1, w, 7), (w, 2 * w, 5), (2 * w, 4 * w, 5), (4 * w, 8 * w, 3),
               (8 * w, 8 * w, 3), (8 * w, 8 * w, 3), (8 * w, 8 * w, 3)]
        for i, (cin, cout, k) in enumerate(enc):
            self.add_module(f"enc{i + 1}", PConv2d(cin, cout, k, 2, k // 2))
        # decN consumes (upsampled features, skip): dec7 <- (e7, e6), ...
        dec = [(7, 8 * w, 8 * w, 8 * w), (6, 8 * w, 8 * w, 8 * w),
               (5, 8 * w, 8 * w, 8 * w), (4, 8 * w, 4 * w, 4 * w),
               (3, 4 * w, 2 * w, 2 * w), (2, 2 * w, w, w), (1, w, 0, w)]
        for n, c_up, c_skip, cout in dec:
            self.add_module(f"dec{n}", PConv2d(c_up + c_skip, cout, 3, 1, 1))
        self.final = nn.Conv2d(w, 1, 3, padding=1)
        self._planes, self._planes_key = None, None  # packed_weights' buffers

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return self._run(x, mask, fused_pconv_eval, upsample2x_bilinear, fused_decoder_tail,
                         self.packed_weights())

    def forward_plain(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """The same forward through the kernels' plain versions, on any device,
        in either mode (in train mode with torch's own upsample backward).

        It is the reference the kernel path is held against on a card.
        """
        return self._run(
            x, mask, fused_pconv_eval_plain, upsample2x_fwd_plain, fused_decoder_tail_plain
        )

    def packed_weights(self) -> Optional[Dict[str, Tuple[torch.Tensor, torch.Tensor]]]:
        """{stage: K2's TF32 planes of its weight} for all 14 stages, packed
        from the weights as they are now in one launch (``pack_pconv_weights``);
        None on the CPU, where K2 is its plain version and reads no planes.

        The contents are packed anew at every call. The buffers are kept for
        the next call on the same stream while the weights' storage stands
        (their allocation is most of the call's host time), so the planes a
        call returns hold until the next one."""
        if not self.final.weight.is_cuda:
            self._planes = self._planes_key = None
            return None
        weights = [getattr(self, n).input_conv.weight for n in STAGES]
        key = (torch.cuda.current_stream(weights[0].device).cuda_stream,
               *(w.data_ptr() for w in weights))
        if key != self._planes_key:
            self._planes, self._planes_key = None, key
        self._planes = pack_pconv_weights(weights, out=self._planes)
        return dict(zip(STAGES, self._planes))

    def _run(self, x, mask, stage: StageFn, upsample, tail, planes=None) -> torch.Tensor:
        h, m = self.decode(x, mask, stage, upsample, planes)
        exact_2x = x.shape[1] == 2 * h.shape[1] and x.shape[2] == 2 * h.shape[2]
        if self.training or not exact_2x:
            return self.tail_forward(h, m, x, mask, stage, upsample, planes)
        return self.fused_tail_forward(h, m, x, mask, tail)

    def _stage(self, name: str, planes, *args, **kw):
        packed = None if planes is None else planes[name]
        return getattr(self, name)(*args, packed=packed, **kw)

    def decode(self, x, mask, stage: StageFn, upsample,
               planes=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """The encoder and the decoder up to dec2: dec2's (features, mask).
        ``planes``: ``packed_weights()`` of this forward, or None (K2 on a
        card then packs each stage's own)."""
        feats, masks = [x], [mask]
        h, m = x, mask
        for i in range(1, 8):
            h, m = self._stage(f"enc{i}", planes, h, m, stage=stage)
            feats.append(h)
            masks.append(m)

        for n in range(7, 1, -1):
            skip_f, skip_m = feats[n - 1], masks[n - 1]
            up_f = pad_to_match(upsample(h), skip_f.shape[1], skip_f.shape[2])
            up_m = pad_to_match(upsample2x_nearest(m), skip_m.shape[1], skip_m.shape[2])
            h, m = self._stage(f"dec{n}", planes, up_f, torch.maximum(up_m, skip_m),
                               skip=skip_f, stage=stage)
        return h, m

    def tail_forward(self, h, m, x, mask, stage: StageFn, upsample, planes=None) -> torch.Tensor:
        """The unfused tail from dec2's (features, mask): upsample, dec1's
        stage, the final conv, the sigmoid and the composite. Train mode
        and a tail that is not an exact 2x run it; on a card it is also
        what K3 is held against."""
        h = pad_to_match(upsample(h), x.shape[1], x.shape[2])
        m = pad_to_match(upsample2x_nearest(m), mask.shape[1], mask.shape[2])
        h, _ = self._stage("dec1", planes, h, torch.maximum(m, mask), stage=stage)

        out = F.conv2d(h.permute(0, 3, 1, 2), self.final.weight, self.final.bias, padding=1)
        out = torch.sigmoid(out).permute(0, 2, 3, 1)
        return out * (1.0 - mask) + x * mask

    def fused_tail_forward(self, h, m, x, mask, tail) -> torch.Tensor:
        """The same tail as one ``tail`` call (K3 or its plain version),
        in its one-input form, with dec1's and the final conv's weights."""
        conv, bn = self.dec1.input_conv, self.dec1.bn
        return tail(
            h, m, x, mask, conv.weight.permute(2, 3, 1, 0), None, conv.bias,
            bn.weight, bn.bias, bn.running_mean, bn.running_var,
            self.final.weight.permute(2, 3, 1, 0), self.final.bias, bn.eps,
        )
