"""The z-folded 3x3x3 sparse conv, plain PyTorch (the reference of K3).

The contract of ``zband_conv_apply``:

    out[b, s, zo*Cout + co] = mask_out[b, s] *
        sum over taps t with nbr[b, s, t] < S_in, over the in cells
        r = stride*zo + dz - 1 (dz = 0..2) of super shift ds = t % 3:
            sum over ci of feats[b, nbr[b, s, t], zi(r)*Cin + ci]
                           * weight[t - ds + dz, ci, co]

summed in fp32 and cast to feats' dtype once; autograd differentiates it.
Frozen copy of the port's plain version.  ``zwin_conv_flops`` is the frozen
formula of the products it needs (2 per multiply-add): per active output
row, per tap the neighbour map finds, per (zo, dz) pair of the tap's z band,
Cin * Cout.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from .counting import kernel_call
from .sparse_conv import gather_rows
from .zfold import expand_lane_mask, expand_weight


def band_pairs(f_in: int, f_out: int, stride: int, ds: int):
    """The (zo, dz) pairs whose input cell lies in super shift ds."""
    return [(zo, dz) for zo in range(f_out) for dz in range(3)
            if (stride * zo + dz - 1) // f_in + 1 == ds]


def z_bands(f_in: int, f_out: int, stride: int) -> List[Tuple[int, int]]:
    """Nonzero (zi_lo, nzi) input-lane band per super z-shift ds in 0..2;
    nzi == 0 for an empty ds."""
    bands = []
    for ds in range(3):
        zis = [stride * zo + dz - 1 - (ds - 1) * f_in
               for zo, dz in band_pairs(f_in, f_out, stride, ds)]
        bands.append((min(zis), max(zis) - min(zis) + 1) if zis else (0, 0))
    return bands


def _zwin_sums(feats: torch.Tensor, nbr_idx: torch.Tensor,
               weight: torch.Tensor, f_in: int, f_out: int,
               stride: int) -> torch.Tensor:
    """``zband_conv_apply``'s fp32 sums, unmasked: per super shift ds,
    gather the band lanes of the 9 (dx, dy) taps and run one fp32 GEMM
    against the band of the lifted weight.  feats is widened to fp32
    before the bands are cut and gathered, so the backward sums a row's
    tap and band gradients in fp32 and rounds them to feats' dtype
    once."""
    B, _, L = feats.shape
    cin, cout = weight.shape[1], weight.shape[2]
    assert L == f_in * cin, (L, f_in, cin)
    assert stride * (f_out - 1) + 1 <= 2 * f_in, (f_in, f_out, stride)
    s_out = nbr_idx.shape[1]
    w_e = expand_weight(weight.to(feats.dtype).float(), f_in, f_out, stride)
    w_e = w_e.reshape(9, 3, f_in, cin, f_out, cout)
    nbr9 = nbr_idx.reshape(B, s_out, 9, 3)
    out = feats.new_zeros(B, s_out, f_out * cout, dtype=torch.float32)
    feats = feats.float()
    for ds, (zi_lo, nzi) in enumerate(z_bands(f_in, f_out, stride)):
        if not nzi:
            continue
        zos = [zo for zo, _ in band_pairs(f_in, f_out, stride, ds)]
        zo_lo, zo_hi = min(zos), max(zos)
        src = feats[:, :, zi_lo * cin:(zi_lo + nzi) * cin]
        gat = gather_rows(src, nbr9[..., ds]).reshape(B, s_out, 9 * nzi * cin)
        wk = w_e[:, ds, zi_lo:zi_lo + nzi, :, zo_lo:zo_hi + 1].reshape(
            9 * nzi * cin, (zo_hi - zo_lo + 1) * cout)
        out[:, :, zo_lo * cout:(zo_hi + 1) * cout] += gat @ wk
    return out


def zwin_conv_plain(feats: torch.Tensor, mask_out: torch.Tensor,
                    nbr_idx: torch.Tensor, weight: torch.Tensor,
                    f_in: int, f_out: int, stride: int) -> torch.Tensor:
    """``zband_conv_apply``: the fp32 sums cast once, zero off
    ``mask_out``."""
    out = _zwin_sums(feats, nbr_idx, weight, f_in, f_out, stride)
    return torch.where(mask_out[..., None], out.to(feats.dtype), 0)


def zwin_conv_epi_plain(feats: torch.Tensor, mask_out: torch.Tensor,
                        nbr_idx: torch.Tensor, weight: torch.Tensor,
                        f_in: int, f_out: int, stride: int,
                        inv: torch.Tensor, shift: torch.Tensor,
                        lane_mask: torch.Tensor) -> torch.Tensor:
    """The conv with the fused eval epilogue, in the order of JAX's
    ``_epilogue_in_kernel``: the fp32 sums (before any cast) times ``inv``
    plus ``shift`` ((L_out,) fp32), ReLU, times the lane mask (B, S_out,
    f_out), all in fp32, then one cast; zero off ``mask_out``."""
    cout = weight.shape[2]
    y = _zwin_sums(feats, nbr_idx, weight, f_in, f_out, stride)
    y = torch.relu(y * inv.float() + shift.float())
    y = y * expand_lane_mask(lane_mask, cout, torch.float32)
    return torch.where(mask_out[..., None], y.to(feats.dtype), 0)


def zwin_conv_flops(feats, mask_out, nbr_idx, weight, f_in: int, f_out: int,
                    stride: int) -> int:
    found = ((nbr_idx < feats.shape[1]) & mask_out[..., None]).sum(
        dim=(0, 1)).tolist()
    return 2 * weight.shape[1] * weight.shape[2] * sum(
        found[t] * len(band_pairs(f_in, f_out, stride, t % 3))
        for t in range(27))


def zwin_conv(feats: torch.Tensor, mask_out: torch.Tensor,
              nbr_idx: torch.Tensor, weight: torch.Tensor,
              f_in: int, f_out: int, stride: int) -> torch.Tensor:
    return kernel_call(
        lambda f, w: zwin_conv_plain(f, mask_out, nbr_idx, w, f_in, f_out,
                                     stride),
        lambda: zwin_conv_flops(feats, mask_out, nbr_idx, weight, f_in,
                                f_out, stride),
        feats, weight)


def zwin_conv_epi(feats: torch.Tensor, mask_out: torch.Tensor,
                  nbr_idx: torch.Tensor, weight: torch.Tensor,
                  f_in: int, f_out: int, stride: int, inv: torch.Tensor,
                  shift: torch.Tensor, lane_mask: torch.Tensor
                  ) -> torch.Tensor:
    return kernel_call(
        lambda f, w: zwin_conv_epi_plain(f, mask_out, nbr_idx, w, f_in,
                                         f_out, stride, inv, shift,
                                         lane_mask),
        lambda: zwin_conv_flops(feats, mask_out, nbr_idx, weight, f_in,
                                f_out, stride),
        feats, weight)
