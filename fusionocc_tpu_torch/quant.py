"""Post-training int8 quantization: weight-only and int8 serving.

Port of ``fusionocc_tpu/quant.py``.  Two levels, as there:

- Weight-only int8 (``quantize_state_dict`` / ``dequantize_state_dict``):
  per-output-channel symmetric quantization of the conv and dense kernels.
  Which tensors are kernels is the JAX package's rule (flax leaves named
  ``kernel``, ``conv_input_kernel`` or ``conv_out_kernel`` of rank >= 2),
  read through the flax-path <-> torch-key rules of
  ``weights.slice_rules``; ``include`` names top-level modules by their
  flax names (``img_backbone``, ``bev_backbone``, ...).  The output channel
  is axis 0 of a torch weight (flax's is the last axis), so the int8
  payloads and scales equal JAX's ``quantize_tree`` after ``weights`` maps
  the tree.
- int8 serving (``int8_linear``, the counterpart of ``int8_dot_general``,
  and ``int8_dot``): dynamic per-tensor activation and per-output-channel
  weight quantization around an int8 x int8 -> int32 product.  On the card
  the product is ``torch._int_mm`` (cuBLASLt): JAX computes it with
  ``lax.dot_general`` outside any Pallas kernel, so it is a library
  product here too.  On the CPU it is the plain product
  (``int8_mm_plain``), exact in float64.  Quantization and rescale are
  plain PyTorch, in JAX's order of operations (a division by the scale,
  ``x_scale * w_scale`` formed first; ``torch.round`` rounds half to even
  as ``jnp.round`` does), so both packages give the same int32 sums.
"""
from __future__ import annotations

from typing import Dict, Iterable, Sequence, Set, Tuple

import torch

from .config import ModelConfig

KERNEL_NAMES = ('kernel', 'conv_input_kernel', 'conv_out_kernel')


def kernel_keys(cfg: ModelConfig, include: Sequence[str] = ()) -> Set[str]:
    """The torch keys of the tensors JAX's ``quantize_tree`` quantizes:
    the parameters whose flax leaf is a kernel, of the top-level modules
    in ``include`` (flax names; empty = all)."""
    from .weights import slice_rules
    keys = set()
    for fpath, (tkey, _) in slice_rules(cfg)['params'].items():
        parts = fpath.split('/')
        if parts[-1] in KERNEL_NAMES and (not include
                                          or parts[0] in include):
            keys.add(tkey)
    return keys


def param_keys(cfg: ModelConfig) -> Set[str]:
    """The torch keys of every flax ``params`` leaf (the tree
    ``quantize_tree`` walks: no running statistics)."""
    from .weights import slice_rules
    return {tkey for tkey, _ in slice_rules(cfg)['params'].values()}


def quantize_weight(w: torch.Tensor, bits: int = 8
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 payload, fp32 scale of shape (O, 1, ...)) of a weight whose
    output channel is axis 0: scale = max(amax, 1e-12) / qmax over the
    other axes, payload = clip(round(w / scale), -qmax - 1, qmax)."""
    qmax = 2 ** (bits - 1) - 1
    wf = w.detach().float()
    amax = wf.abs().amax(dim=tuple(range(1, wf.dim())), keepdim=True)
    scale = torch.clamp_min(amax, 1e-12) / qmax
    q = torch.clamp(torch.round(wf / scale), -qmax - 1, qmax)
    return q.to(torch.int8), scale


def quantize_state_dict(state_dict: Dict[str, torch.Tensor],
                        cfg: ModelConfig, include: Sequence[str] = (),
                        bits: int = 8
                        ) -> Tuple[Dict[str, torch.Tensor],
                                   Dict[str, torch.Tensor]]:
    """Per-output-channel symmetric int8 quantization of the kernels.

    Returns (qsd, scales): ``qsd`` is ``state_dict`` with every kernel
    (``kernel_keys(cfg, include)``) replaced by its int8 payload, the other
    entries untouched; ``scales`` maps each quantized key to its fp32
    scale (O, 1, ...)."""
    keys = kernel_keys(cfg, include)
    qsd, scales = {}, {}
    for k, v in state_dict.items():
        if k in keys and v.dim() >= 2:
            qsd[k], scales[k] = quantize_weight(v, bits)
        else:
            qsd[k] = v
    return qsd, scales


def dequantize_weight(q: torch.Tensor, scale: torch.Tensor,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``(q * scale)`` in fp32, rounded once to ``dtype``."""
    return (q.float() * scale).to(dtype)


def dequantize_state_dict(qsd: Dict[str, torch.Tensor],
                          scales: Dict[str, torch.Tensor],
                          dtype: torch.dtype = torch.float32
                          ) -> Dict[str, torch.Tensor]:
    """A dense state dict from ``quantize_state_dict``'s output: each
    kernel dequantized in fp32 and rounded to ``dtype`` (the serving path
    passes the compute dtype, as JAX's ``tools/test.py`` does), the other
    entries as they are."""
    return {k: dequantize_weight(v, scales[k], dtype) if k in scales else v
            for k, v in qsd.items()}


def load_int8_weights(model: torch.nn.Module, cfg: ModelConfig,
                      include: Sequence[str] = ()) -> Dict[str, float]:
    """Weight-only int8 in place: every kernel of ``model`` quantized and
    dequantized into the compute dtype (``cfg.dtype``), then kept in the
    model's fp32 parameters (exact: the layers cast them back to the
    compute dtype).  Returns ``quantized_size_bytes``."""
    sd = model.state_dict()
    qsd, scales = quantize_state_dict(sd, cfg, include)
    deq = dequantize_state_dict(qsd, scales, cfg.dtype)
    with torch.no_grad():
        for k in scales:
            sd[k].copy_(deq[k].to(sd[k].dtype))
    return quantized_size_bytes(qsd, scales, cfg)


def quantized_size_bytes(qsd: Dict[str, torch.Tensor],
                         scales: Dict[str, torch.Tensor],
                         cfg: ModelConfig) -> Dict[str, float]:
    """Storage accounting over the parameters (JAX's ``params`` tree):
    int8 payload plus fp32 scales, against fp32 for all."""
    q_bytes = fp_bytes = 0
    for k in sorted(param_keys(cfg)):
        n = qsd[k].numel()
        fp_bytes += n * 4
        if qsd[k].dtype == torch.int8:
            q_bytes += n + scales[k].numel() * 4
        else:
            q_bytes += n * 4
    return {'quantized_bytes': q_bytes, 'fp32_bytes': fp_bytes,
            'ratio': round(fp_bytes / max(q_bytes, 1), 2)}


def calibrate_activation_scale(batches_of_acts: Iterable) -> float:
    """Max-abs activation scale over calibration batches (per-tensor)."""
    amax = 0.0
    for a in batches_of_acts:
        amax = max(amax, float(torch.as_tensor(a).abs().max()))
    return max(amax, 1e-12) / 127.0


def int8_mm_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 x (K, N) int8 -> (M, N) int32, exact: the products (each
    at most 2**14 in magnitude) are summed in float64, which holds every
    such sum of fewer than 2**39 terms exactly."""
    return (a.double() @ b.double()).to(torch.int32)


def int8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 x (K, N) int8 -> (M, N) int32: the plain product for CPU
    tensors, ``torch._int_mm`` (cuBLASLt) for CUDA tensors, which takes M >
    16 (fewer rows are padded with zero rows) and K and N multiples of
    8."""
    if a.device.type == 'cpu':
        return int8_mm_plain(a, b)
    M, K = a.shape
    N = b.shape[1]
    if K % 8 or N % 8:
        raise ValueError(f'torch._int_mm takes K and N multiples of 8, got '
                         f'K={K}, N={N}')
    if M <= 16:
        a = torch.cat([a, a.new_zeros(17 - M, K)])
    return torch._int_mm(a.contiguous(), b.contiguous())[:M]


def _quantize_activation(x: torch.Tensor, lo: int):
    """Dynamic per-tensor scale max(max|x|, 1e-12) / 127 and the payload
    clip(round(x / scale), lo, 127), int8, all in fp32 (the max of |x| is
    exact in x's dtype; one fp32 copy of x is divided, rounded and clipped
    in place)."""
    amax = torch.linalg.vector_norm(x, float('inf'), dtype=torch.float32)
    x_scale = torch.clamp_min(amax, 1e-12) / 127.0
    q = x.to(torch.float32, copy=True)
    q.div_(x_scale).round_().clamp_(lo, 127)
    return q.to(torch.int8), x_scale


def int8_linear(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``x @ weight.T`` through an int8 x int8 -> int32 product: JAX's
    ``int8_dot_general`` for a Dense layer.

    x (..., K) in the compute dtype; weight (N, K) already cast to it (flax
    ``Dense`` casts the kernel before its ``dot_general``, so the weight
    scale comes from the rounded weight).  Activations are clipped to
    [-127, 127] with a per-tensor scale, weights per output channel.
    Returns (..., N) in x's dtype; the caller adds the bias after, in that
    dtype, as flax does."""
    x_q, x_scale = _quantize_activation(x, -127)
    wf = weight.float()
    w_scale = torch.clamp_min(wf.abs().amax(dim=1), 1e-12) / 127.0
    w_q = torch.clamp(torch.round(wf / w_scale[:, None]), -127, 127
                      ).to(torch.int8)
    acc = int8_mm(x_q.reshape(-1, x.shape[-1]), w_q.t())
    # int32 * fp32 computes in fp32: JAX's acc.astype(f32) * scale, one pass
    out = acc * (x_scale * w_scale)
    return out.to(x.dtype).reshape(*x.shape[:-1], weight.shape[0])


def int8_dot(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
             x_scale=None) -> torch.Tensor:
    """int8 x int8 -> int32 product rescaled to float32 (JAX's
    ``int8_dot``).

    x (..., K) float; w_q (K, N) int8 (JAX's layout); w_scale (1, N), (N,)
    or a scalar, fp32.  x_scale None = dynamic per-call max-abs scale;
    activations are clipped to [-128, 127].
    """
    if x_scale is None:
        x_q, x_scale = _quantize_activation(x, -128)
    else:
        x_q = torch.clamp(torch.round(x.float() / x_scale), -128, 127
                          ).to(torch.int8)
    acc = int8_mm(x_q.reshape(-1, x.shape[-1]), w_q)
    out = acc * (x_scale * w_scale.float().reshape(-1))
    return out.reshape(*x.shape[:-1], w_q.shape[1])
