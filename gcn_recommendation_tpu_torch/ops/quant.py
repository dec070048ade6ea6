"""Quantized retrieval: int8 item embeddings for serving top-k.

PyTorch counterpart of ``gcn_recommendation_tpu/ops/quant.py``.

* ``quantize_rows_int8`` — per-row absmax scaling to int8 with
  stochastic rounding.  On a CUDA tensor it launches the hand-written
  kernel ``csrc/quant_int8.cu`` (it replaces the Pallas kernel
  ``gcn_recommendation_tpu/ops/quant.py::_quant_kernel``); on a CPU
  tensor it runs the plain PyTorch version of the same arithmetic, so
  the CPU and the card compute the same function bit for bit.
* ``quantized_topk_scores`` — int8 x int8 -> int32 scores, per-row
  rescale, seen-item masking and top-k.

Random bits.  The TPU kernel draws from the TPU's on-core PRNG, which no
other device reproduces.  Here each element's 32 random bits come from a
counter-based hash keyed by (seed, global row, column):
``bits = triple32((row * d + col) ^ triple32(seed))`` over uint32, with
``triple32`` the three-round xorshift-multiply hash published in Chris
Wellons' hash-prospector.  As on the TPU, the uniform is the top 24 bits
times 2**-24 and the rounding is ``floor(x / scale + u)``.

Scale.  The TPU kernel's ``/ 127.0`` compiles to a multiply by the float32
reciprocal of 127 (its interpret-mode run gives exactly
``absmax * f32(1/127)``), so the stochastic path and the user-side
quantizer of ``quantized_topk_scores`` (jitted in the JAX package, where
XLA makes the same rewrite) multiply by that reciprocal.  The
round-to-nearest path (``use_kernel=False``) divides, as the JAX
package's eager fallback does.  Each path matches its JAX counterpart
bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from gcn_recommendation_tpu_torch.ops.topk import masked_topk

_U32 = 0xFFFFFFFF
# float32 reciprocal of 127, the constant the kernels multiply by
INV_127 = float(np.float32(1.0) / np.float32(127.0))
# top-24-bit uniform: u = (bits >> 8) * 2**-24, in [0, 1)
_U24_SCALE = 1.0 / 16777216.0
# triple32 multipliers (hash-prospector); the CUDA source uses the same
_TRIPLE32_MUL = (0xED5AD4BB, 0xAC4C1B51, 0x31848BAB)
_TRIPLE32_SHIFT = (17, 11, 15, 14)


def _mul_u32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2**32`` for int64 ``x`` in [0, 2**32) and a 32-bit
    constant ``c``, exactly: the full product can pass 2**63 and wrap
    int64, so multiply by the constant's 16-bit halves (each partial
    product stays below 2**48)."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def triple32(x: torch.Tensor) -> torch.Tensor:
    """The triple32 uint32 hash on int64 tensors holding uint32 values."""
    s = _TRIPLE32_SHIFT
    x = x ^ (x >> s[0])
    x = _mul_u32(x, _TRIPLE32_MUL[0])
    x = x ^ (x >> s[1])
    x = _mul_u32(x, _TRIPLE32_MUL[1])
    x = x ^ (x >> s[2])
    x = _mul_u32(x, _TRIPLE32_MUL[2])
    return x ^ (x >> s[3])


def random_bits(n: int, d: int, seed: int, device=None) -> torch.Tensor:
    """``[n, d]`` int64 tensor of the uint32 bits the kernel draws for
    element (row, col): ``triple32((row * d + col) ^ triple32(seed))``."""
    counter = torch.arange(n * d, dtype=torch.int64, device=device).reshape(n, d)
    key = triple32(torch.tensor(int(seed) & _U32, dtype=torch.int64, device=device))
    return triple32((counter & _U32) ^ key)


def _row_scale(x: torch.Tensor) -> torch.Tensor:
    """``max(absmax, 1e-12) * f32(1/127)`` per row, [N, 1] float32."""
    return x.abs().amax(dim=1, keepdim=True).clamp_min(1e-12) * INV_127


def _quantize_with_uniform(x: torch.Tensor, u) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's arithmetic with the uniforms given: ``u`` is a float32
    tensor broadcastable to ``x`` (or 0, which is what the JAX
    interpreter's PRNG yields)."""
    scale = _row_scale(x)
    rounded = torch.floor(x / scale + u)
    return rounded.clamp(-127.0, 127.0).to(torch.int8), scale


def _quantize_rows_int8_reference(x: torch.Tensor, seed: int = 0):
    """Plain PyTorch version of the CUDA kernel (same bits, same
    arithmetic); runs on any device."""
    n, d = x.shape
    bits = random_bits(n, d, seed, device=x.device)
    u = (bits >> 8).to(torch.float32) * _U24_SCALE
    return _quantize_with_uniform(x, u)


def _quantize_rows_int8_nearest(x: torch.Tensor):
    """Round-to-nearest (half to even), the JAX ``use_pallas=False`` path."""
    absmax = x.abs().amax(dim=1, keepdim=True)
    scale = absmax.clamp_min(1e-12) / torch.full_like(absmax, 127.0)
    q = torch.round(x / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def _quantize_rows_int8_cuda(x: torch.Tensor, seed: int):
    from gcn_recommendation_tpu_torch.kernels._build import load_library

    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(
            f"quant_int8 kernel takes a contiguous 2-D float32 tensor, got "
            f"{x.dtype} {tuple(x.shape)} contiguous={x.is_contiguous()}"
        )
    n, d = x.shape
    q = torch.empty((n, d), dtype=torch.int8, device=x.device)
    scales = torch.empty((n, 1), dtype=torch.float32, device=x.device)
    if n == 0 or d == 0:
        return q, scales
    lib = load_library("quant_int8")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.quantize_rows_int8_launch(
            ctypes.c_void_p(x.data_ptr()),
            ctypes.c_void_p(q.data_ptr()),
            ctypes.c_void_p(scales.data_ptr()),
            ctypes.c_int64(n),
            ctypes.c_int(d),
            ctypes.c_uint32(int(seed) & _U32),
            ctypes.c_void_p(stream),
        )
    if err != 0:
        raise RuntimeError(f"quant_int8 kernel launch failed: CUDA error {err}")
    quantize_rows_int8.launches += 1
    return q, scales


def quantize_rows_int8(
    x: torch.Tensor, seed: int = 0, use_kernel: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise int8 quantization of ``x`` [N, d] float32.

    Returns (q int8 [N, d], scales float32 [N, 1]).  ``use_kernel``:
    stochastic rounding — the CUDA kernel on a CUDA tensor (it launches
    or raises), its plain version on a CPU tensor.  ``use_kernel=False``:
    round-to-nearest, on any device.
    """
    if not use_kernel:
        return _quantize_rows_int8_nearest(x)
    if x.device.type == "cuda":
        return _quantize_rows_int8_cuda(x, seed)
    if x.device.type == "cpu":
        return _quantize_rows_int8_reference(x, seed)
    raise ValueError(f"quantize_rows_int8: unsupported device {x.device}")


# kernel launches since the last reset (the chip smoke test reads it)
quantize_rows_int8.launches = 0


def _pad_rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    if t.shape[0] == rows:
        return t
    return torch.cat([t, t.new_zeros((rows - t.shape[0],) + tuple(t.shape[1:]))])


def _int8_scores(u_q: torch.Tensor, item_q: torch.Tensor) -> torch.Tensor:
    """``u_q @ item_q.T`` with int32 accumulation, [B, I].

    On CUDA through ``torch._int_mm`` (the JAX package leaves this
    product to XLA), which wants more than 16 rows and inner and output
    widths that are multiples of 8: zero rows and columns are padded in
    and sliced off (zeros add nothing to an integer dot product).  On the
    CPU an int32 matmul."""
    b, d = u_q.shape
    n = item_q.shape[0]
    if u_q.device.type != "cuda":
        return u_q.to(torch.int32) @ item_q.to(torch.int32).T
    d_pad = -(-d // 8) * 8
    if d_pad != d:
        u_q = torch.nn.functional.pad(u_q, (0, d_pad - d))
        item_q = torch.nn.functional.pad(item_q, (0, d_pad - d))
    u_q = _pad_rows(u_q, max(32, b))
    item_q = _pad_rows(item_q, -(-n // 8) * 8)
    return torch._int_mm(u_q, item_q.T)[:b, :n]


def quantized_topk_scores(
    user_emb_batch: torch.Tensor,  # [B, d] float32
    item_q: torch.Tensor,          # [I, d] int8
    item_scale: torch.Tensor,      # [I, 1] float32
    filter_idx: torch.Tensor,      # [B, F] int64, padded with I
    k: int,
):
    """Masked top-k over an int8 item table: the user batch is quantized
    round-to-nearest per row, scores are int8 x int8 -> int32, rescaled
    as ``s32 * u_scale * item_scale.T`` (the JAX order)."""
    u_scale = _row_scale(user_emb_batch)
    u_q = torch.round(user_emb_batch / u_scale).clamp(-127, 127).to(torch.int8)
    s32 = _int8_scores(u_q, item_q)
    scores = s32.to(torch.float32) * u_scale * item_scale[:, 0][None, :]
    return masked_topk(scores, filter_idx, k)
