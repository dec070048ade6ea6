"""Quantized retrieval: int8 item embeddings for serving top-k.

PyTorch counterpart of ``gcn_recommendation_tpu/ops/quant.py``.

* ``quantize_rows_int8`` — per-row absmax scaling to int8 with
  stochastic rounding.  On a CUDA tensor it launches the hand-written
  kernel ``csrc/quant_int8.cu`` (it replaces the Pallas kernel
  ``gcn_recommendation_tpu/ops/quant.py::_quant_kernel``); on a CPU
  tensor it runs the plain PyTorch version of the same arithmetic, so
  the CPU and the card compute the same function bit for bit.
* ``quantize_users_int8`` — the same kernel's round-to-nearest mode:
  the user-side quantizer of ``quantized_topk_scores``, one launch per
  int8 request on the card.
* ``quantized_topk_scores`` — int8 x int8 -> int32 scores, per-row
  rescale, seen-item masking and top-k.  The item table is padded for
  the int8 product once (``pad_int8_table``), the user codes are written
  by the kernel straight into a padded buffer (``alloc_user_buffers``).

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


def random_bits(n: int, d: int, seed: int, device=None, row_offset: int = 0) -> torch.Tensor:
    """``[n, d]`` int64 tensor of the uint32 bits the kernel draws for
    element (row, col): ``triple32((row * d + col) ^ triple32(seed))``,
    with ``row`` the global row ``row_offset + local row``."""
    counter = torch.arange(n * d, dtype=torch.int64, device=device).reshape(n, d)
    counter = counter + int(row_offset) * d
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


def _quantize_rows_int8_reference(x: torch.Tensor, seed: int = 0, row_offset: int = 0):
    """Plain PyTorch version of the CUDA kernel (same bits, same
    arithmetic); runs on any device.  ``row_offset``: the global row of
    ``x``'s first row."""
    n, d = x.shape
    bits = random_bits(n, d, seed, device=x.device, row_offset=row_offset)
    u = (bits >> 8).to(torch.float32) * _U24_SCALE
    return _quantize_with_uniform(x, u)


def _quantize_rows_int8_nearest(x: torch.Tensor):
    """Round-to-nearest (half to even), the JAX ``use_pallas=False`` path."""
    absmax = x.abs().amax(dim=1, keepdim=True)
    scale = absmax.clamp_min(1e-12) / torch.full_like(absmax, 127.0)
    q = torch.round(x / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def _quantize_users_int8_reference(x: torch.Tensor):
    """Plain PyTorch version of the kernel's round-to-nearest mode: the
    user-side quantizer of ``quantized_topk_scores`` (half to even, the
    scale of ``_row_scale``); runs on any device."""
    scale = _row_scale(x)
    return torch.round(x / scale).clamp(-127, 127).to(torch.int8), scale


_MODE_STOCHASTIC, _MODE_NEAREST = 0, 1
# the bound launcher of csrc/quant_int8.cu and the stream lookup, both set
# at the first launch
_launcher = None
_raw_stream = None


def _bound_launcher():
    global _launcher, _raw_stream
    if _launcher is None:
        from gcn_recommendation_tpu_torch.kernels._build import load_library

        # the current stream's handle of a device index, without building a
        # torch.cuda.Stream object (5 us of a 15 us call): the function
        # Triton's launcher uses, where this PyTorch build has it
        _raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) or (
            lambda index: torch.cuda.current_stream(index).cuda_stream)
        _launcher = load_library("quant_int8").quantize_rows_int8_launch
    return _launcher


def _check_out(x: torch.Tensor, out) -> Tuple[torch.Tensor, torch.Tensor]:
    """The caller's ``(q, scales)`` buffers, checked against ``x`` [N, d]:
    q int8 [N, d] whose rows may be strided (unit stride inside a row),
    scales float32 [N, 1] contiguous, both on ``x``'s device."""
    q, scales = out
    n, d = x.shape
    ok = (
        q.dtype == torch.int8 and tuple(q.shape) == (n, d) and q.device == x.device
        and (d == 0 or q.stride(1) == 1) and (n <= 1 or q.stride(0) >= d)
        and scales.dtype == torch.float32 and tuple(scales.shape) == (n, 1)
        and scales.device == x.device and scales.is_contiguous()
    )
    if not ok:
        raise ValueError(
            f"out= wants int8 {(n, d)} with unit column stride and contiguous "
            f"float32 {(n, 1)} on {x.device}; got {q.dtype} {tuple(q.shape)} "
            f"strides {q.stride()} on {q.device} and {scales.dtype} "
            f"{tuple(scales.shape)} on {scales.device}"
        )
    return q, scales


def _empty_out(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    n, d = x.shape
    return (torch.empty((n, d), dtype=torch.int8, device=x.device),
            torch.empty((n, 1), dtype=torch.float32, device=x.device))


def _launch_quantizer(wrapper, x: torch.Tensor, mode: int, seed: int, out, row_offset: int = 0):
    """Launch csrc/quant_int8.cu on ``x``'s device and the calling
    thread's current stream, and add one to ``wrapper.launches``; raises
    when the kernel cannot take ``x`` or the launch is refused.  Returns
    (q, scales): ``out`` when given, else new tensors.  The host's part of a call is kept short: the launcher
    is bound once, plain ints go to ctypes (the argument types are
    declared), and the device context is entered only when ``x`` does not
    lie on the thread's current device."""
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(
            f"quant_int8 kernel takes a contiguous 2-D float32 tensor, got "
            f"{x.dtype} {tuple(x.shape)} contiguous={x.is_contiguous()}"
        )
    q, scales = _empty_out(x) if out is None else _check_out(x, out)
    n, d = x.shape
    if n == 0 or d == 0:
        return q, scales
    fn = _launcher or _bound_launcher()
    index = x.device.index
    if index == torch.cuda.current_device():
        err = fn(x.data_ptr(), q.data_ptr(), scales.data_ptr(), n, d, q.stride(0),
                 mode, seed & _U32, row_offset, _raw_stream(index))
    else:
        with torch.cuda.device(index):
            err = fn(x.data_ptr(), q.data_ptr(), scales.data_ptr(), n, d, q.stride(0),
                     mode, seed & _U32, row_offset, _raw_stream(index))
    if err != 0:
        raise RuntimeError(f"quant_int8 kernel launch failed: CUDA error {err}")
    wrapper.launches += 1
    return q, scales


def _write_out(result, x: torch.Tensor, out):
    """A plain version's ``result``, copied into the caller's buffers
    when there are any."""
    if out is None:
        return result
    q, scales = _check_out(x, out)
    q.copy_(result[0])
    scales.copy_(result[1])
    return q, scales


def quantize_rows_int8(
    x: torch.Tensor, seed: int = 0, use_kernel: bool = True, out=None, row_offset: int = 0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise int8 quantization of ``x`` [N, d] float32.

    Returns (q int8 [N, d], scales float32 [N, 1]).  ``use_kernel``:
    stochastic rounding — the CUDA kernel on a CUDA tensor (it launches
    or raises), its plain version on a CPU tensor.  ``use_kernel=False``:
    round-to-nearest with the divided scale, on any device.  ``out=(q,
    scales)``: buffers the caller owns, written in place and returned
    (``q``'s rows may be strided), so the call allocates nothing.
    ``row_offset``: the global row of ``x``'s first row in the random
    counter; a shard of a table that starts there gets the codes of the
    whole table's rows (stochastic mode).
    """
    if row_offset < 0:
        raise ValueError(f"row_offset must be >= 0, got {row_offset}")
    if not use_kernel:
        return _write_out(_quantize_rows_int8_nearest(x), x, out)
    if x.device.type == "cuda":
        return _launch_quantizer(quantize_rows_int8, x, _MODE_STOCHASTIC, int(seed), out,
                                 int(row_offset))
    if x.device.type == "cpu":
        return _write_out(_quantize_rows_int8_reference(x, seed, row_offset), x, out)
    raise ValueError(f"quantize_rows_int8: unsupported device {x.device}")


def quantize_users_int8(x: torch.Tensor, out=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Round-to-nearest int8 quantization of a user batch ``x`` [B, d]
    float32 with the scale ``max(absmax, 1e-12) * f32(1/127)``: what
    ``quantized_topk_scores`` does to its users.  On a CUDA tensor one
    launch of the kernel's nearest mode (it launches or raises); on a CPU
    tensor the plain version.  ``out`` as in ``quantize_rows_int8``."""
    if x.device.type == "cuda":
        return _launch_quantizer(quantize_users_int8, x, _MODE_NEAREST, 0, out)
    if x.device.type == "cpu":
        return _write_out(_quantize_users_int8_reference(x), x, out)
    raise ValueError(f"quantize_users_int8: unsupported device {x.device}")


# kernel launches of each mode since the last reset (the chip smoke test
# reads them)
quantize_rows_int8.launches = 0
quantize_users_int8.launches = 0

# torch._int_mm wants more than 16 rows on its left and inner and output
# widths that are multiples of 8
_INT_MM_MIN_ROWS = 32
_INT_MM_ALIGN = 8


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def pad_int8_table(item_q: torch.Tensor) -> torch.Tensor:
    """``item_q`` [I, d] int8 with zero rows and columns added up to
    multiples of 8, the shape the int8 product takes; the tensor itself
    when it already has it.  A server pads its catalog once, at load:
    ``quantized_topk_scores`` then copies nothing of it per request."""
    n, d = item_q.shape
    n_pad, d_pad = _round_up(n, _INT_MM_ALIGN), _round_up(d, _INT_MM_ALIGN)
    if (n_pad, d_pad) == (n, d):
        return item_q
    return torch.nn.functional.pad(item_q, (0, d_pad - d, 0, n_pad - n))


def alloc_user_buffers(b: int, d: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zeroed buffers for a batch of ``b`` users: (codes int8
    [max(32, b), round_up(d, 8)], scales float32 [b, 1]).  The quantizer
    writes the codes' [:b, :d] corner; the rest stays zero, which adds
    nothing to an integer dot product.  A caller that serves one batch
    shape again and again keeps them and passes them as ``user_buffers``."""
    return (
        torch.zeros((max(_INT_MM_MIN_ROWS, b), _round_up(d, _INT_MM_ALIGN)),
                    dtype=torch.int8, device=device),
        torch.empty((b, 1), dtype=torch.float32, device=device),
    )


def _int8_scores(u_q: torch.Tensor, item_q: torch.Tensor) -> torch.Tensor:
    """``u_q @ item_q.T`` with int32 accumulation over padded operands
    (``alloc_user_buffers``, ``pad_int8_table``).  On CUDA through
    ``torch._int_mm`` (the JAX package leaves this product to XLA); on the
    CPU an int32 matmul."""
    if u_q.device.type == "cuda":
        return torch._int_mm(u_q, item_q.T)
    return u_q.to(torch.int32) @ item_q.to(torch.int32).T


def quantized_scores(
    user_emb_batch: torch.Tensor,  # [B, d] float32
    item_q: torch.Tensor,          # [I, d] int8, or padded by pad_int8_table
    item_scale: torch.Tensor,      # [I, 1] float32
    user_buffers=None,
) -> torch.Tensor:
    """[B, I] float32 scores against an int8 item table: the user batch is
    quantized round-to-nearest per row (``quantize_users_int8``: one kernel
    launch on the card), scores are int8 x int8 -> int32, rescaled as
    ``s32 * u_scale * item_scale.T`` (the JAX order).  ``user_buffers``:
    what ``alloc_user_buffers(B, d, device)`` returned, kept by the caller."""
    b, d = user_emb_batch.shape
    n = item_scale.shape[0]
    if user_buffers is None:
        user_buffers = alloc_user_buffers(b, d, user_emb_batch.device)
    codes, u_scale = user_buffers
    quantize_users_int8(user_emb_batch, out=(codes[:b, :d], u_scale))
    s32 = _int8_scores(codes, pad_int8_table(item_q))[:b, :n]
    return s32.to(torch.float32) * u_scale * item_scale[:, 0][None, :]


def quantized_topk_scores(
    user_emb_batch: torch.Tensor,  # [B, d] float32
    item_q: torch.Tensor,          # [I, d] int8, or padded by pad_int8_table
    item_scale: torch.Tensor,      # [I, 1] float32
    filter_idx: torch.Tensor,      # [B, F] int64, padded with I
    k: int,
    user_buffers=None,
):
    """Masked top-k over an int8 item table (``quantized_scores``)."""
    scores = quantized_scores(user_emb_batch, item_q, item_scale, user_buffers)
    return masked_topk(scores, filter_idx, k)
