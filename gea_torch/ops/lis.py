"""One LIS link, `z + W2 @ tprelu(W1 @ z + b1) + b2`, as one CUDA kernel
(`gea_torch/csrc/lis.cu`).

Replaces `gea/ops/pallas/lis.py::lis_residual_mlp`. Same arguments and the
same rounding: both products accumulate in fp32, the TPReLU runs in fp32,
the hidden row is cast to z's dtype before the second product, and that
product (plus b2) is cast to z's dtype before the residual add.

On a CPU tensor `lis_residual_mlp` runs the plain version; on a CUDA tensor
it launches the kernel (and counts the launch in
`lis_residual_mlp.launches`) or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gea_torch.ops import build

_ROWS = 4  # rows of z per block; must match kRows in csrc/lis.cu


def lis_residual_mlp_plain(z, w1, b1, slope, trans, w2, b2) -> torch.Tensor:
    """z (B, C); w1 (C, H); w2 (H, C); b1, slope, trans (H,); b2 (C,)."""
    dt = z.dtype
    h = z.float() @ w1.float() + b1.float()
    s = h - trans.float()
    h = s.clamp_min(0) + slope.float() * s.clamp_max(0) + trans.float()
    out = h.to(dt).float() @ w2.float() + b2.float()
    return z + out.to(dt)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("lis")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gea_lis_forward.argtypes = [p] * 8 + [i, i, i, i, p]
    lib.gea_lis_forward.restype = ctypes.c_int
    return lib


def lis_residual_mlp(z, w1, b1, slope, trans, w2, b2) -> torch.Tensor:
    if z.device.type == "cpu":
        return lis_residual_mlp_plain(z, w1, b1, slope, trans, w2, b2)
    build.check_cuda_inputs("lis_residual_mlp", z, w1, b1, slope, trans, w2, b2)
    dt = z.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"lis_residual_mlp: unsupported dtype {dt}")
    batch, code = z.shape
    hidden = w1.shape[1]
    if w1.shape != (code, hidden) or w2.shape != (hidden, code):
        raise ValueError(
            f"lis_residual_mlp: w1 {tuple(w1.shape)} / w2 {tuple(w2.shape)} "
            f"do not fit z {tuple(z.shape)}"
        )
    smem = 4 * _ROWS * (code + hidden)
    if smem > 232448:
        raise ValueError(f"lis_residual_mlp: code+hidden={code + hidden} too wide")
    z = z.contiguous()
    out = torch.empty_like(z)
    if batch == 0:
        return out
    w1 = w1.to(dt).contiguous()
    w2 = w2.to(dt).contiguous()
    f32 = [v.float().contiguous() for v in (b1, slope, trans, b2)]
    lib = _lib()
    with torch.cuda.device(z.device):
        rc = lib.gea_lis_forward(
            z.data_ptr(), w1.data_ptr(), f32[0].data_ptr(), f32[1].data_ptr(),
            f32[2].data_ptr(), w2.data_ptr(), f32[3].data_ptr(), out.data_ptr(),
            batch, code, hidden, int(dt == torch.bfloat16),
            torch.cuda.current_stream(z.device).cuda_stream,
        )
    build.check(lib, rc, "lis_residual_mlp")
    lis_residual_mlp.launches += 1
    return out


lis_residual_mlp.launches = 0
