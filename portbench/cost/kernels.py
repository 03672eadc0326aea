"""Bytes and operations of one call into the port's three kernels, and the
least time the card could take for it.

Every call is described by the arguments it gets at the op's entry (shapes
and element sizes alone are read), so the count is of the work, whatever
kernel does it. The formulas are `chip_smoke.py`'s: each input byte read
once and each output byte written once; the operations that the
algorithm needs, with the seed's transposed conv counting only the taps
that read inside the map (`conv_pairs`).

Ops and their arguments:

* `tprelu` (x, a, b) and `tprelu_backward` (x, a, b, g, need_ab);
* `lis` (z, w1, b1, slope, trans, w2, b2) and `lis_chain_backward`
  (zs, w1s, b1s, slopes, transes, w2s, gs, needs);
* `seed` (z, wp, bp, slope, trans, wc, bc, s0) and `seed_backward`
  (z, wp, bp, slope, trans, wc, bc, g, s0, need).
"""

from __future__ import annotations

from typing import Sequence, Tuple

from portbench.cost.peaks import HBM_BYTES_PER_S, PEAK_FLOPS


def dtype_name(t) -> str:
    return str(t.dtype).replace("torch.", "")


def conv_pairs(s0: int) -> int:
    """The (output pixel, tap) pairs of the seed's transposed conv (4x4,
    stride 2, padding 1, s0 x s0 -> 2s0 x 2s0) that read inside the map:
    (4 s0 - 2)^2."""
    return (4 * s0 - 2) ** 2


def bound(nbytes: float, nops: float, dtype: str) -> Tuple[float, str]:
    """(least ms, "bytes" or "operations"): the larger of bytes over the
    HBM rate and operations over the dtype's peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tprelu_cost(x) -> Tuple[float, float]:
    m_c, c = x.numel(), x.shape[-1]
    e = x.element_size()
    return 2 * m_c * e + 2 * c * e, 6 * m_c


def tprelu_backward_cost(x, need_ab: bool) -> Tuple[float, float]:
    """x and g read and dx written once, a and b read and da and db written
    in fp32; about 4 operations an element for dx, 6 more for the two
    products and sums."""
    m_c, c = x.numel(), x.shape[-1]
    return 3 * m_c * x.element_size() + 16 * c, (10 if need_ab else 4) * m_c


def lis_cost(z, w1) -> Tuple[float, float]:
    (b, code), hidden = z.shape, w1.shape[1]
    e = z.element_size()
    return e * (2 * b * code + 2 * code * hidden) + 4 * (3 * hidden + code), 4 * b * code * hidden


def seed_cost(z, wp, wc, s0: int) -> Tuple[float, float]:
    (n, code), p = z.shape, wp.shape[1]
    c0, c1 = wc.shape[2], wc.shape[3]
    e = z.element_size()
    nbytes = (e * (n * code + code * p + 16 * c0 * c1 + n * (2 * s0) ** 2 * c1)
              + 4 * (p + 2 * c0 + c1))
    return nbytes, 2 * n * code * p + 2 * n * conv_pairs(s0) * c0 * c1


def seed_backward_cost(z, wp, wc, s0: int, need: Sequence[bool]) -> Tuple[float, float]:
    """z, wp, wc, g, bp, slope and trans read and the gradients asked for
    written, the projection recomputed, the conv's data gradient (for any
    of dz .. dtrans), dz's and dwp's products and dWc's as asked."""
    (n, code), p = z.shape, wp.shape[1]
    c0, c1 = wc.shape[2], wc.shape[3]
    out = n * (2 * s0) ** 2 * c1
    conv = 2 * n * conv_pairs(s0) * c0 * c1
    e = z.element_size()
    if all(need):
        return (e * (2 * n * code + 2 * code * p + 32 * c0 * c1 + out)
                + 4 * (2 * p + 4 * c0 + 2 * c1), 6 * n * code * p + 2 * conv)
    need = [bool(x) for x in need]
    return (e * (n * code * (1 + need[0]) + code * p * (1 + need[1]) + 16 * c0 * c1 * (1 + need[5])
                 + out) + 4 * (p * (1 + need[2]) + c0 * (2 + need[3] + need[4]) + 2 * c1 * need[6]),
            2 * n * code * p * (1 + need[0] + need[1]) + conv * (any(need[:5]) + need[5]))


def lis_chain_backward_cost(zs, w1s, needs) -> Tuple[float, float]:
    """Per link from the last down to the lowest that asks for anything: z,
    W1, the vectors and g read, W2 where dh is needed, each gradient asked
    for written once (the first link's dz alone of the dz's, the small
    vectors in fp32); pre, and each of the products dh, dz, dW1, dW2 that
    is needed."""
    (b, c), h = zs[0].shape, w1s[0].shape[1]
    e = zs[0].element_size()
    first = next(j for j, n in enumerate(needs) if any(n))
    nbytes = nops = 0
    for j in range(first, len(needs)):
        need = [bool(x) for x in needs[j]]
        dh = any(need[:5])
        nbytes += e * (2 * b * c + c * h * (1 + dh)) + 4 * 3 * h
        nbytes += e * (b * c * (need[0] and j == 0) + c * h * (need[1] + need[5]))
        nbytes += 4 * (h * (need[2] + need[3] + need[4]) + c * need[6])
        nops += 2 * b * c * h * (1 + dh + need[0] + need[1] + need[5])
    return nbytes, nops


def call_cost(op: str, args: Sequence) -> Tuple[float, float, str]:
    """(bytes, operations, dtype name) of one call of `op` on `args`."""
    if op == "tprelu":
        return (*tprelu_cost(args[0]), dtype_name(args[0]))
    if op == "tprelu_backward":
        return (*tprelu_backward_cost(args[0], bool(args[4])), dtype_name(args[0]))
    if op == "lis":
        return (*lis_cost(args[0], args[1]), dtype_name(args[0]))
    if op == "lis_chain_backward":
        return (*lis_chain_backward_cost(args[0], args[1], args[7]), dtype_name(args[0][0]))
    if op == "seed":
        return (*seed_cost(args[0], args[1], args[5], int(args[7])), dtype_name(args[0]))
    if op == "seed_backward":
        return (*seed_backward_cost(args[0], args[1], args[5], int(args[8]), args[9]),
                dtype_name(args[0]))
    raise ValueError(f"no cost for op {op!r}")


def call_bound_ms(op: str, args: Sequence) -> Tuple[float, str]:
    nbytes, nops, dt = call_cost(op, args)
    return bound(nbytes, nops, dt)
