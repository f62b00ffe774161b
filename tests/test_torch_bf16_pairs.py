"""Why K1-bf16's packed bf16x2 arithmetic (csrc/walk.cu, mode 2) computes what
the plain version computes: for bf16 operands a and b, the f32 result of
a + b, a - b or a * b rounded to bf16 equals the correctly rounded bf16
result (round to nearest, ties to even), because f32's 24 bits are at least
2 * 8 + 2 and double rounding is then innocuous, subnormals included. The
card's add/sub/mul.rn.bf16x2 round each half correctly; torch's bf16
arithmetic (the plain version) rounds the f32 result.

Checked bit for bit on random finite pairs, on pairs whose exact result is
a tie, and on pairs with subnormal operands or results, against an exact
reference in numpy float64: products of two bf16 values are exact there,
and a sum is held exactly as an unevaluated pair s + e (TwoSum)."""
import numpy as np
import pytest
import torch

N_PAIRS = 20_000
BF16_MAX_EXP = 127
MIN_QUANTUM_EXP = -133  # the bf16 subnormal spacing, 2^-133


def _bf16(bits: np.ndarray) -> np.ndarray:
    """uint16 bf16 bit patterns -> their float64 values."""
    return (bits.astype(np.uint32) << 16).view(np.float32).astype(np.float64)


def _finite_bits(rng, n, exp_lo=0, exp_hi=254):
    """n random finite bf16 bit patterns with exponent fields in [exp_lo, exp_hi]."""
    sign = rng.integers(0, 2, n).astype(np.uint16) << 15
    exp = rng.integers(exp_lo, exp_hi + 1, n).astype(np.uint16) << 7
    man = rng.integers(0, 128, n).astype(np.uint16)
    return sign | exp | man


def _round_exact(s: np.ndarray, e: np.ndarray) -> np.ndarray:
    """The exact value s + e (|e| at most half an f64 ulp of s) rounded to
    the nearest bf16, ties to even -> uint16 bits."""
    neg = np.signbit(s)
    mag, err = np.abs(s), np.where(neg, -e, e)
    _, ex = np.frexp(mag)  # mag = m * 2^ex, 0.5 <= m < 1
    q = np.exp2(np.maximum(ex - 8, MIN_QUANTUM_EXP)).astype(np.float64)  # bf16 spacing at mag
    t = mag / q  # exact: a power-of-two scaling
    lo = np.floor(t)
    frac = t - lo
    up = (frac > 0.5) | ((frac == 0.5) & ((err > 0) | ((err == 0) & (lo % 2 == 1))))
    r = (lo + up) * q
    r = np.where(r >= 2.0 ** (BF16_MAX_EXP + 1), np.inf, r)
    out = np.where(neg, -r, r).astype(np.float32)  # exact: r is a bf16 value
    return (out.view(np.uint32) >> 16).astype(np.uint16)


def _exact(op: str, a: np.ndarray, b: np.ndarray):
    """(s, e) with s + e = a op b exactly."""
    if op == "mul":
        return a * b, np.zeros_like(a)  # 8 + 8 significant bits: exact in f64
    bb = b if op == "add" else -b
    s = a + bb
    t = s - a
    e = (a - (s - t)) + (bb - t)  # TwoSum
    return s, e


def _pairs(kind: str, op: str, rng):
    n = N_PAIRS
    if kind == "random":
        return _finite_bits(rng, n), _finite_bits(rng, n)
    if kind == "ties":
        if op == "mul":  # significands (1 + i/128)(1 + j/128): many products are ties
            a = (np.uint16(0x3F80) | rng.integers(0, 128, n).astype(np.uint16))
            b = (np.uint16(0x3F80) | rng.integers(0, 128, n).astype(np.uint16))
            return a, b
        # a in [1, 2) and b an odd multiple of 2^-8 below 2^-1: a +- b is an
        # odd multiple of half of a's spacing
        a = np.uint16(0x3F80) | rng.integers(0, 128, n).astype(np.uint16)
        odd = 2 * rng.integers(0, 64, n) + 1
        b_vals = (odd * 2.0 ** -8).astype(np.float32)
        return a, (b_vals.view(np.uint32) >> 16).astype(np.uint16)
    if op == "mul":  # one operand tiny, the other moderate: subnormal products
        return _finite_bits(rng, n, 1, 40), _finite_bits(rng, n, 60, 127)
    return _finite_bits(rng, n, 0, 2), _finite_bits(rng, n, 0, 2)  # subnormal operands


@pytest.mark.parametrize("kind", ["random", "ties", "subnormal"])
@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_f32_then_bf16_is_the_correctly_rounded_bf16_op(op, kind):
    rng = np.random.default_rng(["add", "sub", "mul"].index(op) * 3 + len(kind))
    a_bits, b_bits = _pairs(kind, op, rng)
    a, b = _bf16(a_bits), _bf16(b_bits)
    want = _round_exact(*_exact(op, a, b))

    ta = torch.from_numpy(a_bits.view(np.int16).copy()).view(torch.bfloat16)
    tb = torch.from_numpy(b_bits.view(np.int16).copy()).view(torch.bfloat16)
    fn = {"add": torch.add, "sub": torch.sub, "mul": torch.mul}[op]
    via_f32 = fn(ta.float(), tb.float()).to(torch.bfloat16)  # the kernel's argument
    in_bf16 = fn(ta, tb)  # the plain version's arithmetic
    for got in (via_f32, in_bf16):
        bits = got.view(torch.int16).numpy().view(np.uint16)
        bad = np.flatnonzero(bits != want)
        assert bad.size == 0, (
            f"{op} {kind}: {bad.size} differ, e.g. {a[bad[0]]!r} {op} {b[bad[0]]!r}: "
            f"got {bits[bad[0]]:#06x}, want {want[bad[0]]:#06x}"
        )

    # the cases hold what they are named for
    s, e = _exact(op, a, b)
    if kind == "ties":
        mag = np.abs(s)
        _, ex = np.frexp(mag)
        t = mag / np.exp2(np.maximum(ex - 8, MIN_QUANTUM_EXP))
        assert int(((t - np.floor(t) == 0.5) & (e == 0)).sum()) >= 100
    if kind == "subnormal":
        res = np.abs(_bf16(want))
        assert int(((res > 0) & (res < 2.0 ** -126)).sum()) >= 100
