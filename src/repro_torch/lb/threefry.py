"""``jax.random``'s threefry draws in numpy, bit for bit (the §6 what-if bases).

The reference draws the h estimate's ``[N, K]`` standard-normal bases with
``jax.random.split`` and ``jax.random.normal`` under ``PRNGKey(seed)``
(``repro.lb.jit_optimizer._draw_what_if``).  This module computes the same
float64 numbers without JAX, as the compiled XLA CPU code computes them with
``jax_threefry_partitionable=True`` (the default of current JAX):

* :func:`threefry2x32` is the Threefry-2x32 hash (5 × 4 rounds, key
  schedule with the ``0x1BD11BDA`` parity word);
* :func:`split` and :func:`random_bits` hash the ``uint64`` iota of the
  output shape, split into its high and low 32-bit words (the
  partitionable layout); 64-bit bits are ``hi << 32 | lo``;
* :func:`uniform` keeps the top 52 bits as the mantissa of a number in
  ``[1, 2)``, subtracts 1 and scales to ``[minval, maxval)``;
* :func:`normal` is ``√2 · erf_inv(u)`` for ``u`` uniform on
  ``[nextafter(-1, 0), 1)``.

Two details of the compiled code decide the last bits.  XLA's float64
``erf_inv`` (a Giles-style polynomial in three ranges of
``w = -log1p(-x²)``) and its ``log1p`` (a Cephes rational function for
``|t| < √2 − 1``, else ``log(1 + t)``) have every Horner step
``c + p·w`` contracted into a fused multiply-add by the CPU backend, and the
large branch calls the C library's ``log``.  So :func:`fma` rounds those
steps once, and :func:`_libm_log` calls ``math.log`` (numpy's vectorised
``np.log`` is a different approximation that differs in the last bit on
some draws).

>>> normal(split(PRNGKey(0))[0], (3,))[0]
np.float64(1.8800298928929466)
"""

from __future__ import annotations

import math

import numpy as np

_U32 = np.uint32
_M32 = np.uint64(0xFFFFFFFF)
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = _U32(0x1BD11BDA)


def _rotl(x, d: int):
    return (x << _U32(d)) | (x >> _U32(32 - d))


def threefry2x32(k1, k2, x0, x1):
    """Threefry-2x32 of the count words ``(x0, x1)`` (uint32 arrays of one
    shape) under the key ``(k1, k2)``; returns the two output words."""
    ks = (_U32(k1), _U32(k2), _U32(_U32(k1) ^ _U32(k2) ^ _PARITY))
    x0 = np.asarray(x0, _U32)
    x1 = np.asarray(x1, _U32)
    with np.errstate(over="ignore"):
        x0 = x0 + ks[0]
        x1 = x1 + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = x0 ^ _rotl(x1, r)
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + _U32(i + 1)
    return x0, x1


def PRNGKey(seed: int) -> np.ndarray:
    """The raw ``[2]`` uint32 key of an integer seed: its high and low words."""
    seed = int(seed)
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], _U32)


def _iota_2x32(shape) -> tuple[np.ndarray, np.ndarray]:
    idx = np.arange(math.prod(shape), dtype=np.uint64).reshape(shape)
    return (idx >> np.uint64(32)).astype(_U32), (idx & _M32).astype(_U32)


def _hash_iota(key, shape):
    hi, lo = _iota_2x32(tuple(shape))
    return threefry2x32(key[0], key[1], hi, lo)


def split(key, num: int = 2) -> np.ndarray:
    """``[num, 2]`` uint32 subkeys, as ``jax.random.split``."""
    b1, b2 = _hash_iota(key, (num,))
    return np.stack([b1, b2], axis=-1)


def random_bits(key, shape) -> np.ndarray:
    """64 random bits per element (uint64), as ``jax.random.bits``."""
    b1, b2 = _hash_iota(key, shape)
    return (b1.astype(np.uint64) << np.uint64(32)) | b2.astype(np.uint64)


def uniform(key, shape, minval: float = 0.0, maxval: float = 1.0) -> np.ndarray:
    """float64 uniform on ``[minval, maxval)``, as ``jax.random.uniform``.
    ``floats·(maxval − minval)`` is exact for the normal's range (a factor of
    2), so whether XLA contracts the ``+ minval`` changes no bit there."""
    bits = random_bits(key, shape)
    mantissa = (bits >> np.uint64(12)) | np.uint64(0x3FF0000000000000)
    floats = mantissa.view(np.float64) - 1.0
    lo, hi = np.float64(minval), np.float64(maxval)
    return np.maximum(lo, floats * (hi - lo) + lo)


def normal(key, shape) -> np.ndarray:
    """float64 standard normals, as ``jax.random.normal(key, shape, float64)``."""
    lo = np.nextafter(np.float64(-1.0), np.float64(0.0))
    u = uniform(key, shape, lo, 1.0)
    return np.float64(math.sqrt(2)) * erf_inv(u)


# ---------------------------------------------------------------------------
# float64 arithmetic as XLA's CPU backend compiles it
# ---------------------------------------------------------------------------

_SPLIT = 134217729.0  # 2^27 + 1: Veltkamp's splitter for 53-bit doubles


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _two_prod(a, b):
    p = a * b
    ca = a * _SPLIT
    ah = ca - (ca - a)
    al = a - ah
    cb = b * _SPLIT
    bh = cb - (cb - b)
    bl = b - bh
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def fma(a, b, c) -> np.ndarray:
    """``a·b + c`` rounded once (Boldo and Melquiond's emulation: the low
    parts summed rounded to odd, then added to the high part)."""
    a, b, c = np.broadcast_arrays(*(np.asarray(v, np.float64) for v in (a, b, c)))
    uh, ul = _two_prod(a, b)
    th, tl = _two_sum(c, uh)
    s, err = _two_sum(tl, ul)
    even = (s.view(np.int64) & 1) == 0
    odd = np.where((err != 0) & even, np.nextafter(s, np.where(err > 0, np.inf, -np.inf)), s)
    return th + odd


def _log1(v: float) -> float:
    if v > 0.0:
        return math.log(v)
    return -math.inf if v == 0.0 else math.nan


def _libm_log(x: np.ndarray) -> np.ndarray:
    """The C library's ``log`` (``-inf`` at 0), which XLA's CPU code calls."""
    flat = np.asarray(x, np.float64).ravel()
    return np.fromiter((_log1(v) for v in flat), np.float64, flat.size).reshape(np.shape(x))


# Cephes' log1p rational function for |t| < √2 − 1 (XLA's ``EmitLog1p``).
_LOG1P_DEN = (1.0, 15.062909083469192, 83.04756596796722, 221.76239823732857,
              309.09872225312057, 216.42788614495947, 60.11866049760384)
_LOG1P_NUM = (4.52700008624452e-05, 0.49854102823193375, 6.578732594206104,
              29.911919328553072, 60.94966798098779, 57.11296359058554, 20.039553499201283)
_LOG1P_SMALL = 0.41421356237309503  # √2 − 1


def log1p(t: np.ndarray) -> np.ndarray:
    """XLA's float64 ``log1p`` for ``t ≤ 0`` (the only inputs ``erf_inv``
    gives it, ``t = -x²``).  Above ``t`` is ``x·(−x)``: ``t·0`` starts both
    Horner chains unfused (it has two uses), every later step is an FMA,
    and ``−t²/2 + t³·r`` fuses the exact ``t²·(−½)``."""
    t = np.asarray(t, np.float64)
    t2 = t * t
    z = t * 0.0
    den = z + _LOG1P_DEN[0]
    for c in _LOG1P_DEN[1:]:
        den = fma(den, t, c)
    num = z + _LOG1P_NUM[0]
    for c in _LOG1P_NUM[1:]:
        num = fma(num, t, c)
    small = t + fma(t2, -0.5, (t * t2) * (num / den))
    big = np.abs(t) >= _LOG1P_SMALL
    out = small.copy()
    out[big] = _libm_log(t[big] + 1.0)
    return out


# XLA's float64 erf_inv: coefficient i for w < 6.25, w < 16 and w ≥ 16
# (steps 17-18 apply only below 16, steps 19-22 only below 6.25).
_ERFINV = (
    (-3.64441206401782e-21, 2.2137376921775787e-09, -2.7109920616438573e-11),
    (-1.6850591381820166e-19, 9.075656193888539e-08, -2.555641816996525e-10),
    (1.28584807152564e-18, -2.7517406297064545e-07, 1.5076572693500548e-09),
    (1.1157877678025181e-17, 1.8239629214389228e-08, -3.789465440126737e-09),
    (-1.333171662854621e-16, 1.5027403968909828e-06, 7.61570120807834e-09),
    (2.0972767875968562e-17, -4.013867526981546e-06, -1.496002662714924e-08),
    (6.637638134358324e-15, 2.9234449089955446e-06, 2.914795345090108e-08),
    (-4.054566272975207e-14, 1.2475304481671779e-05, -6.771199775845234e-08),
    (-8.151934197605472e-14, -4.7318229009055734e-05, 2.2900482228026655e-07),
    (2.6335093153082323e-12, 6.828485145957318e-05, -9.9298272942317e-07),
    (-1.2975133253453532e-11, 2.4031110387097894e-05, 4.526062597223154e-06),
    (-5.415412054294628e-11, -0.0003550375203628475, -1.968177810553167e-05),
    (1.0512122733215323e-09, 0.0009532893797373805, 7.599527703001776e-05),
    (-4.112633980346984e-09, -0.0016882755560235047, -0.00021503011930044477),
    (-2.9070369957882005e-08, 0.002491442096107851, -0.00013871931833623122),
    (4.2347877827932404e-07, -0.003751208507569241, 1.0103004648645344),
    (-1.3654692000834679e-06, 0.005370914553590064, 4.849906401408584),
    (-1.3882523362786469e-05, 1.0052589676941592),
    (0.00018673420803405714, 3.0838856104922208),
    (-0.000740702534166267,),
    (-0.006033670871430149,),
    (0.24015818242558962,),
    (1.6536545626831027,),
)


def erf_inv(x: np.ndarray) -> np.ndarray:
    """XLA's float64 ``erf_inv`` on ``(-1, 1)``; ``±1`` give ``±inf``."""
    x = np.asarray(x, np.float64)
    with np.errstate(invalid="ignore"):  # ±1: inf arithmetic, replaced below
        return _erf_inv(x)


def _erf_inv(x: np.ndarray) -> np.ndarray:
    w = -log1p(x * (-x))
    lt625 = w < 6.25
    lt16 = w < 16.0
    ww = np.where(lt625, w - 3.125, np.sqrt(w) - np.where(lt16, 3.25, 5.0))

    def coef(i):
        c = _ERFINV[i]
        if len(c) == 3:
            return np.where(lt16, np.where(lt625, c[0], c[1]), c[2])
        if len(c) == 2:
            return np.where(lt625, c[0], c[1])
        return c[0]

    p = np.broadcast_to(coef(0), x.shape)
    for i in range(1, len(_ERFINV)):
        step = fma(p, ww, coef(i))
        p = step if i < 17 else np.where(lt16 if i < 19 else lt625, step, p)
    return np.where(np.abs(x) == 1.0, x * np.inf, p * x)
