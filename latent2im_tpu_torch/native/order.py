"""The native loader's epoch order: ``std::shuffle`` of libstdc++ 12 driven
by ``std::mt19937_64(seed)``, in Python, so that the port draws the same
order on every machine whatever C++ library it has.

libstdc++'s ``std::shuffle`` (bits/stl_algo.h) over N elements with a
64-bit generator takes the paired path (its range 2^64 - 1 holds N² for
any N here): for even N it first swaps element 1 with a position drawn from
[0, 1]; then, for each pair of elements i, i + 1, one draw from
[0, (i + 1)(i + 2) - 1] gives both swap positions (``__gen_two_uniform_ints``:
x / (i + 2) and x % (i + 2)). Each draw is ``uniform_int_distribution``'s
downscale for a generator of exactly 64 bits (bits/uniform_int_dist.h):
Lemire's multiply over 128 bits (``_S_nd``), drawing again while the low
half lies under (-range) % range.
"""

from __future__ import annotations

import numpy as np

_M64 = (1 << 64) - 1
_N, _MID = 312, 156
_MATRIX_A = np.uint64(0xB5026F5AA96619E9)
_UPPER, _LOWER = np.uint64(0xFFFFFFFF80000000), np.uint64(0x7FFFFFFF)


class MT19937_64:
    """``std::mt19937_64``: the 64-bit Mersenne twister with the C++
    standard's parameters and seeding; ``__call__`` -> the next 64-bit
    word. The twist runs over the whole state in numpy."""

    def __init__(self, seed: int = 5489):
        mt = [int(seed) & _M64]
        for i in range(1, _N):
            prev = mt[-1]
            mt.append((6364136223846793005 * (prev ^ (prev >> 62)) + i) & _M64)
        self._mt = np.array(mt, np.uint64)
        self._out: list = []
        self._i = 0

    def _twist(self) -> None:
        mt = self._mt
        one = np.uint64(1)
        for lo, hi in ((0, _N - _MID), (_N - _MID, _N - 1)):
            # element k mixes k, k + 1 and k + 156 (mod 312), the later ones
            # already new for k >= 156: two slices in order, then the last
            y = (mt[lo:hi] & _UPPER) | (mt[lo + 1:hi + 1] & _LOWER)
            src = np.roll(mt, -_MID)[lo:hi]
            mt[lo:hi] = src ^ (y >> one) ^ np.where(y & one, _MATRIX_A, np.uint64(0))
        y = (mt[_N - 1] & _UPPER) | (mt[0] & _LOWER)
        mt[_N - 1] = mt[_MID - 1] ^ (y >> one) ^ (_MATRIX_A if y & one else np.uint64(0))
        # tempering
        z = mt.copy()
        z ^= (z >> np.uint64(29)) & np.uint64(0x5555555555555555)
        z ^= (z << np.uint64(17)) & np.uint64(0x71D67FFFEDA60000)
        z ^= (z << np.uint64(37)) & np.uint64(0xFFF7EEE000000000)
        z ^= z >> np.uint64(43)
        self._out = z.tolist()
        self._i = 0

    def __call__(self) -> int:
        if self._i >= len(self._out):
            self._twist()
        v = self._out[self._i]
        self._i += 1
        return v


def uniform_below(g: MT19937_64, n: int) -> int:
    """``uniform_int_distribution<uint64_t>{0, n - 1}(g)`` -> [0, n)."""
    prod = g() * n
    low = prod & _M64
    if low < n:
        threshold = (-n) % n  # (2^64 - n) % n in 64-bit arithmetic
        while low < threshold:
            prod = g() * n
            low = prod & _M64
    return prod >> 64


def std_shuffle(order: list, seed: int) -> None:
    """``std::shuffle(order.begin(), order.end(), std::mt19937_64(seed))``
    in place."""
    n = len(order)
    if n == 0:
        return
    g = MT19937_64(seed)
    i = 1
    if n % 2 == 0:
        j = uniform_below(g, 2)
        order[i], order[j] = order[j], order[i]
        i += 1
    while i < n:
        r = i + 1  # the swap range of element i
        x = uniform_below(g, r * (r + 1))
        a, b = x // (r + 1), x % (r + 1)
        order[i], order[a] = order[a], order[i]
        order[i + 1], order[b] = order[b], order[i + 1]
        i += 2
