"""Counter-based RNG (counterpart of ``tpupt/sampling/rng.py``).

    u = uniform(pixel_seed(pixel_index, iteration), counter)

The generator is the Wang-style integer hash, bit-equal to the JAX
package's uint32 version.  torch covers uint32 arithmetic only in part, so
the hash runs on int64 tensors and masks to 32 bits after every add, shift
and multiply; the wraparound is then exactly uint32's.  There is no global
RNG state.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
# Odd constant (2**32 / golden ratio) decorrelates successive counters.
_GOLDEN = 0x9E3779B9


def _u32(a):
    """Tensor or Python int reduced to its uint32 value (as int64)."""
    if isinstance(a, torch.Tensor):
        return a.to(torch.int64) & _M32
    return int(a) & _M32


def _mul32(a, b: int):
    """(a * b) mod 2**32 for 32-bit a and b without int64 overflow."""
    lo = (a & 0xFFFF) * b
    hi = (((a >> 16) * b) & 0xFFFF) << 16
    return (lo + hi) & _M32


def wang_hash(a) -> torch.Tensor:
    """The reference's integer hash, uint32 semantics on int64 tensors."""
    a = _u32(a)
    a = (((a + 0x7ED55D16) & _M32) + ((a << 12) & _M32)) & _M32
    a = ((a ^ 0xC761C23C) ^ (a >> 19)) & _M32
    a = (((a + 0x165667B1) & _M32) + ((a << 5) & _M32)) & _M32
    a = (((a + 0xD3A2646C) & _M32) ^ ((a << 9) & _M32)) & _M32
    a = (((a + 0xFD7046C5) & _M32) + ((a << 3) & _M32)) & _M32
    a = ((a ^ 0xB55A4F09) ^ (a >> 16)) & _M32
    return a


def pixel_seed(pixel_index, iteration) -> torch.Tensor:
    """Per-pixel-per-sample base seed: hash(hash(index) ^ iteration)."""
    return wang_hash(wang_hash(pixel_index) ^ _u32(iteration))


def uniform(seed: torch.Tensor, counter) -> torch.Tensor:
    """U[0, 1) float32 from a base seed and a draw counter.

    Counter layout: 0, 1 sub-pixel jitter; 2 + 16*bounce + lane for bounce
    draws (lane 0/1 sphere sample, 2 fresnel, 3 russian roulette)."""
    bits = wang_hash(seed + _mul32(_u32(counter), _GOLDEN))
    return (bits >> 8).to(torch.float32) * (1.0 / 16777216.0)


def jitter_counters():
    return 0, 1


def bounce_counter(bounce, lane: int):
    """Draw counter for (bounce, lane); ``bounce`` may be a per-lane tensor."""
    return 2 + bounce * 16 + lane
