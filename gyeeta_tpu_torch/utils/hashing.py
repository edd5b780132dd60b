"""Vectorized 32/64-bit hashing for sketch indexing (numpy + torch).

Counterpart of ``gyeeta_tpu/utils/hashing.py``. Every function has the
same semantics on numpy arrays (the host path the decoder uses, copied
as is) and on torch tensors (the device path), so host decoders and
tests reproduce device indices bit-exactly.

**The u32 carrier.** PyTorch has no ``>>``/``<<`` for ``torch.uint32`` on
the CPU, so on the torch path an unsigned 32-bit value travels in an
``int64`` tensor holding a value in ``[0, 2**32)``. Every multiply and
add is masked with ``0xFFFFFFFF`` right after it; a shift of a
non-negative int64 is a logical shift, and an int64 product of two
values below ``2**32`` keeps its low 32 bits right when it wraps. Every
uint32 leaf of the engine state (table keys, top-K keys, invertible
``enc_*``/``fp``, task/api ids) uses the same carrier. Bucket and row
indices come back as ``int32``, like the reference's.

``torch`` is imported inside the tensor branches only: the agent tier
hashes on the host and loads no ``torch``.
"""

from __future__ import annotations

import numpy as np

# Murmur3 / splitmix constants.
_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35
_GOLDEN = 0x9E3779B9  # 2^32 / phi — per-salt stream separator
M32 = 0xFFFFFFFF


def _is_np(x) -> bool:
    return isinstance(x, (np.ndarray, np.generic, int))


def u32(x: torch.Tensor) -> torch.Tensor:
    """Any integer tensor → the int64 u32 carrier (two's-complement
    reinterpretation of negative int32, like ``astype(uint32)``)."""
    import torch
    return x.to(torch.int64) & M32


def fmix32(h):
    """Murmur3 32-bit finalizer: bijective avalanche mix of uint32 values."""
    if _is_np(h):
        h = np.asarray(h, dtype=np.uint32)
        with np.errstate(over="ignore"):
            h = h ^ (h >> np.uint32(16))
            h = h * np.uint32(_C1)
            h = h ^ (h >> np.uint32(13))
            h = h * np.uint32(_C2)
            h = h ^ (h >> np.uint32(16))
        return h
    h = u32(h)
    h = h ^ (h >> 16)
    h = (h * _C1) & M32
    h = h ^ (h >> 13)
    h = (h * _C2) & M32
    h = h ^ (h >> 16)
    return h


def mix64(hi, lo, salt: int = 0):
    """Mix a 64-bit key given as (hi, lo) uint32 halves into one uint32.

    ``salt`` selects an independent hash stream (e.g. one per Count-Min row).
    """
    if _is_np(hi):
        hi = np.asarray(hi, dtype=np.uint32)
        lo = np.asarray(lo, dtype=np.uint32)
        with np.errstate(over="ignore"):
            s = np.uint32((salt + 1) & 0xFFFFFFFF) * np.uint32(_GOLDEN)
            h = fmix32(lo ^ s)
            h = fmix32(hi ^ h ^ np.uint32(salt & 0xFFFFFFFF))
        return h
    s = (((salt + 1) & M32) * _GOLDEN) & M32
    h = fmix32(u32(lo) ^ s)
    return fmix32(u32(hi) ^ h ^ (salt & M32))


def bucket_indices_km(hi, lo, depth: int, nbuckets: int) -> list:
    """Per-row buckets for a ``depth``-row sketch via Kirsch-Mitzenmacher
    double hashing: ``bucket_r = range_map(h1 + r·h2)``, ``h2`` forced odd."""
    h1 = mix64(hi, lo, 0xC035)
    h2 = mix64(hi, lo, 0x51ED)
    if _is_np(h1):
        with np.errstate(over="ignore"):
            h2 = h2 | np.uint32(1)
            return [_range_map(h1 + np.uint32(r) * h2, nbuckets)
                    for r in range(depth)]
    h2 = h2 | 1
    return [_range_map((h1 + r * h2) & M32, nbuckets) for r in range(depth)]


def _range_map(h, nbuckets: int):
    """Uniform u32 → [0, nbuckets) (Lemire high-multiply)."""
    if _is_np(h):
        return ((h.astype(np.uint64) * np.uint64(nbuckets))
                >> np.uint64(32)).astype(np.int32)
    import torch
    # h < 2^32 and nbuckets < 2^31: the int64 product cannot overflow
    return ((h * nbuckets) >> 32).to(torch.int32)


def bucket_index(hi, lo, salt: int, nbuckets: int):
    """Map a 64-bit key to a bucket in [0, nbuckets) for hash stream ``salt``."""
    return _range_map(mix64(hi, lo, salt), nbuckets)


def leading_zeros32(x):
    """Count leading zeros of each uint32 → int32 in [0, 32]."""
    if _is_np(x):
        x = np.asarray(x, dtype=np.uint32)
        n = np.zeros(x.shape, dtype=np.int32)
        y = x
        for shift in (16, 8, 4, 2, 1):
            mask = y > np.uint32((1 << shift) - 1)
            n = np.where(mask, n, n + shift)
            y = np.where(mask, y >> np.uint32(shift), y)
        return np.where(x == 0, np.int32(32), n).astype(np.int32)
    import torch
    x = u32(x)
    n = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    y = x
    for shift in (16, 8, 4, 2, 1):
        mask = y > ((1 << shift) - 1)
        n = torch.where(mask, n, n + shift)
        y = torch.where(mask, y >> shift, y)
    return torch.where(x == 0, torch.full_like(n, 32), n)


def flow_key(saddr_hi, saddr_lo, daddr_hi, daddr_lo, sport, dport, proto):
    """Collapse a flow 5-tuple into a 64-bit (hi, lo) key."""
    if _is_np(sport):
        ports = ((np.asarray(sport, np.uint32) << np.uint32(16))
                 | (np.asarray(dport, np.uint32) & np.uint32(0xFFFF)))
    else:
        ports = ((u32(sport) << 16) & M32) | (u32(dport) & 0xFFFF)
    a = mix64(saddr_hi, saddr_lo, 1)
    b = mix64(daddr_hi, daddr_lo, 2)
    if _is_np(a):
        with np.errstate(over="ignore"):
            lo = fmix32(a ^ (ports * np.uint32(_C1)))
            hi = fmix32(b ^ (np.asarray(proto, np.uint32) * np.uint32(_C2))
                        ^ lo)
        return hi, lo
    lo = fmix32(a ^ ((ports * _C1) & M32))
    hi = fmix32(b ^ ((u32(proto) * _C2) & M32) ^ lo)
    return hi, lo


def hash_bytes_np(data: bytes, salt: int = 0) -> int:
    """Host-only: hash arbitrary bytes to a 64-bit int (interned string
    ids: comm names, API signatures)."""
    h = np.uint32(0x811C9DC5 ^ (salt & 0xFFFFFFFF))
    g = np.uint32(0x01000193)
    with np.errstate(over="ignore"):
        # FNV over 4-byte words, tail handled by padding.
        pad = (-len(data)) % 4
        w = np.frombuffer(data + b"\x00" * pad, dtype=np.uint32)
        h1 = h
        h2 = h ^ np.uint32(_GOLDEN)
        for word in w:
            h1 = (h1 ^ word) * g
            h2 = fmix32(h2 + word)
        h1 = fmix32(h1 ^ np.uint32(len(data)))
        h2 = fmix32(h2 ^ h1)
    return (int(h2) << 32) | int(h1)
