"""Counter-based RNG primitives (TEA-8 hash + LCG), bit-exact with
:mod:`pota_tpu.utils.rng`.

PyTorch has no shift operators for ``uint32`` on the CPU, so 32-bit words
ride ``int64`` tensors holding values in ``[0, 2**32)``; every update is
masked back to 32 bits.  The products stay below 2**53 (an LCG state times
1664525), so no step overflows the 64-bit lane.
"""
from __future__ import annotations

import torch

from . import trace

MASK32 = 0xFFFFFFFF
_TEA_DELTA = 0x9E3779B9
_LCG_MUL = 1664525
_LCG_ADD = 1013904223


def as_u32(value, device=None) -> torch.Tensor:
    """A uint32 word (or tensor of words) as an int64 tensor in [0, 2**32)."""
    if device is not None and not isinstance(value, torch.Tensor):
        trace.host_write(device)
    t = torch.as_tensor(value, device=device)
    return t.to(torch.int64) & MASK32


def _device_of(*vals):
    for v in vals:
        if isinstance(v, torch.Tensor):
            return v.device
    return None


def tea(val0, val1, rounds: int = 8) -> torch.Tensor:
    """Tiny Encryption Algorithm hash of two uint32 words -> uint32 (int64)."""
    dev = _device_of(val0, val1)
    v0 = as_u32(val0, dev)
    v1 = as_u32(val1, dev)
    v0, v1 = torch.broadcast_tensors(v0, v1)
    s0 = 0
    for _ in range(rounds):
        s0 = (s0 + _TEA_DELTA) & MASK32
        v0 = (v0 + (((v1 << 4) + 0xA341316C) ^ (v1 + s0)
                    ^ ((v1 >> 5) + 0xC8013EA4))) & MASK32
        v1 = (v1 + (((v0 << 4) + 0xAD90777D) ^ (v0 + s0)
                    ^ ((v0 >> 5) + 0x7E95761E))) & MASK32
    return v0


def lcg_step(state: torch.Tensor):
    """One LCG step; returns (new_state, uniform in [0, 1)) from the low 24
    bits of the state."""
    state = (state * _LCG_MUL + _LCG_ADD) & MASK32
    u = (state & 0x00FFFFFF).to(torch.float32) / float(0x01000000)
    return state, u


def uniforms(key0, key1, n: int) -> torch.Tensor:
    """``n`` uniforms per element: TEA-seed an LCG and step it.  Returns
    shape ``broadcast(key0, key1).shape + (n,)``."""
    state = tea(key0, key1)
    outs = []
    for _ in range(n):
        state, u = lcg_step(state)
        outs.append(u)
    return torch.stack(outs, -1)


def hash_uniform(key0, key1) -> torch.Tensor:
    """One uniform in [0, 1) per (key, counter) pair: TEA and one LCG
    step."""
    return uniforms(key0, key1, 1)[..., 0]


def retry_uniforms(r1, r2, key, tries: int):
    """A camera's ``tries`` = K aperture candidates' uniform pairs (r1k,
    r2k), [N, K] each: candidate 0 on the ray's own (r1, r2) [N], candidate
    k >= 1 on two LCG steps after TEA-8(key, k), ``key`` [N] the rays'
    uint32 retry keys (unread when K is 1: it may be None)."""
    if tries == 1:
        return r1[:, None], r2[:, None]
    tries_idx = torch.arange(1, tries, dtype=torch.int64, device=r1.device)
    us = uniforms(key[:, None], tries_idx[None, :], 2)
    return (torch.cat([r1[:, None], us[..., 0]], 1),
            torch.cat([r2[:, None], us[..., 1]], 1))
