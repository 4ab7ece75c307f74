"""Partition digits of join keys.

One int32 digit a row, in [0, 2^p_bits]: the low p_bits of the key's
hash32 (or of its low 32 bits, unhashed), and 2^p_bits for KEY_SENTINEL
rows, whose partition never gets a build block. The kernel computes the
hash in registers with uint32 wrap-around, so it moves 8 bytes a row for
int32 keys and 12 for int64; 16-byte vectors where the keys allow them.
"""
from __future__ import annotations

import torch

from . import _build, ref
from ._build import I32, I64, PTR
from .common import Launch, ceil_div, register

# the widest digit an int32 holds with the sentinel partition 2^p_bits
MAX_BITS = 30


@register("partition_digits", rows="n",
          entries={"partition_digits": (PTR, I64, I32, I32, I32, PTR, PTR, I32)},
          config=lambda a: (PTR(a.get("keys_addr", 0)), I64(a["n"]), I32(a["key_bytes"]),
                            PTR(a.get("out_addr", 0))),
          instances=("partition_digits<4, false>", "partition_digits<4, true>",
                     "partition_digits<8, false>", "partition_digits<8, true>"))
def PARTITION_DIGITS(a, sms, per_sm):
    # partition_digits.cu, config: 256 threads, a block for every 4,096 rows
    # (the card's size plays no part); vectors where the keys at out's first
    # 16-byte boundary lie on one
    n, kb = a["n"], a["key_bytes"]
    head = min((16 - a.get("out_addr", 0) % 16) % 16 // 4, n)
    vec = (a.get("keys_addr", 0) + kb * head) % 16 == 0
    inst = PARTITION_DIGITS.instances[2 * (kb == 8) + int(vec)]
    rows = (n - head) // 4 * 4 if vec else n
    return Launch("partition_digits", inst, 256, 0, (max(ceil_div(rows, 256 * 16), 1), 1, 1))


def check(keys: torch.Tensor, p_bits: int) -> None:
    """TypeError for keys that are not integers, ValueError for a p_bits
    whose sentinel digit 2^p_bits an int32 does not hold: on every device."""
    if keys.dtype.is_floating_point or keys.dtype.is_complex or keys.dtype == torch.bool:
        raise TypeError(f"partition digits take integer keys, got {keys.dtype}")
    if not 0 <= p_bits <= MAX_BITS:
        raise ValueError(f"p_bits must be in [0, {MAX_BITS}], got {p_bits}")


def partition_digits(keys: torch.Tensor, p_bits: int, hash_keys: bool = True) -> torch.Tensor:
    """(n,) int32 digits of 1-D integer keys: 2^p_bits for KEY_SENTINEL,
    else hash32(key) & (2^p_bits - 1) (the key's low 32 bits where not
    hash_keys). CPU tensors take the plain version."""
    check(keys, p_bits)
    if not keys.is_cuda:
        return ref.partition_digits(keys, p_bits, hash_keys)
    if keys.dtype not in (torch.int32, torch.int64) or keys.dim() != 1:
        raise TypeError(f"keys must be a 1-D int32 or int64 tensor, got {keys.dtype} "
                        f"{tuple(keys.shape)}")
    keys = keys.contiguous()
    out = torch.empty(keys.shape[0], dtype=torch.int32, device=keys.device)
    if keys.shape[0] == 0:
        return out
    _build.launch("partition_digits", "partition_digits", keys.data_ptr(), keys.shape[0],
                  keys.element_size(), p_bits, int(hash_keys), out.data_ptr(), on=keys)
    return out
