"""Seeds derived from the run's ``--seed``."""
from __future__ import annotations

import hashlib

MASK63 = (1 << 63) - 1


def derive(seed: int, *tags) -> int:
    """A 63-bit seed for the stream named by ``tags`` under ``seed`` (any
    whole number: negative and wider-than-64-bit seeds are taken as their
    decimal text)."""
    text = "/".join([str(int(seed)), *map(str, tags)]).encode()
    return int.from_bytes(hashlib.blake2b(text, digest_size=8).digest(),
                          "little") & MASK63
