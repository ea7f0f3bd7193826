"""uint8 sequence encoding and packing utilities.

All sequences in the framework live as uint8 arrays with the 2-bit-friendly
code A=0 C=1 G=2 T=3, N(/other)=4, pad=5.  Ragged read sets are packed into
fixed-shape (reads x max_len) tiles with explicit length vectors so every
downstream kernel sees static shapes (XLA requirement; SURVEY.md section 7
risk (ii)).
"""

from __future__ import annotations

import numpy as np

A, C, G, T, N, PAD = 0, 1, 2, 3, 4, 5

_ENCODE_LUT = np.full(256, N, dtype=np.uint8)
for _i, _b in enumerate("ACGT"):
    _ENCODE_LUT[ord(_b)] = _i
    _ENCODE_LUT[ord(_b.lower())] = _i

_DECODE_LUT = np.frombuffer(b"ACGTN-", dtype=np.uint8)

# revcomp: A<->T, C<->G, N->N, PAD->PAD
_RC_LUT = np.array([3, 2, 1, 0, 4, 5], dtype=np.uint8)


def encode(seq: str | bytes) -> np.ndarray:
    """ASCII sequence -> uint8 codes."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    return _ENCODE_LUT[np.frombuffer(seq, dtype=np.uint8)]


def decode(codes: np.ndarray) -> str:
    """uint8 codes -> ASCII string (pads render as '-')."""
    return _DECODE_LUT[np.asarray(codes, dtype=np.uint8)].tobytes().decode("ascii")


def revcomp(codes: np.ndarray) -> np.ndarray:
    """Reverse complement in code space."""
    return _RC_LUT[np.asarray(codes, dtype=np.uint8)][::-1]


def pack_ragged(
    seqs: list[np.ndarray],
    max_len: int | None = None,
    pad_to_multiple: int = 128,
) -> tuple[np.ndarray, np.ndarray]:
    """Pack variable-length uint8 sequences into a (n, L) tile + length vector.

    L is rounded up to ``pad_to_multiple`` and sequences longer
    than ``max_len`` are truncated.  Returns (tile uint8 (n, L), lengths int32 (n,)).
    """
    if not seqs:
        L = pad_to_multiple
        return np.full((0, L), PAD, np.uint8), np.zeros(0, np.int32)
    lens = np.array([len(s) for s in seqs], dtype=np.int64)
    L = int(max_len) if max_len is not None else int(lens.max())
    L = max(L, 1)
    L = -(-L // pad_to_multiple) * pad_to_multiple
    tile = np.full((len(seqs), L), PAD, np.uint8)
    out_lens = np.minimum(lens, L).astype(np.int32)
    for i, s in enumerate(seqs):
        n = out_lens[i]
        tile[i, :n] = s[:n]
    return tile, out_lens


def kmer_codes_valid(codes: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """2-bit pack every k-mer of a sequence (k <= 16 -> uint32/uint64 value).

    Returns (kmers int64 (len-k+1,), valid bool (len-k+1,)) where valid marks
    windows containing only ACGT.
    """
    codes = np.asarray(codes)
    n = len(codes) - k + 1
    if n <= 0:
        return np.zeros(0, np.int64), np.zeros(0, bool)
    ok = codes < 4
    vals = np.where(ok, codes, 0).astype(np.int64)
    # rolling 2-bit pack via cumulative windows
    kmers = np.zeros(n, np.int64)
    for j in range(k):
        kmers = (kmers << 2) | vals[j : j + n]
    valid = np.ones(n, bool)
    for j in range(k):
        valid &= ok[j : j + n]
    return kmers, valid
