# Copied from floxer_tpu/alphabet.py; relative imports resolve to this package's copies.
"""DNA5-with-sentinel alphabet: char<->rank LUTs and reverse complement.

Rank mapping (must match the reference exactly — ivsigma d_dna5 as used in
src/lib/input.cpp:165-176 and pinned by test/input_test.cpp:11-27):

    '$' -> 0, 'A'/'a' -> 1, 'C'/'c' -> 2, 'G'/'g' -> 3, 'T'/'t'/'U'/'u' -> 4,
    'N'/'n' -> 5, every other character -> 5.

Implemented as numpy lookup tables so host encoding of whole reads/references
is a single vectorized gather; the same tables become jnp constants on device.
"""

import numpy as np

SIGMA = 6  # $ A C G T N

RANK_SENTINEL = 0
RANK_A = 1
RANK_C = 2
RANK_G = 3
RANK_T = 4
RANK_N = 5

_RANK_CHARS = np.frombuffer(b"$ACGTN", dtype=np.uint8)

# char (byte) -> rank LUT; invalid chars map straight to N's rank (5), which
# folds the reference's two-step convert-then-replace (input.cpp:165-176).
CHAR_TO_RANK = np.full(256, RANK_N, dtype=np.uint8)
for _chars, _rank in [
    (b"$", RANK_SENTINEL),
    (b"Aa", RANK_A),
    (b"Cc", RANK_C),
    (b"Gg", RANK_G),
    (b"TtUu", RANK_T),
    (b"Nn", RANK_N),
]:
    for _c in _chars:
        CHAR_TO_RANK[_c] = _rank

# rank -> char LUT ('=' placeholder for out-of-range, never used)
RANK_TO_CHAR = np.full(256, ord("="), dtype=np.uint8)
RANK_TO_CHAR[: len(_RANK_CHARS)] = _RANK_CHARS

# rank -> complement rank: A<->T, C<->G, N->N, $->$
COMPLEMENT = np.array([0, 4, 3, 2, 1, 5], dtype=np.uint8)


def chars_to_ranks(sequence) -> np.ndarray:
    """Encode an ASCII DNA string/bytes into a uint8 rank array.

    Parity: input::internal::chars_to_rank_sequence (input.cpp:165-176).
    """
    if isinstance(sequence, str):
        sequence = sequence.encode("ascii", errors="replace")
    raw = np.frombuffer(bytes(sequence), dtype=np.uint8)
    return CHAR_TO_RANK[raw]


def ranks_to_chars(ranks: np.ndarray) -> str:
    """Decode a uint8 rank array back into an ASCII string (output.cpp:71)."""
    return RANK_TO_CHAR[np.asarray(ranks, dtype=np.uint8)].tobytes().decode("ascii")


def reverse_complement(ranks: np.ndarray) -> np.ndarray:
    """Reverse complement of a rank sequence (input.cpp:132)."""
    return COMPLEMENT[np.asarray(ranks, dtype=np.uint8)][::-1].copy()
