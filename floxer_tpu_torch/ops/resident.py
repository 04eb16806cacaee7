"""Device-resident sequence banks and on-device kernel input preparation.

Counterpart of floxer_tpu/ops/resident.py. A ResidentBank holds rank
sequences packed eight 4-bit chars per uint32 word (the wire format of K1),
each sequence starting at an 8-char boundary, concatenated flat and
uploaded to its device once (the reference: once per run; reads: once per
chunk). Every per-task window or pattern is then a word-aligned gather plus
a nibble funnel shift on the device, and the kernels' inputs (texts,
streams, vp0, char bit-planes, Peq) are rebuilt there bit-identical to the
host packers, so a verification wave uploads only offsets.

The gathers and the preparation are plain PyTorch tensor ops on the device,
as the reference ran them as XLA outside Pallas; fusing them into the
kernels' prologue is ROADMAP item X3. Trailing gather garbage (chars past a
window or pattern end) is harmless by construction: the kernels score only
columns below each task's tlen, Peq and the band planes mask chars past
the pattern end, and K1 reads its pattern stream only while the band slides
(col <= m - budget).
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..alphabet import SIGMA

from .cuda_myers import myers_small
from .cuda_myers_banded import myers_banded
from .cuda_myers_large import myers_large
from .myers import MASK32, WORD, narrow

CHARS_PER_WORD = 8
# tail padding so gathers near a bank's end never run past it: covers the
# largest gather (windows of 100k-char reads plus band slack stay well
# below 256k chars = 32k words)
TAIL_PAD_WORDS = 32 * 1024


def pack_nibbles_flat(chars: np.ndarray) -> np.ndarray:
    """uint8 chars [n] -> uint32 words [ceil(n/8)], eight 4-bit nibbles per
    word, little-endian within the word. Copied from
    floxer_tpu/ops/resident.py:pack_nibbles_flat."""
    n = len(chars)
    num_words = -(-n // CHARS_PER_WORD) if n else 0
    padded = np.zeros(num_words * CHARS_PER_WORD, dtype=np.uint32)
    padded[:n] = chars
    shifts = (4 * np.arange(CHARS_PER_WORD, dtype=np.uint32))[None, :]
    return np.bitwise_or.reduce(
        padded.reshape(num_words, CHARS_PER_WORD) << shifts, axis=1
    )


class ResidentBank:
    """Rank sequences packed 4-bit at 8-char boundaries, on `device`.

    The layout (per-sequence base char offsets) is computed eagerly so
    callers can address slices before any device work; the packed upload
    happens on first use of `.flat`, under a lock (a background preload may
    race the align loop's first wave). The host sequences are dropped once
    the bank is on the device, so a long-lived process never holds two
    copies of a genome."""

    def __init__(self, sequences: list[np.ndarray], device: torch.device):
        self.device = torch.device(device)
        self.base_chars: list[int] = []
        cursor_words = 0
        for seq in sequences:
            self.base_chars.append(cursor_words * CHARS_PER_WORD)
            cursor_words += -(-len(seq) // CHARS_PER_WORD)
        self.num_words = cursor_words + TAIL_PAD_WORDS
        self._sequences = sequences
        self._words: np.ndarray | None = None
        self._flat: torch.Tensor | None = None
        self._lock = threading.Lock()

    @classmethod
    def from_words(
        cls, words: np.ndarray, base_chars: list[int], device: torch.device
    ) -> "ResidentBank":
        """A bank over already-packed words (e.g. a reference bank's
        `.flat`), with the same per-sequence base offsets."""
        bank = cls([], device)
        bank.base_chars = list(base_chars)
        bank.num_words = len(words)
        bank._words = np.array(words, dtype=np.uint32)
        return bank

    def base(self, index: int) -> int:
        return self.base_chars[index]

    @property
    def flat(self) -> torch.Tensor:
        """int32 [num_words] with the packed words' bits, on the device."""
        with self._lock:
            if self._flat is None:
                words = self._words
                if words is None:
                    words = np.zeros(self.num_words, dtype=np.uint32)
                    for base, seq in zip(self.base_chars, self._sequences):
                        packed = pack_nibbles_flat(
                            np.asarray(seq, dtype=np.uint8)
                        )
                        start = base // CHARS_PER_WORD
                        words[start : start + len(packed)] = packed
                self._flat = torch.from_numpy(words.view(np.int32)).to(
                    self.device
                )
                self._sequences = []
                self._words = None
            return self._flat


def addr_arrays(char_starts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Split global char offsets (int64-safe for >2G-char banks) into
    int32 (word_start, nibble_phase) pairs for the device gathers.
    Copied from floxer_tpu/ops/resident.py:addr_arrays."""
    starts = np.asarray(char_starts, dtype=np.int64)
    return (
        (starts // CHARS_PER_WORD).astype(np.int32),
        (starts % CHARS_PER_WORD).astype(np.int32),
    )


def _gather_packed(flat, word_starts, phases, num_words: int):
    """[T, num_words] int32: word-aligned slices funnel-shifted by the
    4-bit phase, so char 0 of row t is the char at global offset
    8*word_starts[t] + phases[t]. flat must carry >= num_words + 1 words
    past every start (TAIL_PAD_WORDS)."""
    offsets = torch.arange(num_words + 1, device=flat.device)
    index = word_starts.to(torch.int64)[:, None] + offsets[None, :]
    words = flat[index].to(torch.int64) & MASK32  # [T, num_words + 1]
    shift = 4 * phases.to(torch.int64)[:, None]
    lo = words[:, :-1] >> shift
    hi = (words[:, 1:] << (32 - shift)) & MASK32  # zero when shift == 0
    return narrow(lo | hi)


def _unpack_codes(words):
    """int32 words [T, W] -> int32 chars [T, W*8] (values 0..15)."""
    shifts = 4 * torch.arange(CHARS_PER_WORD, device=words.device)
    nibbles = (words[:, :, None] >> shifts) & 0xF
    return nibbles.reshape(words.shape[0], -1).to(torch.int32)


def _pack_bits32(bits):
    """bool [..., W, 32] -> int32 [..., W] with bit i of each word set from
    bits[..., i] (little-endian, as np.packbits(bitorder='little'))."""
    weights = torch.ones(WORD, dtype=torch.int64, device=bits.device) << (
        torch.arange(WORD, device=bits.device)
    )
    return narrow(torch.where(bits, weights, 0).sum(dim=-1))


def _device_peq(pattern_codes, pat_lens, num_words: int):
    """[T, SIGMA, W] int32 Peq from gathered pattern chars; identical to
    build_peq_vectorized (chars past pat_len are masked out)."""
    T = pattern_codes.shape[0]
    idx = torch.arange(num_words * WORD, device=pattern_codes.device)[None, :]
    valid = idx < pat_lens.to(torch.int64)[:, None]
    planes = [
        _pack_bits32(
            ((pattern_codes == s) & valid).reshape(T, num_words, WORD)
        )
        for s in range(SIGMA)
    ]
    return torch.stack(planes, dim=1)


# ---------------------------------------------------------------------------
# banded kernel inputs (K1)
# ---------------------------------------------------------------------------


def _banded_inputs(
    ref_flat, bank_flat, win_word0, win_phase, win_lens, pat_word0,
    pat_phase, stream_word0, stream_phase, pat_lens, budgets,
    band_words: int, num_text: int,
):
    """On-device rebuild of prepare_banded_batch: (vp0, planes0, texts,
    stream, scalars) as K1 takes them."""
    T = win_word0.shape[0]
    num_words = num_text // CHARS_PER_WORD
    texts = _gather_packed(ref_flat, win_word0, win_phase, num_words)
    stream = _gather_packed(bank_flat, stream_word0, stream_phase, num_words)

    b_store = band_words * WORD
    pattern_codes = _unpack_codes(
        _gather_packed(
            bank_flat, pat_word0, pat_phase, b_store // CHARS_PER_WORD
        )
    )  # [T, b_store]
    bit_idx = torch.arange(b_store, device=win_word0.device)[None, :]
    k = budgets.to(torch.int64)[:, None]
    m = pat_lens.to(torch.int64)[:, None]
    rows = bit_idx + k - (b_store - 1)  # absolute pattern row at band pos p
    in_pat = (rows >= 1) & (rows <= m)
    gathered = torch.gather(
        pattern_codes, 1, torch.clamp(rows - 1, 0, b_store - 1)
    )
    codes = torch.where(in_pat, gathered, 7)  # 7 = matches nothing

    def pack(bits):
        return _pack_bits32(bits.reshape(T, band_words, WORD))

    planes0 = torch.stack(
        [
            pack((codes & 1) != 0),
            pack((codes & 2) != 0),
            pack((codes & 4) != 0),
            pack(rows <= 0),  # all-match plane
        ],
        dim=1,
    )
    vp0 = pack(rows >= 1)
    scalars = torch.cat(
        [
            win_lens.to(torch.int64)[:, None],  # tlen
            m - k,  # jstar
            b_store - k,  # topshift
            (m >= b_store).to(torch.int64),  # mfrozen
            m,  # minit
            k,  # binit
        ],
        dim=1,
    ).to(torch.int32)
    return vp0, planes0, texts, stream, scalars


def _resident_banded_call_core(
    ref_flat, bank_flat, win_word0, win_phase, win_lens, pat_word0,
    pat_phase, stream_word0, stream_phase, pat_lens, budgets,
    band_words: int, num_text: int,
):
    """Gather + prepare + K1 on resident banks: (dist, end) int32 [T]."""
    vp0, planes0, texts, stream, scalars = _banded_inputs(
        ref_flat, bank_flat, win_word0, win_phase, win_lens, pat_word0,
        pat_phase, stream_word0, stream_phase, pat_lens, budgets,
        band_words, num_text,
    )
    return myers_banded(
        vp0, planes0, texts, stream, scalars, band_words, num_text
    )


# ---------------------------------------------------------------------------
# full-state kernel inputs (K2 small / K3 large)
# ---------------------------------------------------------------------------


def _full_inputs(
    ref_flat, bank_flat, win_word0, win_phase, pat_word0, pat_phase,
    pat_lens, num_words: int, num_text: int,
):
    """(texts [T, num_text] int32 chars, peq [T, SIGMA, num_words])."""
    texts = _unpack_codes(
        _gather_packed(
            ref_flat, win_word0, win_phase, num_text // CHARS_PER_WORD
        )
    )  # garbage past win_len is masked by the kernels' column bound
    pattern_codes = _unpack_codes(
        _gather_packed(
            bank_flat, pat_word0, pat_phase,
            num_words * WORD // CHARS_PER_WORD,
        )
    )
    return texts, _device_peq(pattern_codes, pat_lens, num_words)


def _resident_large_call_core(
    ref_flat, bank_flat, win_word0, win_phase, win_lens, pat_word0,
    pat_phase, pat_lens, num_words_padded: int, num_text: int,
):
    texts, peq = _full_inputs(
        ref_flat, bank_flat, win_word0, win_phase, pat_word0, pat_phase,
        pat_lens, num_words_padded, num_text,
    )
    return myers_large(
        peq, pat_lens.to(torch.int32), texts, win_lens.to(torch.int32)
    )


def _resident_small_call_core(
    ref_flat, bank_flat, win_word0, win_phase, win_lens, pat_word0,
    pat_phase, pat_lens, num_words: int, num_text: int,
):
    texts, peq = _full_inputs(
        ref_flat, bank_flat, win_word0, win_phase, pat_word0, pat_phase,
        pat_lens, num_words, num_text,
    )
    return myers_small(
        peq.permute(2, 1, 0).contiguous(),  # [W, SIGMA, T]
        pat_lens.to(torch.int32),
        texts.t().contiguous(),  # [N, T]
        win_lens.to(torch.int32),
    )


# ---------------------------------------------------------------------------
# host entries of the bucketed batcher (reference: ops/resident.py:288-508)
# ---------------------------------------------------------------------------


def check_gather(state_words: int, n_chars: int) -> None:
    """A kernel call at (state words, window chars) gathers at most
    max(n_chars, 32 * state_words) / 8 + 1 words past a task's start
    (the funnel shift reads one more); that must stay inside the banks'
    tail padding."""
    words = max(n_chars, state_words * WORD) // CHARS_PER_WORD + 1
    if words > TAIL_PAD_WORDS:
        raise ValueError(
            f"a gather of {words} words ({state_words} state words, "
            f"{n_chars} chars) runs past the banks' tail padding "
            f"({TAIL_PAD_WORDS} words)"
        )


def _int32(values, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(values, dtype=np.int32)).to(device)


def myers_banded_resident(
    ref_bank: ResidentBank,
    query_bank: ResidentBank,
    win_starts: np.ndarray,  # int64 global char offsets into ref_bank
    win_lens: np.ndarray,
    pat_starts: np.ndarray,  # int64 global char offsets into query_bank
    pat_lens: np.ndarray,
    budgets: np.ndarray,
    band_words: int,
    num_text: int,
    sync: bool = True,
):
    """Drop-in for myers_banded_host with offsets instead of arrays, on the
    banks' device: (distance, end_col) per task, as int32 tensors on the
    device with sync=False. Requires 0 < budget < m per task. The
    reference pads the batch to its kernel's task groups with dummy rows;
    K1 stops each task at its own window, so the port runs the tasks as
    given."""
    device = ref_bank.device
    num_text = -(-num_text // CHARS_PER_WORD) * CHARS_PER_WORD
    check_gather(band_words, num_text)
    starts = np.asarray(pat_starts, dtype=np.int64)
    win_word0, win_phase = addr_arrays(win_starts)
    pat_word0, pat_phase = addr_arrays(starts)
    stream_word0, stream_phase = addr_arrays(
        starts + np.asarray(budgets, dtype=np.int64)
    )
    dist, end = _resident_banded_call_core(
        ref_bank.flat, query_bank.flat,
        _int32(win_word0, device), _int32(win_phase, device),
        _int32(win_lens, device), _int32(pat_word0, device),
        _int32(pat_phase, device), _int32(stream_word0, device),
        _int32(stream_phase, device), _int32(pat_lens, device),
        _int32(budgets, device),
        band_words=band_words, num_text=num_text,
    )
    if not sync:
        return dist, end
    return dist.cpu().numpy(), end.cpu().numpy()


def _resident_full_core(
    ref_flat, bank_flat, win_word0, win_phase, win_lens, pat_word0,
    pat_phase, pat_lens, num_words: int | None,
    num_words_padded: int | None, num_text: int,
):
    """Small/large full-state dispatch on resident banks: K3 when
    num_words_padded is given, else K2 at num_words. (dist, end) [T]."""
    args = (
        ref_flat, bank_flat, win_word0, win_phase, win_lens,
        pat_word0, pat_phase, pat_lens,
    )
    if num_words_padded is not None:
        return _resident_large_call_core(
            *args, num_words_padded=num_words_padded, num_text=num_text
        )
    return _resident_small_call_core(
        *args, num_words=num_words, num_text=num_text
    )


def myers_full_resident(
    ref_bank: ResidentBank,
    query_bank: ResidentBank,
    win_starts: np.ndarray,
    win_lens: np.ndarray,
    pat_starts: np.ndarray,
    pat_lens: np.ndarray,
    m_bucket: int,
    num_text: int,
    sync: bool = True,
):
    """Drop-in for myers_distance with offsets instead of arrays, on the
    banks' device; routes by pattern word count like myers_distance: more
    than MAX_UNROLLED_WORDS words to K3 (words padded to 128), else K2.
    The reference pads the batch to its kernels' task groups (128 or 8
    rows); K2 and K3 stop each task at its own window, so the port runs
    the tasks as given."""
    from .myers import MAX_UNROLLED_WORDS

    if num_text % CHARS_PER_WORD:
        raise ValueError(f"num_text must be a multiple of 8, got {num_text}")
    device = ref_bank.device
    num_words = -(-m_bucket // WORD)
    words_padded = None
    if num_words > MAX_UNROLLED_WORDS:
        words_padded = -(-num_words // 128) * 128
    check_gather(words_padded or num_words, num_text)
    win_word0, win_phase = addr_arrays(win_starts)
    pat_word0, pat_phase = addr_arrays(pat_starts)
    dist, end = _resident_full_core(
        ref_bank.flat, query_bank.flat,
        _int32(win_word0, device), _int32(win_phase, device),
        _int32(win_lens, device), _int32(pat_word0, device),
        _int32(pat_phase, device), _int32(pat_lens, device),
        num_words=num_words, num_words_padded=words_padded,
        num_text=num_text,
    )
    if not sync:
        return dist, end
    return dist.cpu().numpy(), end.cpu().numpy()
