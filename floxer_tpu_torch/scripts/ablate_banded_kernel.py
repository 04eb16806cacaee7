"""K5: the banded Myers kernel's column, ablated section by section.

Counterpart of scripts/tpu_ablate_banded_kernel.py. It ablates the column
the port's main path runs, K1's register column: csrc/ablate_banded_kernel.cu
runs `column_reg` of csrc/myers_banded_column.cuh, the body of K1's
one-warp register kernel, with each section (band slide, Eq, carries,
score, horizontal shift, second stream) behind a compile-time flag, one
template instance per variant of the script and band width (128, 256 or
384 words: CUDA_BAND_WORDS). `ablate_banded` launches it for CUDA tensors
and runs `ablate_banded_plain` (any multiple of 32 words) for CPU tensors.

It computes the TPU script's function, whose outputs only consume every
carried array (the sections are broken on purpose; only the time per
column matters): every row runs all num_text columns, s_bot starts at
binit, s_m and best at minit, and
  dist = s_bot + s_m + best + best_end + word BW-1 of VP^VN^P0^P1^P2^AM
(int32 wraparound), end = best_end. Operands (uint32 words travel as int32
tensors with the same bits): vp0 [rows, BW], planes0 [rows, 4, BW], texts
and stream int32 [rows, num_text] (chars 0..4), scalars int32 [rows, 6]
(tlen, jstar, topshift, mfrozen, minit, binit) -> dist, end int32 [rows].

    python -m floxer_tpu_torch.scripts.ablate_banded_kernel
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops._build import SCRIPTS, check_operand
from ..ops.myers import MASK32, WORD, narrow, widen
from . import (
    BAND_WORDS, NUM_TEXT, ROWS, accelerator_or_exit, best_seconds, card_line,
    check_texts, require_cuda, shift_up,
)

SOURCE = "floxer_tpu_torch/scripts/csrc/ablate_banded_kernel.cu"
REPLACES = "scripts/tpu_ablate_banded_kernel.py:51"
# the script's variants, in its order; the last is "minimal"
VARIANTS = (
    "full",
    "r4",
    "noks",
    "noslide",
    "noeq",
    "noscore",
    "nohshift",
    "nostream2",
    "noslide+noeq+noks+noscore+nohshift+nostream2",
)
# the band widths the CUDA kernel is instantiated at (R = 4, 8, 12 words a
# lane, as K1's register kernel)
CUDA_BAND_WORDS = (128, 256, 384)
# csrc/myers_banded_column.cuh's ColumnSection bits
_FLAGS = {
    "full": 0, "noslide": 1, "noeq": 2, "noks": 4, "noscore": 8,
    "nohshift": 16, "nostream2": 32, "r4": 64,
}
NUM_SCALARS = 6
TOP_BIT = 1 << 31
# kernel launches in this process (read and reset by chip_smoke.py)
LAUNCHES = 0


def _sections_off(variant: str) -> set[str]:
    if variant not in VARIANTS:
        raise ValueError(f"unknown ablation variant {variant!r}")
    return set(variant.split("+"))


def _check(vp0, planes0, texts, stream, scalars, variant) -> None:
    _sections_off(variant)
    if vp0.dim() != 2 or vp0.shape[1] == 0 or vp0.shape[1] % WORD:
        raise ValueError("vp0: expected [rows, band_words], band_words a "
                         "positive multiple of 32")
    rows, band_words = vp0.shape
    check_texts(texts)
    num_text = texts.shape[1]
    for tensor, name, shape in (
        (vp0, "vp0", (rows, band_words)),
        (planes0, "planes0", (rows, 4, band_words)),
        (texts, "texts", (rows, num_text)),
        (stream, "stream", (rows, num_text)),
        (scalars, "scalars", (rows, NUM_SCALARS)),
    ):
        check_operand(tensor, name, shape, torch.int32, vp0.device)


def ablate_banded(vp0, planes0, texts, stream, scalars, variant: str):
    """(dist, end) int32 [rows]: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if vp0.device.type == "cpu":
        return ablate_banded_plain(vp0, planes0, texts, stream, scalars, variant)
    return ablate_banded_cuda(vp0, planes0, texts, stream, scalars, variant)


def ablate_banded_cuda(vp0, planes0, texts, stream, scalars, variant: str):
    """Launch K5 on the operands' GPU."""
    global LAUNCHES
    _check(vp0, planes0, texts, stream, scalars, variant)
    rows, band_words = vp0.shape
    if band_words not in CUDA_BAND_WORDS:
        raise ValueError(
            f"vp0: {band_words} band words; the CUDA kernel takes "
            f"{', '.join(map(str, CUDA_BAND_WORDS))} only"
        )
    require_cuda(vp0, "vp0")
    dist = torch.empty(rows, dtype=torch.int32, device=vp0.device)
    end = torch.empty(rows, dtype=torch.int32, device=vp0.device)
    with torch.cuda.device(vp0.device):
        SCRIPTS.launch(
            "floxer_ablate_banded", vp0.data_ptr(), planes0.data_ptr(),
            texts.data_ptr(), stream.data_ptr(), scalars.data_ptr(), rows,
            band_words, texts.shape[1],
            sum(_FLAGS[s] for s in _sections_off(variant)),
            dist.data_ptr(), end.data_ptr(),
            torch.cuda.current_stream(vp0.device).cuda_stream,
        )
    LAUNCHES += 1
    return dist, end


def _carry_in(a: torch.Tensor, vp: torch.Tensor) -> torch.Tensor:
    """The carry into each word of the band-wide add a + vp: word w
    receives the carry out of words 0..w-1 (the last word below w that
    generates or kills decides)."""
    wide = a + vp
    generate = wide >> 32
    propagate = (wide & MASK32) == MASK32
    index = torch.arange(a.shape[1], device=a.device).expand_as(a)
    decides = torch.where((generate == 1) | ~propagate, index, -1)
    last = torch.cummax(decides, dim=1).values
    carry_out = torch.where(
        last >= 0, torch.gather(generate, 1, last.clamp(min=0)), 0
    )
    return shift_up(carry_out)


def ablate_banded_plain(vp0, planes0, texts, stream, scalars, variant: str):
    """The script's ablated column loop in plain PyTorch."""
    _check(vp0, planes0, texts, stream, scalars, variant)
    off = _sections_off(variant)
    device = vp0.device
    rows, band_words = vp0.shape
    vp = widen(vp0)
    vn = torch.zeros_like(vp)
    p0, p1, p2, am = (widen(planes0[:, i]) for i in range(4))
    tlen, jstar, topshift, mfrozen, minit, binit = (
        scalars.to(torch.int64).unbind(1)
    )
    s_bot, s_m, best = binit.clone(), minit.clone(), minit.clone()
    best_end = torch.zeros(rows, dtype=torch.int64, device=device)
    tchars = texts.to(torch.int64)
    pchars = stream.to(torch.int64)
    last_word = torch.arange(band_words, device=device) == band_words - 1
    first_word = torch.arange(band_words, device=device) == 0
    for j in range(texts.shape[1]):
        col = j + 1
        sliding = col <= jstar
        slide = sliding[:, None]
        tch = tchars[:, j : j + 1]
        pch = pchars[:, j : j + 1]
        if "nostream2" in off:
            pch = torch.zeros_like(pch)

        if "noslide" not in off:
            pack = (
                (vp & 1) | ((vn & 1) << 1) | ((p0 & 1) << 2) | ((p1 & 1) << 3)
                | ((p2 & 1) << 4) | ((am & 1) << 5)
            )
            nxt = torch.cat([pack[:, 1:], torch.zeros_like(pack[:, :1])], dim=1)

            def shr(x, bit, entering):
                return (x >> 1) | (((nxt >> bit) & 1) << 31) | entering

            def entering(bit):
                enters = last_word & (((pch >> bit) & 1) != 0)
                return torch.where(enters, TOP_BIT, 0)

            top = torch.where(last_word, TOP_BIT, 0)
            vp = torch.where(slide, shr(vp, 0, top), vp)
            vn = torch.where(slide, shr(vn, 1, 0), vn)
            p0 = torch.where(slide, shr(p0, 2, entering(0)), p0)
            p1 = torch.where(slide, shr(p1, 3, entering(1)), p1)
            p2 = torch.where(slide, shr(p2, 4, entering(2)), p2)
            am = torch.where(slide, shr(am, 5, 0), am)
            s_bot = s_bot + sliding

        if "noeq" not in off:
            m0 = torch.where((tch & 1) != 0, p0, p0 ^ MASK32)
            m1 = torch.where((tch & 2) != 0, p1, p1 ^ MASK32)
            m2 = torch.where((tch & 4) != 0, p2, p2 ^ MASK32)
            eq = (m0 & m1 & m2) | am
        else:
            eq = p0 ^ p1 ^ p2 ^ am ^ tch

        xv = eq | vn
        a = eq & vp
        summ = a + vp
        if "noks" not in off:
            summ = summ + _carry_in(a, vp)
        summ = summ & MASK32
        xh = (summ ^ vp) | eq
        ph = vn | ((xh | vp) ^ MASK32)
        mh = vp & xh

        if "noscore" not in off:
            d_bot = (ph[:, -1] >> 31) - (mh[:, -1] >> 31)
            s_bot = s_bot + d_bot
            s_m = torch.where(
                col == jstar, s_bot, s_m + torch.where(sliding, 0, d_bot)
            )

        if "nohshift" not in off:
            pessim = torch.where(sliding, col >= topshift, mfrozen != 0)
            ph_in = (first_word & pessim[:, None]).to(torch.int64)
            ph_sh = ((ph << 1) & MASK32) | shift_up(ph >> 31) | ph_in
            mh_sh = ((mh << 1) & MASK32) | shift_up(mh >> 31)
        else:
            ph_sh, mh_sh = ph, mh
        vp = mh_sh | ((xv | ph_sh) ^ MASK32)
        vn = ph_sh & xv

        if "noscore" not in off:
            improves = (col < tlen) & (col >= jstar) & (s_m <= best)
            best = torch.where(improves, s_m, best)
            best_end = torch.where(improves, col, best_end)
        else:
            best = best + 1
            best_end = best_end + 1

    acc = (vp ^ vn ^ p0 ^ p1 ^ p2 ^ am)[:, -1]
    return narrow(s_bot + s_m + best + best_end + acc), best_end.to(torch.int32)


def script_inputs(num_text: int = NUM_TEXT, band_words: int = BAND_WORDS):
    """The script's seeded inputs (seed 0, in its order): vp0 uint32
    [32, band_words], planes0 uint32 [32, 4, band_words], texts and stream
    int32 [32, num_text] (chars 0..4), scalars int32 [32, 6], each in [1,
    num_text // 2). The script's band is 256 words."""
    rng = np.random.default_rng(0)
    vp0 = rng.integers(0, 2**32, size=(ROWS, band_words), dtype=np.uint32)
    planes0 = rng.integers(
        0, 2**32, size=(ROWS, 4, band_words), dtype=np.uint32
    )
    texts = rng.integers(0, 5, size=(ROWS, num_text)).astype(np.int32)
    stream = rng.integers(0, 5, size=(ROWS, num_text)).astype(np.int32)
    scalars = np.concatenate(
        [
            rng.integers(1, num_text // 2, size=(ROWS, 1)).astype(np.int32)
            for _ in range(NUM_SCALARS)
        ],
        axis=1,
    )
    return vp0, planes0, texts, stream, scalars


def device_operands(arrays, device: torch.device):
    """numpy operands (uint32 or int32) -> contiguous int32 tensors with
    the same bits on `device`."""
    return tuple(
        torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(device)
        for a in arrays
    )


def from_banded_operands(vp0, planes0, texts_packed, stream_packed, scalars):
    """K1's operands (ops/cuda_myers_banded.py: nibble-packed texts and
    pattern stream) as K5's, one int32 char per column. On them, with every
    row's tlen - 1 at most the column count, `full` ends each row at K1's
    end column: both hold the same state at every column below tlen, and
    K5 scores no column past it."""

    def unpack(packed):
        shifts = 4 * torch.arange(8, device=packed.device)
        chars = (packed.to(torch.int64)[:, :, None] >> shifts) & 0xF
        return chars.reshape(packed.shape[0], -1).to(torch.int32).contiguous()

    return vp0, planes0, unpack(texts_packed), unpack(stream_packed), scalars


def main() -> int:
    device = accelerator_or_exit()
    print(card_line(), flush=True)
    operands = device_operands(script_inputs(), device)
    for variant in VARIANTS:
        best = best_seconds(lambda: ablate_banded(*operands, variant))
        print(
            f"{variant:48s}: {best:.4f}s  {best/NUM_TEXT*1e6:.2f}us/col",
            flush=True,
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
