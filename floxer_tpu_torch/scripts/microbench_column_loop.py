"""K6: the column-loop floor microbenchmark.

Counterpart of scripts/tpu_microbench_column_loop.py: what one text column
of a Myers-style loop costs when its body is (almost) empty, pure
elementwise work or pure one-word rolls. `column_loop` launches the CUDA
kernel (csrc/microbench_column_loop.cu) for a CUDA tensor and runs
`column_loop_plain` for a CPU tensor. Operands: texts int32 [rows,
num_text] (chars 0..4) -> int32 [rows, 256] holding the uint32 words of acc.
The kernel holds the carried arrays in registers, as K1 holds its band,
and loads their start values from a table the wrapper keeps on each
device.

    python -m floxer_tpu_torch.scripts.microbench_column_loop
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops._build import SCRIPTS
from ..ops.myers import MASK32, narrow
from . import (
    BAND_WORDS, NUM_TEXT, ROWS, accelerator_or_exit, best_seconds, card_line,
    check_texts, require_cuda, shift_up, start_table,
)

SOURCE = "floxer_tpu_torch/scripts/csrc/microbench_column_loop.cu"
REPLACES = "scripts/tpu_microbench_column_loop.py:39"
VARIANTS = ("empty", "elementwise", "rolls")
# the script's start values of acc, v1 and v2 (every word; the kernel
# reads them from start_table(STARTS, device))
STARTS = (0, 1, 3)
# kernel launches in this process (read and reset by chip_smoke.py)
LAUNCHES = 0


def _check(texts: torch.Tensor, variant: str) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"unknown column-loop variant {variant!r}")
    check_texts(texts)


def column_loop(texts: torch.Tensor, variant: str) -> torch.Tensor:
    """acc [rows, 256]: the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor."""
    if texts.device.type == "cpu":
        return column_loop_plain(texts, variant)
    return column_loop_cuda(texts, variant)


def column_loop_cuda(texts: torch.Tensor, variant: str) -> torch.Tensor:
    """Launch K6 on the texts' GPU."""
    global LAUNCHES
    _check(texts, variant)
    require_cuda(texts, "texts")
    rows, num_text = texts.shape
    table = start_table(STARTS, texts.device)
    out = torch.empty((rows, BAND_WORDS), dtype=torch.int32, device=texts.device)
    with torch.cuda.device(texts.device):
        SCRIPTS.launch(
            "floxer_column_loop", texts.data_ptr(), table.data_ptr(), rows,
            num_text,
            VARIANTS.index(variant), out.data_ptr(),
            torch.cuda.current_stream(texts.device).cuda_stream,
        )
    LAUNCHES += 1
    return out


def column_loop_plain(texts: torch.Tensor, variant: str) -> torch.Tensor:
    """The script's column loop in plain PyTorch."""
    _check(texts, variant)
    rows, num_text = texts.shape
    chars = texts.to(torch.int64)
    acc, v1, v2 = (
        torch.full((rows, BAND_WORDS), v, dtype=torch.int64, device=texts.device)
        for v in STARTS
    )
    for j in range(num_text):
        ch = chars[:, j : j + 1]
        if variant == "empty":
            acc = (acc + ch) & MASK32
            continue
        x = v1
        if variant == "elementwise":
            for _ in range(20):
                x = ((x ^ v2) + (x | v1)) & MASK32
                v1 = (v1 + 1) & MASK32
        else:
            for _ in range(12):
                x = shift_up(x) | v2
        acc = (acc + x + ch) & MASK32
    return narrow(acc)


def script_texts(num_text: int = NUM_TEXT) -> np.ndarray:
    """The script's texts: int32 [32, num_text], chars 0..4 (seed 0)."""
    rng = np.random.default_rng(0)
    return rng.integers(0, 5, size=(ROWS, num_text)).astype(np.int32)


def main() -> int:
    device = accelerator_or_exit()
    print(card_line(), flush=True)
    texts = torch.from_numpy(script_texts()).to(device)
    for variant in VARIANTS:
        best = best_seconds(lambda: column_loop(texts, variant))
        per_col = best / NUM_TEXT * 1e6
        print(f"{variant}: {best:.4f}s  {per_col:.2f}us/col", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
