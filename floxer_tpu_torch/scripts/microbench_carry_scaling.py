"""K7 and K8: what the banded kernel's column loop scales with.

Counterpart of scripts/tpu_microbench_carry_scaling.py. K7
(`carry_scaling`) varies the carried arrays, the elementwise ops and the
one-word rolls per column; K8 (`bcast`) varies the per-row scalar
conditions per column. Each launches its CUDA kernel
(csrc/microbench_carry_scaling.cu) for a CUDA tensor and runs its plain
version for a CPU tensor; a configuration outside the script's lists is
refused on both routes. Operands: texts int32 [rows, num_text] (chars
0..4), K8's jstar int32 [rows] -> int32 [rows, 256] holding uint32 words.
Both kernels hold their carried arrays in registers, as K1 holds its band,
and load their start values from a table the wrapper keeps on each device.

    python -m floxer_tpu_torch.scripts.microbench_carry_scaling
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops._build import SCRIPTS, check_operand
from ..ops.myers import MASK32, narrow
from . import (
    BAND_WORDS, NUM_TEXT, ROWS, accelerator_or_exit, best_seconds, card_line,
    check_texts, require_cuda, shift_up, start_table,
)
from .microbench_column_loop import script_texts

SOURCE = "floxer_tpu_torch/scripts/csrc/microbench_carry_scaling.cu"
REPLACES = "scripts/tpu_microbench_carry_scaling.py:33"
BCAST_REPLACES = "scripts/tpu_microbench_carry_scaling.py:115"
# (n_carry, n_ops, n_rolls), the script's list
CONFIGS = (
    (3, 0, 0),
    (10, 0, 0),
    (14, 0, 0),
    (10, 40, 0),
    (10, 80, 0),
    (10, 40, 12),
    (3, 80, 12),
    (10, 80, 12),
)
BCASTS = (0, 4, 10, 18)
# the start values the kernels read from start_table(..., device): K7's
# carried array a starts at a + 1, for the most arrays a configuration
# has; K8's x and y (every word) at the script's BCAST_STARTS
CARRY_STARTS = tuple(range(1, max(c for c, _, _ in CONFIGS) + 1))
BCAST_STARTS = (1, 3)
# kernel launches in this process (read and reset by chip_smoke.py)
CARRY_LAUNCHES = 0
BCAST_LAUNCHES = 0


def _check_carry(texts, n_carry, n_ops, n_rolls) -> None:
    if (n_carry, n_ops, n_rolls) not in CONFIGS:
        raise ValueError(
            f"(n_carry, n_ops, n_rolls) = {(n_carry, n_ops, n_rolls)} is not "
            f"one of the script's configurations {CONFIGS}"
        )
    check_texts(texts)


def _check_bcast(texts, jstar, n_bcast) -> None:
    if n_bcast not in BCASTS:
        raise ValueError(f"n_bcast = {n_bcast} is not one of {BCASTS}")
    check_texts(texts)
    check_operand(jstar, "jstar", (texts.shape[0],), torch.int32, texts.device)


def carry_scaling(texts: torch.Tensor, n_carry: int, n_ops: int, n_rolls: int):
    """arr0 [rows, 256]: the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor."""
    if texts.device.type == "cpu":
        return carry_scaling_plain(texts, n_carry, n_ops, n_rolls)
    return carry_scaling_cuda(texts, n_carry, n_ops, n_rolls)


def carry_scaling_cuda(texts, n_carry, n_ops, n_rolls) -> torch.Tensor:
    """Launch K7 on the texts' GPU."""
    global CARRY_LAUNCHES
    _check_carry(texts, n_carry, n_ops, n_rolls)
    require_cuda(texts, "texts")
    rows, num_text = texts.shape
    starts = start_table(CARRY_STARTS, texts.device)
    out = torch.empty((rows, BAND_WORDS), dtype=torch.int32, device=texts.device)
    with torch.cuda.device(texts.device):
        SCRIPTS.launch(
            "floxer_carry_scaling", texts.data_ptr(), starts.data_ptr(),
            rows, num_text, n_carry, n_ops, n_rolls, out.data_ptr(),
            torch.cuda.current_stream(texts.device).cuda_stream,
        )
    CARRY_LAUNCHES += 1
    return out


def carry_scaling_plain(texts, n_carry, n_ops, n_rolls) -> torch.Tensor:
    """The script's carry-scaling loop in plain PyTorch; the carried
    arrays are one [n_carry, rows, 256] tensor."""
    _check_carry(texts, n_carry, n_ops, n_rolls)
    rows, num_text = texts.shape
    chars = texts.to(torch.int64)
    arrays = (
        torch.arange(1, n_carry + 1, dtype=torch.int64, device=texts.device)
        .view(n_carry, 1, 1)
        .expand(n_carry, rows, BAND_WORDS)
    )
    for j in range(num_text):
        a0 = arrays[0]
        x = a0 ^ chars[:, j : j + 1]
        x = (x + (arrays[1:] & 7).sum(dim=0)) & MASK32
        for _ in range(n_ops):
            x = (x ^ a0) | (x >> 1)
        for _ in range(n_rolls):
            x = shift_up(x) ^ a0
        arrays = torch.cat([x[None], (arrays[1:] + 1) & MASK32])
    return narrow(arrays[0])


def bcast(texts: torch.Tensor, jstar: torch.Tensor, n_bcast: int):
    """x [rows, 256]: the CUDA kernel for a CUDA tensor, the plain version
    for a CPU tensor."""
    if texts.device.type == "cpu":
        return bcast_plain(texts, jstar, n_bcast)
    return bcast_cuda(texts, jstar, n_bcast)


def bcast_cuda(texts, jstar, n_bcast) -> torch.Tensor:
    """Launch K8 on the texts' GPU."""
    global BCAST_LAUNCHES
    _check_bcast(texts, jstar, n_bcast)
    require_cuda(texts, "texts")
    rows, num_text = texts.shape
    table = start_table(BCAST_STARTS, texts.device)
    out = torch.empty((rows, BAND_WORDS), dtype=torch.int32, device=texts.device)
    with torch.cuda.device(texts.device):
        SCRIPTS.launch(
            "floxer_bcast", texts.data_ptr(), jstar.data_ptr(),
            table.data_ptr(), rows, num_text, n_bcast, out.data_ptr(),
            torch.cuda.current_stream(texts.device).cuda_stream,
        )
    BCAST_LAUNCHES += 1
    return out


def bcast_plain(texts, jstar, n_bcast) -> torch.Tensor:
    """The script's broadcast loop in plain PyTorch."""
    _check_bcast(texts, jstar, n_bcast)
    rows, num_text = texts.shape
    chars = texts.to(torch.int64)
    js = jstar.to(torch.int64)[:, None]
    x, y = (
        torch.full((rows, BAND_WORDS), v, dtype=torch.int64, device=texts.device)
        for v in BCAST_STARTS
    )
    for j in range(num_text):
        for t in range(n_bcast):
            x = torch.where(j + t <= js, x ^ y, x)
        x = (x + chars[:, j : j + 1]) & MASK32
        y = (y + 1) & MASK32
    return narrow(x)


def script_jstar(num_text: int = NUM_TEXT) -> np.ndarray:
    """The script's per-row scalar: int32 [32] in [0, num_text) (seed 1)."""
    rng = np.random.default_rng(1)
    return rng.integers(0, num_text, size=ROWS).astype(np.int32)


def main() -> int:
    device = accelerator_or_exit()
    print(card_line(), flush=True)
    texts = torch.from_numpy(script_texts()).to(device)
    for n_carry, n_ops, n_rolls in CONFIGS:
        best = best_seconds(lambda: carry_scaling(texts, n_carry, n_ops, n_rolls))
        print(
            f"carry={n_carry:2d} ops={n_ops:2d} rolls={n_rolls:2d}: "
            f"{best:.4f}s  {best/NUM_TEXT*1e6:.2f}us/col",
            flush=True,
        )
    jstar = torch.from_numpy(script_jstar()).to(device)
    for n_bcast in BCASTS:
        best = best_seconds(lambda: bcast(texts, jstar, n_bcast))
        print(
            f"bcast={n_bcast:2d}: {best:.4f}s  {best/NUM_TEXT*1e6:.2f}us/col",
            flush=True,
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
