"""The research scripts that time the banded kernel's column, on the GPU.

Counterparts of the JAX package's research scripts that hold Pallas
kernels (scripts/tpu_ablate_banded_kernel.py,
scripts/tpu_microbench_column_loop.py,
scripts/tpu_microbench_carry_scaling.py). Each module holds its
hand-written CUDA kernels' launch wrappers, with their sources in csrc/
(built at first use into their own library, `ops._build.SCRIPTS`, so the
aligner never builds them), and beside them the plain PyTorch versions.
Run on a Hopper GPU as

    python -m floxer_tpu_torch.scripts.ablate_banded_kernel
    python -m floxer_tpu_torch.scripts.microbench_column_loop
    python -m floxer_tpu_torch.scripts.microbench_carry_scaling

Each prints the card's name and power limit, then the TPU script's lines
at the script's shape (32 rows, 256 band words, 23040 text columns). Without
a Hopper GPU they exit non-zero and print nothing on stdout.

The plain versions compute on int64 holding unsigned 32-bit words (torch on
the CPU has no uint32 shifts or adds), vectorised over the rows and words,
with a Python loop over the text columns.
"""

from __future__ import annotations

import functools
import subprocess

import torch

from ..backend import accelerator_device
from ..ops._build import check_operand

# the TPU scripts' shape: rows (sublanes), band words, text columns
ROWS = 32
BAND_WORDS = 256
NUM_TEXT = 23040


def check_texts(texts: torch.Tensor, name: str = "texts") -> None:
    """A [rows, num_text] int32 char array, contiguous."""
    if texts.dim() != 2:
        raise ValueError(
            f"{name}: expected [rows, num_text], got {tuple(texts.shape)}"
        )
    check_operand(texts, name, tuple(texts.shape), torch.int32, texts.device)


def require_cuda(tensor: torch.Tensor, name: str) -> None:
    """The launch wrappers take CUDA tensors only: no CPU fallback."""
    if tensor.device.type != "cuda":
        raise ValueError(
            f"{name}: a CUDA tensor is required, got {tensor.device}"
        )


def shift_up(words: torch.Tensor) -> torch.Tensor:
    """Every word moves one up along the last axis (word w-1 to w), 0
    into word 0: the TPU's masked one-word roll."""
    return torch.cat([torch.zeros_like(words[..., :1]), words[..., :-1]], dim=-1)


@functools.lru_cache(maxsize=None)
def start_table(values: tuple, device: torch.device) -> torch.Tensor:
    """int32 [len(values), BAND_WORDS], row a holding values[a] in every
    word: a kernel's start values as an operand, which the compiler cannot
    see through (from constants it could prove the words of an array equal
    and compute one where the function names them all). Made once per
    (values, device); the kernels only read it."""
    return (
        torch.tensor(values, dtype=torch.int32, device=device)
        .view(-1, 1).expand(len(values), BAND_WORDS).contiguous()
    )


def accelerator_or_exit() -> torch.device:
    """The Hopper GPU; exits non-zero (message on stderr) without one."""
    try:
        return accelerator_device()
    except RuntimeError as error:
        raise SystemExit(f"no GPU to time the kernels on: {error}") from None


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        raise SystemExit(f"nvidia-smi failed: {smi.stderr}")
    return smi.stdout.strip().splitlines()[0]


def best_seconds(fn) -> float:
    """One warm call, then the best of 3 calls timed with CUDA events."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        best = min(best, start.elapsed_time(stop) / 1000)
    return best
