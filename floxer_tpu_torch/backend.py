"""Which device the port verifies on.

Replaces floxer_tpu/backend.py and floxer_tpu/pipeline.py's
_accelerator_available: the port's kernels are built for Hopper (sm_90a),
so a CUDA device of compute capability 9.0 or newer is the accelerator.

FLOXER_TPU_PLATFORM=cpu, as in the reference, keeps the run off the
accelerator: accelerator_available() is False and pipeline.run() takes the
CPU device where it would take cuda:0, so the batched engine stays on the
host and device work runs on the kernels' plain versions. The reference
hands any other value to jax_platforms; the port leaves its choice as it
is for them.
"""

from __future__ import annotations

import os

import torch

MIN_CAPABILITY = (9, 0)
PLATFORM_ENV = "FLOXER_TPU_PLATFORM"


def cpu_requested() -> bool:
    """True when FLOXER_TPU_PLATFORM asks for the CPU."""
    return os.environ.get(PLATFORM_ENV, "").strip().lower() == "cpu"


def accelerator_available() -> bool:
    """True when CUDA device 0 exists and is a Hopper-class GPU, and the
    CPU is not requested."""
    return (
        not cpu_requested()
        and torch.cuda.is_available()
        and torch.cuda.get_device_capability(0) >= MIN_CAPABILITY
    )


def accelerator_device() -> torch.device:
    """The device the port verifies on; raises when there is none."""
    if not accelerator_available():
        raise RuntimeError(
            "no CUDA device of compute capability >= 9.0 (Hopper) is "
            "available; the port's kernels are built for sm_90a"
        )
    return torch.device("cuda", 0)
