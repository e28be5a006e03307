"""Device selection for the port (counterpart of
`mpisppy_tpu/utils/platform.py`).

Every entry point of the port takes `device=None` and resolves it here:
None means the CUDA device, and a missing CUDA runtime is an error —
the port never carries on silently on the CPU.  Tests and CPU callers
pass `device="cpu"` explicitly.
"""

from __future__ import annotations

import numpy as np
import torch


def host(t):
    """A tensor (on any device) or an array-like as a numpy array."""
    if torch.is_tensor(t):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _pin_full_fp32():
    # TF32 keeps ~3 decimal digits.  The PDHG eps floor (100 x machine
    # epsilon of the loop dtype, ops.pdhg.eps_floor) and the hot-dtype
    # promotion rule built on it assume that "float32" means IEEE
    # float32 on every matmul/einsum, so TF32 is turned off explicitly
    # for both cuBLAS and cuDNN rather than relying on defaults.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The torch.device an entry point runs on: `device` as given, or
    the current CUDA device when None.  Raises RuntimeError when CUDA
    is requested (explicitly or by default) but unavailable."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "mpisppy_tpu_torch runs on a CUDA device by default and "
                "torch.cuda.is_available() is False; pass device='cpu' "
                "to run on the CPU explicitly")
        _pin_full_fp32()
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
