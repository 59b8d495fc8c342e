"""mimosa_tpu_torch — the PyTorch/CUDA port of ``mimosa_tpu``.

The four-modality streaming estimator: the LiDAR-inertial scan step
(decode -> deskew -> downsample -> predict/append -> Gauss-Newton with
live point-to-plane ICP and, optionally, the photometric patch factor of
PG-LIO -> prior absorption -> keyframe map update), the radar Doppler and
external-odometry factors (``radar/``, ``odometry/``), and late scans and
radar frames collapsed onto a neighbouring state or inserted mid-window,
written as plain functions on torch tensors and, on the card, captured as
CUDA graphs (``graph/captured.py``). The ICP
linearization, the one kernel the JAX package wrote in Pallas
(``mimosa_tpu/ops/icp_pallas.py``), is a hand-written CUDA kernel for
Hopper here (``ops/icp_cuda.py``, ``csrc/icp_linearize.cu``); the host
scan pack of the int16 transfer codecs is the JAX package's C++
(``native/``). The entry points run on the
first CUDA device (:func:`require_cuda`) unless the caller asks for the
CPU with ``device="cpu"``.

The package mirrors ``mimosa_tpu/`` module for module and imports neither
``jax`` nor ``mimosa_tpu``: the JAX package stays the reference the port is
tested against (``tests/test_torch_*.py``).
"""

__version__ = "0.1.0"

import torch as _torch

# The window's normal equations mix information scales of 1e7 and 1e-1;
# reduced-precision (TF32) products make the Schur marginalization go NaN —
# the counterpart of the JAX package's "highest" matmul precision pin.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
# The photometric image chain's convolutions: cuDNN picks one fixed,
# deterministic algorithm (no autotuning), so a replay repeats bit for bit
# and a captured step runs the algorithm its eager warm-up ran.
_torch.backends.cudnn.deterministic = True
_torch.backends.cudnn.benchmark = False


def require_cuda() -> _torch.device:
    """The first CUDA device; raises when no card is visible."""
    if not _torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available "
                           "(torch.cuda.is_available() is False)")
    return _torch.device("cuda", 0)
