"""The conditional node of a captured CUDA graph: the branch of a step that
runs on the device only where a predicate tensor holds.

``csrc/graph_cond.cu`` (built with ``nvcc`` at first use, bound with
``ctypes``) adds to the graph being captured on the current stream a
one-thread predicate kernel, which copies a 0-d bool tensor into a
conditional handle, and an IF node on that handle; the body is captured on
a side stream into the node's own graph. torch's caching allocator routes
the body's allocations into the capturing graph's memory pool. The JAX
package's counterpart is ``lax.cond`` inside a jitted step.

Only :func:`if_node` under an active capture makes the predicate kernel's
launch; outside a capture the predicate is read on the host
(``graph/captured.py::cond``), which is this kernel's plain version.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from mimosa_tpu_torch.ops import nvcc

SOURCE = nvcc.CSRC / "graph_cond.cu"
# cudaStreamCaptureModeThreadLocal: the body's capture mode, as the
# step's own (graph/captured.py)
_THREAD_LOCAL = 1

# predicate kernel launches: a capture records one per node, and a replay
# of the graph adds what it recorded (graph/captured.py)
LAUNCHES = 0

_lib = None
build_info = None      # (seconds, compiler output) of the loaded build
_children = {}         # device index -> the stream bodies are captured on


def build():
    """Compile ``csrc/graph_cond.cu`` (cached by source hash) and load
    it."""
    global _lib, build_info
    if _lib is None:
        lib, secs, log = nvcc.build(SOURCE)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.cond_begin.argtypes = [p, p, p, i]
        lib.cond_end.argtypes = [p]
        lib.cond_begin.restype = lib.cond_end.restype = i
        _lib, build_info = lib, (secs, log)
    return _lib


def prepare(device):
    """Build the library and make ``device``'s body stream: outside any
    capture, before the first node is recorded."""
    device = torch.device(device)
    build()
    if device.index not in _children:
        _children[device.index] = torch.cuda.Stream(device)


@contextlib.contextmanager
def if_node(pred, pool):
    """Record what runs inside the block into an IF node of the graph being
    captured on the current stream, keyed on the 0-d bool tensor ``pred``:
    at each replay the block's work runs where ``pred`` holds. ``pool`` is
    the capturing graph's memory pool. The block's outputs must be tensors
    made before it (the graph after the node reads fixed addresses)."""
    global LAUNCHES
    dev = pred.device
    if pred.dtype != torch.bool or pred.dim() != 0 or dev.type != "cuda":
        raise ValueError("if_node needs a 0-d bool CUDA tensor")
    child = _children.get(dev.index)
    if child is None:
        raise RuntimeError("cond_cuda.prepare must run before the capture")
    code = build().cond_begin(torch.cuda.current_stream(dev).cuda_stream,
                              child.cuda_stream, pred.data_ptr(),
                              _THREAD_LOCAL)
    if code != 0:
        raise RuntimeError(f"cond_begin failed: CUDA error {code}")
    LAUNCHES += 1
    # the capture routes its allocations into the pool by its capture id,
    # which the body's capture does not share: route this thread's
    # allocations there instead, for the rest of the capture (its end
    # removes that routing; the pool's count of users stays as it was)
    torch._C._cuda_endAllocateToPool(dev.index, pool)
    torch._C._cuda_beginAllocateCurrentThreadToPool(dev.index, pool)
    torch._C._cuda_releasePool(dev.index, pool)
    try:
        with torch.cuda.stream(child):
            yield
    finally:
        code = build().cond_end(child.cuda_stream)
    if code != 0:
        raise RuntimeError(f"cond_end failed: CUDA error {code}")
