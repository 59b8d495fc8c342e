"""The Sequencer's steps captured as CUDA graphs: one graph per variant.

The torch counterpart of the JAX package's "one XLA program per scan"
(``jax.jit`` of ``_scan_step``). A step variant is a function of the
Sequencer's device state and its inputs (a staged scan, IMU segments, a
radar or odometry pack, each with a scalar row of slots and indices) with
static shapes that never reads back to the host, so its kernels can be
recorded once and replayed:

* the first time a variant runs it runs eagerly on a side stream (the
  warm-up ``torch.cuda.graphs`` asks for: cuBLAS / cuSOLVER handles and
  workspaces are made there, not during capture);
* the next time it is captured and replayed, and from then on replayed.

The state lives in static device buffers that every graph reads and
writes: a graph ends by copying the step's outputs into them, and inputs
are copied into static input buffers before each replay. When the
Sequencer's state tensors change shape (the trajectory rings grow), the
buffers are made anew and every graph is captured again; when they are
only replaced by other tensors (initialization, a loaded state), their
values are copied in. A capture that fails raises: nothing falls back to
eager execution.

A branch that a step takes only on some inputs (the scan step's
tracking-loss rescue) is :func:`cond`: under capture its body is recorded
into a conditional node of the graph, which runs it where a device
predicate holds, so a replay still reads nothing back to the host. The
node's outputs are buffers made before it, which the body overwrites; an
eager warm-up runs the body whatever the predicate, so its library handles
and workspaces exist before the capture.

A Sequencer on a mesh (``parallel/sharded.py``) makes ``torch.distributed``
collectives inside its steps; under capture they are recorded into the
graph (and into a conditional node's body) like any other work on the
stream. A process group makes its communicator at its first collective,
which a capture does not allow: the variant's eager warm-up makes it.

One CapturedSteps may serve several Sequencers of one configuration
(``Sequencer(step_cache=)``). The static buffers then hold the state of
the Sequencer that ran last (``owner``); before another one's step, the
last one copies its state out of them (its ``_own_state``).

``ops.icp_cuda.LAUNCHES`` counts the ICP kernel's launches: a capture
records the kernel without running it, so the count a graph recorded is
taken back after the capture and added again at each replay. Launches
inside a conditional node are counted on the device by the node itself
(``icp_cuda.body_counter``; ``icp_cuda.launches()`` reads them). That
count is bookkeeping; ``chip_smoke.py`` and ``tests/test_torch_cuda.py``
hold it against the kernels the profiler sees run on the card.
"""

from __future__ import annotations

import gc
import threading
import weakref

import torch
import torch.utils._pytree as pytree

from mimosa_tpu_torch.ops import cond_cuda, icp_cuda

# this thread's step in progress: ``warming`` while a variant runs its
# eager warm-up (cond then runs its body whatever the predicate), ``pool``
# the memory pool of the graph being captured (a node's body goes there)
_step = threading.local()


def cond(pred, body, otherwise):
    """``body()`` where the 0-d bool tensor ``pred`` holds, else
    ``otherwise`` (tensors, or tuples and NamedTuples of them, with the
    structure, shapes and dtypes ``body()`` returns).

    Under a CUDA graph capture the body is recorded into an ``if`` node of
    the graph, so the choice is made on the device at each replay: the
    outputs are copies of ``otherwise`` made before the node, which the
    body overwrites in place. Outside a capture the predicate is read on
    the host (the CPU, an eager step, a variant's warm-up)."""
    if pred.is_cuda:
        if torch.cuda.is_current_stream_capturing():
            return _if_node(pred, body, otherwise)
        # made before any capture
        cond_cuda.prepare(pred.device)
        icp_cuda.body_counter(pred.device)
    if getattr(_step, "warming", False):
        taken = body()
        return taken if bool(pred) else otherwise
    return body() if bool(pred) else otherwise


def _if_node(pred, body, otherwise):
    """Record ``body`` into a conditional node keyed on ``pred`` (see
    :func:`cond`). The ICP launches it records leave the graph's count and
    are added on the device by the body itself."""
    leaves, spec = pytree.tree_flatten(otherwise)
    out = [x.clone() for x in leaves]
    before = icp_cuda.LAUNCHES
    try:
        with cond_cuda.if_node(pred, _step.pool):
            taken, taken_spec = pytree.tree_flatten(body())
            if taken_spec != spec:
                raise ValueError("cond: the body's outputs are not shaped "
                                 "as its alternative")
            for o, t in zip(out, taken):
                o.copy_(t)
            n = icp_cuda.LAUNCHES - before
            if n:
                icp_cuda.body_counter(pred.device).add_(n)
    finally:
        icp_cuda.LAUNCHES = before
    return pytree.tree_unflatten(out, spec)


def flatten(state):
    """A tuple of tensors and NamedTuples of tensors -> (tensors, spec)."""
    flat, spec = [], []
    for x in state:
        if torch.is_tensor(x):
            flat.append(x)
            spec.append(None)
        else:
            flat.extend(x)
            spec.append(type(x))
    return flat, spec


def unflatten(flat, spec):
    out, i = [], 0
    for cls in spec:
        if cls is None:
            out.append(flat[i])
            i += 1
        else:
            n = len(cls._fields)
            out.append(cls(*flat[i:i + n]))
            i += n
    return tuple(out)


def _storages(tensors):
    return {t.untyped_storage().data_ptr() for t in tensors}


def write_back(bufs, outs):
    """bufs[i] <- outs[i] for every output that is not the buffer itself.
    An output that shares storage with a state buffer (a field passed
    through into another field) is cloned first, so no copy reads a buffer
    that an earlier copy has overwritten."""
    held = _storages(bufs)
    outs = [o if o is b or o.untyped_storage().data_ptr() not in held
            else o.clone() for b, o in zip(bufs, outs)]
    for b, o in zip(bufs, outs):
        if o is not b:
            b.copy_(o)


class CapturedSteps:
    """Captures and replays the Sequencer's step variants on one device."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.graphs = {}        # variant -> (CUDAGraph, ICP launches)
        self.nodes = {}         # variant -> conditional nodes its graph holds
        self.warm = set()       # variants that ran their eager warm-up
        self.captures = 0       # graphs captured so far (all variants)
        self.replays = 0
        self._bufs = None       # the static state buffers
        self._spec = None
        self._inputs = {}       # variant -> static input buffers
        self._owner = None      # weak reference to the last step's owner

    def _adopt(self, state):
        """The static state buffers, holding the values of ``state``."""
        flat, self._spec = flatten(state)
        bufs = self._bufs
        if bufs is None or any(b.shape != t.shape
                               for b, t in zip(bufs, flat)):
            # new addresses: the graphs that hold the old ones must go
            self.graphs.clear()
            self._bufs = [t.clone() for t in flat]
        else:
            for b, t in zip(bufs, flat):
                if t is not b:
                    b.copy_(t)
        return self._bufs

    def _static_inputs(self, key, inputs):
        """The variant's static input buffers, holding ``inputs`` (a
        variant's inputs keep their shapes: the configuration fixes
        them)."""
        bufs = self._inputs.get(key)
        if bufs is None:
            bufs = self._inputs[key] = [None if x is None else x.clone()
                                        for x in inputs]
        else:
            for b, x in zip(bufs, inputs):
                if x is not None:
                    b.copy_(x, non_blocking=True)
        return bufs

    def _hand_over(self, owner):
        """Make ``owner`` the holder of the static buffers: the last owner,
        if another and still alive, first copies its state out of them."""
        last = self._owner() if self._owner is not None else None
        if last is not None and last is not owner and self._bufs is not None:
            last._own_state(self._bufs)
        self._owner = None if owner is None else weakref.ref(owner)

    def run(self, key, fn, state, inputs=(), owner=None):
        """One step of variant ``key``: ``fn(state, *inputs)`` returns the
        new state (same structure, shapes and types). Returns the static
        state buffers, which hold the new state once the stream has run.
        ``owner`` (an object with ``_own_state(bufs)``, the Sequencer whose
        state this is) lets several share this object."""
        self._hand_over(owner)
        bufs = self._adopt(state)
        ins = self._static_inputs(key, inputs)
        if key not in self.warm:
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            _step.warming = True
            try:
                with torch.cuda.stream(side):
                    out = fn(unflatten(bufs, self._spec), *ins)
                    write_back(bufs, flatten(out)[0])
            finally:
                _step.warming = False
            torch.cuda.current_stream(self.device).wait_stream(side)
            self.warm.add(key)
        else:
            if key not in self.graphs:
                graph, launches, self.nodes[key] = self._capture(fn, bufs,
                                                                 ins)
                self.graphs[key] = (graph, launches)
            graph, launches = self.graphs[key]
            graph.replay()
            icp_cuda.LAUNCHES += launches
            cond_cuda.LAUNCHES += self.nodes[key]
            self.replays += 1
        return unflatten(bufs, self._spec)

    def _capture(self, fn, bufs, ins):
        """Record ``fn`` into a new graph. The cyclic garbage collector is
        off meanwhile: a collection inside the capture could free CUDA
        resources of unrelated objects (an old Sequencer's graphs), a call
        a capture does not allow. Other threads' CUDA calls do not end
        this thread's capture (``thread_local``)."""
        graph, pool = torch.cuda.CUDAGraph(), torch.cuda.graph_pool_handle()
        before, nodes = icp_cuda.LAUNCHES, cond_cuda.LAUNCHES
        collecting = gc.isenabled()
        try:
            # torch.cuda.graph collects once before the capture starts
            with torch.cuda.graph(graph, pool=pool,
                                  capture_error_mode="thread_local"):
                gc.disable()
                _step.pool = pool
                out = fn(unflatten(bufs, self._spec), *ins)
                write_back(bufs, flatten(out)[0])
        finally:
            _step.pool = None
            if collecting:
                gc.enable()
            launches = icp_cuda.LAUNCHES - before
            icp_cuda.LAUNCHES = before
            nodes, cond_cuda.LAUNCHES = cond_cuda.LAUNCHES - nodes, nodes
        self.captures += 1
        return graph, launches, nodes
