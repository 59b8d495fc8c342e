"""Checkpoint / resume of the full estimator state.

The port of ``mimosa_tpu/utils/checkpoint.py``. The reference has none
(SURVEY.md §5: "The estimator state (map, window, biases) is not
serializable"); for long runs restartability is required, so every device
tensor of the Sequencer (window, voxel map, preintegration chain, features,
keyframes, trajectory ring, debug records) plus the host-side sequencer
state (IMU buffer, timestamps, counters) round-trips through one
compressed npz. Beside the host fields of the JAX package's checkpoint
(``_HOST_ATTRS``, the port's ``convert.SEQ_HOST``) the port's also
carries the radar and odometry configurations and the odometry anchor
where they are set (``convert.SEQ_HOST_SENSORS``), so a run stopped
mid-odometry-stream resumes with the same next between factor.

On the card :func:`load` replaces the Sequencer's state tensors; the
captured steps (``graph/captured.py``) copy the new values into their
static buffers at the next step, so the graphs already recorded go on
replaying on the loaded state.
"""

from __future__ import annotations

import json

import numpy as np

from mimosa_tpu_torch import convert
from mimosa_tpu_torch.lidar.photometric import Features

# the state tuples, saved leaf by leaf in field order
_FIELDS = {name: cls._fields for name, cls in convert._TUPLES
           + (("features", Features),)}


def save(seq, path):
    """Serialize a port Sequencer to ``path`` (npz), in the JAX package's
    layout: each state tuple's fields as ``name__i`` in field order, each
    single tensor as ``name__0``, the leaf counts and the host state in
    ``_meta`` (so ``scripts/export_map.py`` and ``scripts/plot_debug.py``
    read it as they read the JAX package's)."""
    state = convert.sequencer_state(seq)
    meta = {"tree": {}, "host": state.pop("host")}
    imu = state.pop("imu")
    arrays = {f"imu_{k}": v for k, v in imu.items()}
    for name, v in state.items():
        leaves = [v[k] for k in _FIELDS[name]] if isinstance(v, dict) \
            else [v]
        meta["tree"][name] = len(leaves)
        arrays.update({f"{name}__{i}": a for i, a in enumerate(leaves)})
    arrays["_meta"] = np.frombuffer(
        json.dumps(meta, default=float).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def _tuples(v):
    """JSON lists back to the tuples the config dataclasses hold."""
    if isinstance(v, dict):
        return {k: _tuples(x) for k, x in v.items()}
    if isinstance(v, list):
        return tuple(_tuples(x) for x in v)
    return v


def load(seq, path):
    """Restore a Sequencer's state in place. ``seq`` must be constructed
    with the same configs (shapes must match)."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z["_meta"]).decode())
        state = {}
        for name, n in meta["tree"].items():
            if n is None:
                continue
            state[name] = {k: z[f"{name}__{i}"] for i, k in enumerate(
                _FIELDS[name])} if name in _FIELDS else z[f"{name}__0"]
        state["imu"] = {k: z[f"imu_{k}"] for k in ("ts", "acc", "gyro")}
    host = meta["host"]
    for k in convert.SEQ_HOST_SENSORS:
        if k in host and k != "_odom_prev":
            host[k] = _tuples(host[k])
    state["host"] = host
    return convert.load_sequencer_state(seq, state)
