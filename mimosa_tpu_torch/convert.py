"""State carried across between the JAX package and the port.

This system has no weights: what a run carries is its state — the window
(estimates + Gaussian prior), the voxel map, the stacked IMU
preintegration segments, the logging rings and the host bookkeeping. The
JAX package's state is handed over as numpy arrays (``np.asarray`` of each
field, keyed by the same field names), so this module needs neither jax
nor ``mimosa_tpu``:

    state = {"window": {...}, "vmap": {...}, "preints": {...},
             "fv": ..., "kf_q": ..., "kf_p": ..., "kf_count": ...,
             "traj_q": ..., "traj_p": ..., "debug_rec": ...,
             "host": {...}, "imu": {"ts": ..., "acc": ..., "gyro": ...}}

plus ``"features": {...}`` (the photometric feature store, a
``lidar.photometric.Features`` by field) for a photometric Sequencer.
``"host"`` also carries, where set (``SEQ_HOST_SENSORS``), the radar and
odometry configurations as dicts of their fields and the odometry anchor
``_odom_prev`` as dict(slot, q, t) with q and t as tuples of floats, so
that a state taken mid-odometry-stream continues with the same next
between factor.

``load_sequencer_state`` starts a port Sequencer from such a state and
``sequencer_state`` reads one back, so a test can run both packages from
the same window and map and compare them field by field.

A mesh-sharded map (``parallel/sharded.py``) travels the same way: the
JAX package stacks its mp sub-tables as ``[n_mp, C+1, ...]``, a rank of
the port holds one. ``sharded_map_from_numpy`` takes a rank's sub-table
out of such a stack, and ``gather_sharded_map`` gathers the ranks' tables
back into one.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from mimosa_tpu_torch.graph.window import Window
from mimosa_tpu_torch.imu.preintegration import PreintState
from mimosa_tpu_torch.lidar.photometric import Features
from mimosa_tpu_torch.mapping.voxel_hash import VoxelMap
from mimosa_tpu_torch.odometry.factor import OdometryConfig
from mimosa_tpu_torch.radar.factor import RadarConfig

# device-resident sequencer fields besides the three state tuples
SEQ_ARRAYS = ("fv", "kf_q", "kf_p", "kf_count", "traj_q", "traj_p",
              "debug_rec")
# host bookkeeping that must travel with the device state
SEQ_HOST = ("n_active", "initialized", "scan_idx", "last_state_ts",
            "state_ts", "counters", "_traj_ts", "_traj_src")
# host state of the radar and odometry streams, carried where set: absent
# from a state (a JAX Sequencer sets them lazily) means None
SEQ_HOST_SENSORS = ("radar_cfg", "odom_cfg", "_odom_prev")
_SENSOR_CFGS = dict(radar_cfg=RadarConfig, odom_cfg=OdometryConfig)
_TUPLES = (("window", Window), ("vmap", VoxelMap), ("preints", PreintState))


def to_numpy(x):
    """A tensor, or a NamedTuple of tensors, as numpy (a dict by field)."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return {k: to_numpy(v) for k, v in x._asdict().items()}


def from_numpy(a, device=None, dtype=torch.float32):
    """numpy -> tensor on ``device``; floating arrays take ``dtype``,
    integer and bool arrays keep their type."""
    a = np.asarray(a)
    t = torch.from_numpy(np.array(a))
    if a.dtype.kind == "f":
        t = t.to(dtype)
    return t.to(device)


def tuple_from_numpy(cls, arrs, device=None, dtype=torch.float32):
    """A Window / VoxelMap / PreintState from a dict of numpy arrays."""
    missing = set(cls._fields) - set(arrs)
    if missing:
        raise KeyError(f"{cls.__name__} fields missing: {sorted(missing)}")
    return cls(**{k: from_numpy(arrs[k], device, dtype)
                  for k in cls._fields})


def sharded_map_from_numpy(stacked: dict, mp_index, device=None,
                           dtype=torch.float32) -> VoxelMap:
    """Row ``mp_index`` of a stacked map (a dict of ``[n_mp, C+1, ...]``
    arrays by field, the JAX package's ``create_sharded_map`` layout): the
    sub-table of a rank at that mp index."""
    return tuple_from_numpy(VoxelMap, {k: np.asarray(v)[mp_index]
                                       for k, v in stacked.items()},
                            device, dtype)


def gather_sharded_map(vmap: VoxelMap, mesh) -> dict:
    """The mp sub-tables of a mesh gathered into the stacked layout
    (numpy, by field, ``[n_mp, C+1, ...]`` in mp order), on every rank
    (``all_gather_object`` over the mesh's mp group)."""
    import torch.distributed as dist

    g = mesh.get_group("mp")
    tables = [None] * dist.get_world_size(g)
    dist.all_gather_object(tables, to_numpy(vmap), group=g)
    return {k: np.stack([t[k] for t in tables]) for k in VoxelMap._fields}


def sensor_host(seq) -> dict:
    """The set ``SEQ_HOST_SENSORS`` fields of a Sequencer (either
    package's) as plain Python values."""
    out = {}
    for k in SEQ_HOST_SENSORS:
        v = getattr(seq, k, None)
        if v is None:
            continue
        if k == "_odom_prev":
            v = dict(slot=int(v["slot"]),
                     q=tuple(float(x) for x in np.asarray(v["q"])),
                     t=tuple(float(x) for x in np.asarray(v["t"])))
        else:
            v = dataclasses.asdict(v)
        out[k] = v
    return out


def _load_sensor_host(seq, host: dict):
    for k in SEQ_HOST_SENSORS:
        v = host.get(k)
        if v is not None and k == "_odom_prev":
            v = dict(slot=int(v["slot"]), q=np.asarray(v["q"], float),
                     t=np.asarray(v["t"], float))
        elif v is not None:
            v = _SENSOR_CFGS[k](**(v if isinstance(v, dict)
                                   else dataclasses.asdict(v)))
        setattr(seq, k, v)


def sequencer_state(seq) -> dict:
    """The port Sequencer's full state as numpy + plain Python values."""
    state = {name: to_numpy(getattr(seq, name)) for name, _ in _TUPLES}
    state.update({name: to_numpy(getattr(seq, name)) for name in SEQ_ARRAYS})
    state["host"] = {k: copy.deepcopy(getattr(seq, k)) for k in SEQ_HOST}
    state["host"].update(sensor_host(seq))
    state["imu"] = dict(ts=seq.imu.ts.copy(), acc=seq.imu.acc.copy(),
                        gyro=seq.imu.gyro.copy())
    if seq.features is not None:
        state["features"] = to_numpy(seq.features)
    return state


def load_sequencer_state(seq, state: dict):
    """Replace a port Sequencer's state with ``state`` (see module doc);
    shapes must match the Sequencer's configuration. A photometric
    Sequencer needs the state's ``"features"``."""
    dev, dt = seq.device, seq.dtype
    tuples = _TUPLES
    if seq.features is not None:
        if "features" not in state:
            raise KeyError("a photometric Sequencer needs the state's "
                           "'features'")
        tuples = _TUPLES + (("features", Features),)
    for name, cls in tuples:
        new = tuple_from_numpy(cls, state[name], dev, dt)
        for k, old in zip(cls._fields, getattr(seq, name)):
            if tuple(getattr(new, k).shape) != tuple(old.shape):
                raise ValueError(f"{name}.{k}: shape {tuple(old.shape)} "
                                 f"expected, got "
                                 f"{tuple(getattr(new, k).shape)}")
        setattr(seq, name, new)
    for name in SEQ_ARRAYS:
        setattr(seq, name, from_numpy(state[name], dev, dt))
    for k in SEQ_HOST:
        setattr(seq, k, copy.deepcopy(state["host"][k]))
    _load_sensor_host(seq, state["host"])
    imu = state["imu"]
    seq.imu.load(imu["ts"], imu["acc"], imu["gyro"])
    return seq
