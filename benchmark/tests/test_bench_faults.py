"""The comparison that decides ``correct`` catches what it is there for,
on cut cells on the CPU (the harness's look for a card skipped, the rest
of a run driven as on the card): a sound run is correct; the control (the
reference held in bfloat16 in the program's place) is not; nor is a run
whose timed path is broken underneath: a step that returns its state
unchanged, half of a bulk chunk left out, an answer altered where it is
produced, the photometric factor left out of the scan step. One card is
the whole deployment here, so no exchange between chips can be left
out."""

import copy

import numpy as np
import pytest

from benchmark import harness, reference, system
from benchmark.tests import tiny

# limits of the cut cells: above what their sound runs read on the CPU,
# below the control's readings at the same cut
LIMITS = {
    "enwide_bulk": {"missing_states": 0, "rel_pos_gap_m": 0.05,
                    "rel_pos_rms_m": 0.015, "rel_rot_gap_rad": 0.005,
                    "rel_rot_rms_rad": 0.0015, "photo_unused_share": 0.5},
    "enwide_stream": {"missing_states": 0, "rel_pos_gap_m": 0.05,
                      "rel_pos_rms_m": 0.015, "rel_rot_gap_rad": 0.005,
                      "rel_rot_rms_rad": 0.0025, "photo_unused_share": 0.5},
}


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return harness.Bench(tiny.make(tmp_path_factory.mktemp("cut"), LIMITS))


def run(bench, cell, make=system.System, seconds=4.0):
    return harness.measure(bench, cell, 2**31 + 3, seconds, False,
                           device="cpu", hooks={"system": make})


class Armed(system.System):
    """Breaks its timed path once the window starts (``drive.Driver`` reads the
    program's timers at the window's start)."""

    armed = False

    def timers(self):
        self.armed = True
        return super().timers()


class Unchanged(Armed):
    """Every scan step of the window returns the state it was given."""

    def __init__(self, cfg, device):
        super().__init__(cfg, device)
        run_step = self.seq._run

        def step(key, inputs=()):
            if not (self.armed and key[0] == "scan"):
                run_step(key, inputs)
        self.seq._run = step


class HalfChunk(system.System):
    """The bulk scheduler gets every other event of each chunk."""

    def hand_bulk(self, events, chunk):
        super().hand_bulk(events[::2], chunk)


class Altered(Armed):
    """One answer of the window leaves the program 0.3 m off."""

    def __init__(self, cfg, device):
        super().__init__(cfg, device)
        seq = self.seq
        state, traj = seq.current_state, type(seq).trajectory.fget
        self.calls = 0
        off = np.array([0.3, 0.0, 0.0])

        def current_state():
            st = state()
            self.calls += self.armed
            return st._replace(p=st.p + off) if self.calls == 3 else st

        def trajectory():
            rows = traj(seq)
            if self.armed and len(rows) > 5:
                t, p, q = rows[-3]
                rows[-3] = (t, (p + off).astype(p.dtype), q)
            return rows
        seq.current_state = current_state
        self.trajectory = trajectory


class NoPhoto(system.System):
    """The scan step runs without its photometric factor."""

    def __init__(self, cfg, device):
        cfg = copy.deepcopy(cfg)
        del cfg["system"]["photometric"]
        super().__init__(cfg, device)
        self.photometric = True


@pytest.mark.parametrize("cell", ["enwide_bulk", "enwide_stream"])
def test_sound_runs_pass_and_the_control_fails(bench, cell):
    r = run(bench, cell)
    assert r.correct, r.checks
    ts, q, p = r.states
    qc, pc, _ = reference.truth(r.config, ts, "bfloat16")
    numbers = reference.judge(r.config, 0, ts, qc, pc)
    # the reference's own numbers: the control has no photometric records
    ok, rows = reference.verdict(numbers, {
        k: v for k, v in bench.limits(cell).items() if k in numbers})
    assert not ok, rows


@pytest.mark.parametrize("cell,fault", [
    ("enwide_bulk", Unchanged), ("enwide_stream", Unchanged),
    ("enwide_bulk", HalfChunk), ("enwide_bulk", Altered),
    ("enwide_stream", Altered), ("enwide_bulk", NoPhoto),
    ("enwide_stream", NoPhoto)])
def test_a_broken_timed_path_is_not_correct(bench, cell, fault):
    r = run(bench, cell, fault)
    assert not r.correct, r.checks
