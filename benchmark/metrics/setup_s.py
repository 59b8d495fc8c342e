"""Set-up: process start to the first timed event (imports, kernel
builds, input generation, the Sequencer and its map, the warm-up and the
capture of the cell's own step variants)."""


def read(run):
    return run.setup_s
