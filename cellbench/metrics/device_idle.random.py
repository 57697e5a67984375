"""device_idle.random: `device_idle` read per layer in the cell
rgg_2e20.heistream_random, whose host-bound jobs swing too widely from
run to run for an end-to-end bound on the rate or the tail; that cell's
end-to-end metrics are `peak_device_mib` and `setup_s`."""
from pathlib import Path

from cellbench.harness import spec

read = spec.reader(Path(__file__).resolve().parents[1], "device_idle")
