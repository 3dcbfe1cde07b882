"""The readings that limits are set from, beside the benchmark's own runs.

    python3 -m benchmark.calibrate --workload <cell> --seeds 1,2,3 [--modes program,tf32,half_batch,altered,unchanged]

For each seed it builds the cell's inputs and weights and reads, in each
mode, ``program`` (the program's first epochs through the cell's set-up,
with no window) or the reference in the program's place: ``tf32`` (the control:
every Dense product in TF32), and the faults ``half_batch`` (half of the
batch left out, the mean over the rest), ``altered`` (the loss scaled by
1.01 where it is produced) and ``unchanged`` (no step moves the parameters
or Adam's state); the cell's judge (``drivers/fit.py``) then reads it as it
reads the program.  It prints one JSON line a seed and mode with the
numbers the comparison reads, the cell's limits and whether the run would
read correct.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from benchmark import harness

MODES = ("tf32", "half_batch", "altered", "unchanged")


def readings(root: str, workload: str, seed: int, modes, device="cuda"):
    cell, _, wl, _, _ = harness.make_cell(root, workload, seed, device)
    for mode in modes:
        if mode == "program":
            cell.setup({}, time.perf_counter)
            program = cell.program_readings()
            cell.free()
        else:
            program = cell.as_program(mode)
        checked = harness.checks(cell.judge(program), wl["limits"])
        yield {"workload": workload, "seed": seed, "mode": mode, "checks": checked,
               "correct": harness.is_correct(checked)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--modes", default=",".join(MODES))
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        for line in readings(os.getcwd(), args.workload, seed, args.modes.split(","), args.device):
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
