"""The control of a cell: the reference with one guarantee of the
configuration broken (its `control`), put in the program's place at the
cell's own size and judged by the cell's own check.  The check has to
find it wrong on every seed; the benchmark's runs never run it.

    python3 -m benchmark.control --workload <cell> --seeds 1,2,3

prints one JSON line a seed: the numbers compared, each with its limit."""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import core


def control_checks(cell: core.Cell, seed: int, device) -> dict:
    """{name: (value, limit)} of the cell's check over the control's
    outputs for every sampled key of one run's inputs."""
    driver = core.load_driver(cell, seed, device)
    driver.setup()
    n_keys = len(getattr(driver, "order", [0]))
    first = {}
    for i in range(n_keys):
        first.setdefault(driver.sample_key(i), i)
    outputs = driver.control_outputs(list(first))
    driver.release()
    return driver.check([(i, outputs[key]) for key, i in first.items()])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.control", description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    args = p.parse_args(argv)
    cell = core.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("benchmark.control: no CUDA card", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        checks = control_checks(cell, seed, "cuda")
        failed = any(value > limit for value, limit in checks.values())
        print(json.dumps({"workload": cell.name, "seed": seed, "control_fails": failed,
                          "checks": core.check_line(checks)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
