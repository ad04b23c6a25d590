"""Run one benchmark cell once on the card and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
--trace 1 its per-layer metrics), `device`, with --trace 1 `breakdown`,
and last `checks`, each number the check compared beside its limit.  The
same numbers close standard error.  With no CUDA card, or fewer cards than
the cell asks for, it prints no result and exits 2; if a module of JAX or
of the JAX package is loaded once the window has closed, it exits 3."""

import time

T_START = time.perf_counter()  # set-up counts from here, before the imports

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python3 -m benchmark.run", description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True, help="length of the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    from . import core

    cell = core.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    line, info = core.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    found = core.forbidden_modules()
    if found:
        print(f"benchmark: modules of JAX or the JAX package were loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    print("timings " + " ".join(f"{k} {v:.3f}" for k, v in info["timings"].items()), file=sys.stderr)
    for err in info["errors"]:
        print(f"benchmark: {err}", file=sys.stderr)
    for name, (value, limit) in info["checks"].items():
        print(f"check {name} {value} limit {limit}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(line), flush=True)
    return 0 if line["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
