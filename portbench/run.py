"""Run one cell of the port's benchmark once and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  It runs on the CUDA cards of the machine it
starts on and never falls back to the CPU: without enough cards it prints
no result and exits with 2.  Its last line on standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` also ``breakdown``, and last ``limits``: each number
compared with the reference beside its limit); the same numbers are the
last lines on standard error.  It exits with 3, printing no result, if
JAX or the JAX package was loaded, by the time the window closed, in this
process or in the process of any other rank of the cell.
"""

import time

_CLOCK_AT_IMPORT = time.perf_counter()     # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def _parse(argv):
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def report(result: dict) -> int:
    """Print the result (the numbers compared on standard error, then the
    line) and return 0; or, where a rank's process held JAX or the JAX
    package, name what it held and return 3 with no result."""
    from portbench.harness import forbidden_modules

    loaded = {r: set(names) for r, names in result.pop("_forbidden").items()}
    loaded.setdefault(0, set()).update(forbidden_modules())
    found = [f"rank {r}: {', '.join(sorted(m))}" for r, m in sorted(loaded.items()) if m]
    if found:
        print(f"portbench: loaded in the measuring processes ({'; '.join(found)}); "
              "no result", file=sys.stderr)
        return 3
    for line in result.pop("_check_lines"):
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


def main(argv=None) -> int:
    args = _parse(argv)
    import torch

    from portbench.harness import Options, run_cell
    from portbench.spec import Benchmark

    bench = Benchmark()
    cell = bench.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA card(s), "
              f"found {found}; no result", file=sys.stderr)
        return 2
    result = run_cell(bench, args.workload,
                      Options(args.seed, args.seconds, bool(args.trace)),
                      _CLOCK_AT_IMPORT)
    return report(result)


if __name__ == "__main__":
    sys.exit(main())
