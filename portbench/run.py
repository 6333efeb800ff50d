"""Run one cell of the port's benchmark on the CUDA card.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``compared``: each number compared with its limit,
also written as the last lines of standard error. Exits non-zero, with no
result, where no CUDA card is attached, where fewer cards are attached than
the cell asks for, and where JAX, flax or the JAX package is loaded in this
process once the window has closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "relationprediction_tpu")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def loaded_forbidden() -> list:
    """Top-level names of loaded modules that the port's run must not
    load, compared whole."""
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    import relationprediction_torch  # noqa: F401  (the system under test)
    from portbench import harness

    if not torch.cuda.is_available():
        log("no CUDA card is attached")
        return 2
    bench = harness.load_benchmark()
    entry = [w for w in bench["workloads"] if w["name"] == args.workload]
    if not entry:
        log(f"{args.workload} is not a cell of BENCHMARK.json")
        return 2
    cell = harness.load_cell(args.workload)
    chips = entry[0]["chips"]
    if torch.cuda.device_count() < chips:
        log(f"{args.workload} needs {chips} cards, "
            f"{torch.cuda.device_count()} attached")
        return 2
    device = torch.device("cuda:0")
    path = harness.window_path(cell["traffic_file"]["path"])
    outcome = path.run(harness.Run(cell, args.seed, args.seconds,
                                   bool(args.trace), device, T_START, log))
    found = loaded_forbidden()
    if found:
        log(f"loaded in the benchmark's process: {', '.join(found)}")
        return 3
    line = harness.result_line(bench, cell, outcome, bool(args.trace),
                               torch.cuda.get_device_name(0), chips)
    for name, c in outcome.compared.items():
        log(f"{name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
