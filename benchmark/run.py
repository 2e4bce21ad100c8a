"""Runs one benchmark cell once on the card and prints its result line.

  python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

(or ``python3 -m benchmark.run ...``) from the root of a checkout. The last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace 1``
its per-layer ones), ``device``, ``breakdown`` when traced, and ``checks``
(each number compared with its limit), which also end standard error. The
run fails, printing no result, without a CUDA card, with fewer cards than
the cell asks for, or where a module of the JAX stack was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# build and kernel caches at fixed paths inside the checkout (``build/`` is
# ignored by git): the port's nvcc builds go to build/kernels/ by themselves
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
# one process with one host thread: the host-bound cells read steadier
# without intra-op thread pools spinning beside the dispatching thread
os.environ["OMP_NUM_THREADS"] = os.environ["MKL_NUM_THREADS"] = "1"
if sys.path[0] == str(Path(__file__).resolve().parent):
    sys.path[0] = str(ROOT)
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from benchmark import harness

    t_import = time.perf_counter() - T_START
    torch.set_num_threads(1)
    if torch.cuda.is_available():
        torch.cuda.init()
    print(f"benchmark: torch imported at {t_import:.3f} s, CUDA ready at "
          f"{time.perf_counter() - T_START:.3f} s", file=sys.stderr)

    bench = harness.load_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"benchmark: no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"benchmark: {args.workload} needs {entry['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                         T_START, device="cuda", bench=bench)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
