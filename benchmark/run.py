"""The benchmark of spray_tpu_torch: one run of one cell on the card.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Sets up the cell named in BENCHMARK.json (scene, pages, kernels, one
warm-up step), measures for --seconds, checks what the last step produced
against the plain reference, and prints one JSON line last on stdout:
`correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end
metrics, or with --trace 1 its per-layer ones), `device` and, traced,
`breakdown`, then `checks`: each number compared beside its limit, also
printed as the last lines on stderr.  A cell of `chips` N > 1 runs in N
ranks, one a card (`benchmark/ranks.py`).  Without the cards the cell
asks for, with fewer cards used than it asks for, with a rank that fails,
or with a module of the JAX stack or of the JAX package loaded, it exits
non-zero and prints no result.
"""

import time

T_START = time.perf_counter()  # the start of the process, for setup_s

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark import guard  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cache_env(root):
    """Build and kernel caches at fixed paths inside the checkout (the
    program's own nvcc and g++ outputs already go to build/kernels and
    build/native there)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(root / "build" / "bench_cache" / sub)
    os.environ["USE_FLAX"] = "0"


def main(argv=None):
    args = parse(argv)
    guard.check("start")
    cache_env(ROOT)
    import torch  # noqa: PLC0415

    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in manifest["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    chips = int(cells[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from benchmark.harness import run_cell  # noqa: PLC0415

    result = run_cell(ROOT, manifest, args.workload, args.seed, args.seconds,
                      args.trace, T_START)
    used = result["device"]["count"]
    if used < chips:
        print(f"needs {chips} CUDA device(s); the run used {used}",
              file=sys.stderr)
        return 2
    guard.check("end")
    for name, e in result["checks"].items():
        print(f"check {name} {e['value']!r} limit {e['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
