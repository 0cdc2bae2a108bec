"""Run one cell of ``BENCHMARK.json`` and print its result as the last line.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Exits 2 without a result when there is no CUDA card or fewer than the cell
asks for, when ``yolo_tpu_torch`` is not the checkout's own, and exits 3
when a module of the JAX stack or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="portbench.run", description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from portbench import harness

    bench = harness.read_json(ROOT / "BENCHMARK.json")
    cell_path = harness.HERE / "workloads" / f"{args.workload}.json"
    if not cell_path.is_file():
        harness.log(f"portbench: no cell {args.workload!r} ({cell_path})")
        return 2
    cell = harness.read_json(cell_path)
    config = harness.read_json(harness.HERE / "configs" / f"{cell['config']}.json")

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        harness.log(f"portbench: the cell needs {cell['chips']} CUDA device(s); "
                    f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    try:
        import yolo_tpu_torch
    except ImportError as exc:
        harness.log(f"portbench: the program is missing from this checkout: {exc}")
        return 2
    if Path(yolo_tpu_torch.__file__).resolve().parent.parent != ROOT:
        harness.log(f"portbench: yolo_tpu_torch comes from {yolo_tpu_torch.__file__}, not "
                    f"from this checkout")
        return 2

    run = harness.Run(cell=cell, config=config, seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace), device=torch.device("cuda", 0),
                      t_process=T_PROCESS)
    torch.cuda.set_device(run.device)
    harness.execute(run)
    out = harness.result(run, bench)
    found = harness.forbidden_modules()
    if found:
        harness.log(f"portbench: forbidden modules were loaded: {', '.join(found)}")
        return 3
    for note in run.notes:
        harness.log(note)
    for name, (value, limit) in run.checks.items():
        harness.log(f"check {name}: {value!r} limit {limit!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
