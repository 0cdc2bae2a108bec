"""The control of ``correct``: the plain reference put in the program's place,
computed one precision below the configuration's (int4 for the int8
engines, float8 for bf16 training), has to come out as not correct.

    python -m portbench.control --workload <cell> --seeds 1,2,3 [--seconds 2] [--sound 1]
        [--control 0] [--fault half_batch]

prints, for each seed, one JSON line with the numbers that the cell's check
compares: the control's (``"side": "control"``) and, with ``--sound 1``, a
sound run of the program's in the same process (``"side": "program"``); with
``--fault half_batch`` (training) a run whose steps take half of each batch
(``"side": "half_batch"``). The benchmark's own runs never run these;
``tests/`` runs them at a test size.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def control_hooks(run) -> dict:
    """Hooks that serve the reference at the precision below in the program's place."""
    from portbench import systems

    if run.cell["driver"] == "train":
        return {}
    p, cfg = run.params, run.model_config()
    ref = run.reference()
    state = ref.prepare(cfg, systems.seeded_weights(run), systems.calibration_images(run), 7)
    conf, iou = float(p["conf_threshold"]), float(p["nms_threshold"])

    def served(images):
        import torch

        return ref.serve(cfg, state, torch.as_tensor(images).to(run.device), conf, iou)

    return {"served": served}


def control_run(run) -> dict:
    """The check's numbers with the control in the program's place."""
    from portbench import compare, harness
    from portbench.drivers import train

    if run.cell["driver"] == "train":
        return compare.training(train.reference_readings(run, control=True),
                                train.reference_readings(run))
    run.hooks.update(control_hooks(run))
    harness.execute(run)
    return {k: v for k, (v, _) in run.checks.items()}


def half_batch(step):
    """The fault: half of the batch left out, the mean taken over the rest."""

    def wrapped(images, targets):
        n = images.shape[0] // 2
        return step(images[:n], targets[:n])

    return wrapped


FAULTS = {"half_batch": {"wrap_step": half_batch}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--sound", type=int, default=1)
    p.add_argument("--control", type=int, default=1)
    p.add_argument("--fault", choices=sorted(FAULTS))
    args = p.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness, systems

    if not torch.cuda.is_available():
        harness.log("portbench.control: needs a CUDA device")
        return 2
    cell = harness.read_json(harness.HERE / "workloads" / f"{args.workload}.json")
    config = harness.read_json(harness.HERE / "configs" / f"{cell['config']}.json")
    for seed in (int(s) for s in args.seeds.split(",")):
        sides = [("program", None)] if args.sound else []
        if args.fault:
            sides.append((args.fault, "fault"))
        elif args.control:
            sides.append(("control", "control"))
        for side, kind in sides:
            run = harness.Run(cell=cell, config=config, seed=seed, seconds=args.seconds,
                              trace=False, device=torch.device("cuda", 0),
                              t_process=time.perf_counter(),
                              hooks=dict(FAULTS[args.fault]) if kind == "fault" else {})
            t0 = time.perf_counter()
            if kind == "control":
                numbers = control_run(run)
            else:
                harness.execute(run)
                numbers = {k: v for k, (v, _) in run.checks.items()}
            for note in run.notes:
                harness.log(note)
            print(json.dumps({"seed": seed, "side": side, "numbers": numbers,
                              "seconds": time.perf_counter() - t0}), flush=True)
            del run
            systems.free_device()
    return 0


if __name__ == "__main__":
    sys.exit(main())
