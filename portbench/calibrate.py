"""The readings the limits of ``limits/<cell>.json`` are set from, on the
card at the cell's own size, in one process:

    python3 -m portbench.calibrate --workload <cell> --seeds 12 [--control 3] [--faults 3]

For each seed: the cell's inputs and weights, its checked units (a rollout
of each union; the three first train steps), the numbers compared against
the plain reference (the lower readings); on the first ``--control`` seeds
the control, the reference itself in the precision below the
configuration's (fp8 operands, flux and hop state under a bf16
configuration; TF32 operands under float32), compared with the float32
reference in the same way (the upper readings); and on the first
``--faults`` seeds each fault of the cell planted in the program
(``faults.py``). One JSON line a reading.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from portbench import faults, modes, run
from portbench.reference import inputs
from portbench.reference.model import Precision


def control_precision(cfg: dict) -> Precision:
    if cfg["model"]["compute_dtype"] == "bfloat16":
        return Precision("fp8", state=True)
    return Precision("tf32")


def reading(spec: dict, seed: int, device, fault=None, control=False) -> dict:
    cfg, traffic = spec["cfg"], spec["traffic"]
    mesh = inputs.make_mesh(cfg["grid"], seed)
    scenarios = inputs.make_scenarios(mesh, cfg["frames"], traffic["scenarios"], seed)
    with faults.planted(fault, traffic["mode"]):
        mode = modes.MODES[traffic["mode"]](cfg, spec["arch"], traffic, seed, device, mesh,
                                            scenarios)
        mode.warm()
        for i in range(len(getattr(mode, "graphs", ()))):
            mode.unit(i)
    mode.release()
    t0 = time.perf_counter()
    numbers = mode.control(control_precision(cfg)) if control else mode.check()
    return {"seed": seed, "fault": fault, "control": control, **numbers,
            "check_s": time.perf_counter() - t0}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, default=12)
    parser.add_argument("--first-seed", type=int, default=3_000_000_001)
    parser.add_argument("--control", type=int, default=3)
    parser.add_argument("--faults", type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("calibrate: no CUDA device")
    from mswe_gnn_tpu_torch import cache

    cache.enable_compilation_cache(str(cache.DEFAULT_DIR))
    spec = run.load_cell(args.workload)
    device = torch.device("cuda", 0)
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    jobs = [(s, None, False) for s in seeds]
    jobs += [(s, None, True) for s in seeds[:args.control]]
    jobs += [(s, f, False) for f in faults.FAULTS[spec["traffic"]["mode"]]
             for s in seeds[:args.faults]]
    for seed, fault, control in jobs:
        print(json.dumps({"workload": args.workload,
                          **reading(spec, seed, device, fault, control)}), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
