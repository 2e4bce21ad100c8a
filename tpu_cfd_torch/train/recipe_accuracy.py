"""The McWilliams and FNO recipes end to end on the card, for their accuracy.

Run from the root of a checkout on one card:
``python3 -m tpu_cfd_torch.train.recipe_accuracy --data-dir <dir>
[--stages mcwilliams fno]`` (both by default).

Each stage keeps its record in ``<dir>/recipe_<stage>.json``, and a second
run on the same ``--data-dir`` reads a finished stage's record back instead
of running it again; the dataset CLIs also resume from their part files, so
a run that stopped inside a dataset continues where it stopped.

``mcwilliams``:

1. generates the McWilliams dataset at the recipe's defaults with the
   dataset CLI (256² solve, subsampled to 64², 1,152 samples, viscosity
   1e-3, T = 10 of which 4.5 warm-up, dt 1e-3, 100 records; batch 32):
   1.15e7 sample-steps;
2. trains the SFNO with the arguments of the JAX run it is compared with
   (``logs/train_mc_r4.log``, line 1: width 10, modes 32/5, 4 layers,
   10 -> 10 steps, GELU, batch 4, 128 validation samples, lr 1e-2, seed
   1127825, norm order 0) for 15 epochs on it with the training CLI, and
   reports the validation rel-L2 (the JAX package's: 3.10e-2, README.md);
3. trains the FNO3d baseline at the defaults of
   ``examples/ex2_fno3d_train.py`` (modes 32/5, width 10, batch 4, lr 1e-3,
   seed 42) for 10 epochs on its first 1,024 samples and reports the test
   rel-L2 on the next 32 (the JAX package's: 9.67e-2);
4. generates the fp64 256² McWilliams test set with the arguments of the
   JAX run it is compared with (``logs/datagen_fp64_mc_r4.log``, line 1:
   16 samples in batches of 8, T = 10 of which 4.5 warm-up, dt 1e-3, 100
   records, peak wavenumber 4, maximum velocity 5, seed 1127802; the
   realization differs, as the noise streams do) and fine-tunes the SFNO of
   step 2 on it with the adopted McWilliams recipe
   (``ex2_sfno_finetune --example McWilliams2d --gt-floor --lr-decay 0.05
   --iters 160``), reporting the zero-shot rel-L2, the GT floor (the exact
   trajectory's residual under the same norm), the residual at iteration 0,
   the best within 100 iterations with its index, the last, and each
   iteration's wall time (the JAX package's: 1.783e-1, 5.477e-6, 5.781e-6,
   5.251e-6 at iteration 76; ``logs/finetune_mc_r4.log``).

``fno``, each step with the arguments of the JAX run it is compared with:

1. generates the FNO dataset (``scripts/r4_measure2.sh``: 256² solve,
   subsampled to 64², 1,280 samples in batches of 64, with the extra
   variables, 100 records; the CLI's defaults otherwise: T = 50 of which 30
   warm-up, dt 1e-3, IMEX order 2, sincos forcing): 6.4e7 sample-steps;
2. trains the SFNO (``logs/train_fno_ref_r4.log``, line 1: width 20, modes
   12/5, 4 layers, 10 -> 40 steps, beta 0.02, GELU, batch 4, lr 1e-2, seed
   1127825, 1,152 train and 128 validation samples, norm order 0) for 10
   epochs and reports the validation rel-L2 (the JAX package's: 9.5572e-3);
3. generates the fp64 256² FNO test set (``logs/datagen_fp64_fno_r4.log``,
   line 1: 4 samples in one batch, T = 50 of which 30 warm-up, dt 1e-3, 100
   records, the extra variables, seed 1127802);
4. evaluates the SFNO of step 2 zero-shot at 256² in fp64 on it
   (``train --eval-only --double``, ``scripts/r4_measure5.sh``; the JAX
   package's: 7.2495e-3, ``logs/eval_fno_256_r4.log``);
5. fine-tunes that SFNO on it with the adopted FNO-data recipe
   (``ex2_sfno_finetune --example fno --iters 80 --lr-decay 0.05
   --gt-floor``, ``scripts/r4_measure5.sh``), reporting the zero-shot
   rel-L2, the GT floor, iteration 0, the best within 50 iterations with its
   index, the best over 80 with its index, and each iteration's wall time
   (the JAX package's: 6.053e-2, 2.287e-6, 2.076e-6, 2.027e-6 at 40,
   1.814e-6 at 72; ``logs/finetune_fno_r4.log``).

Prints one JSON line with the card's name and power limit, each stage's wall
time and the per-epoch histories.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

STAGES = ("mcwilliams", "fno")
GENERATE = ["--grid-size", "256", "--subsample", "4", "--num-samples", "1152",
            "--batch-size", "32", "--visc", "1e-3", "--time", "10",
            "--time-warmup", "4.5", "--dt", "1e-3", "--num-steps", "100"]
# the arguments of logs/train_mc_r4.log, the JAX run behind 3.10e-2
# (tests/test_torch_train.py holds each list here against its JAX source)
TRAIN = ["--example", "McWilliams2d", "--epochs", "15", "--num-samples", "1152",
         "--num-val-samples", "128", "--batch-size", "4", "--lr", "1e-2",
         "--seed", "1127825", "--norm-order", "0", "--width", "10",
         "--modes", "32", "--modes-t", "5", "--num-layers", "4", "--time-steps", "10",
         "--out-time-steps", "10", "--activation", "GELU", "--train-only"]
# the arguments of logs/datagen_fp64_mc_r4.log and of the adopted McWilliams
# fine-tune recipe (RESULTS.md), the JAX runs behind 5.251e-6
FT_DATA = ["--grid-size", "256", "--subsample", "1", "--double", "--num-samples", "16",
           "--batch-size", "8", "--visc", "1e-3", "--time", "10", "--time-warmup", "4.5",
           "--dt", "1e-3", "--num-steps", "100", "--peak-wavenumber", "4",
           "--max-velocity", "5", "--seed", "1127802"]
FINETUNE = ["--example", "McWilliams2d", "--gt-floor", "--lr-decay", "0.05",
            "--iters", "160"]
FT_BUDGET = 100  # the notebook's iteration budget the best is reported within
# the defaults of examples/ex2_fno3d_train.py, the JAX run behind 9.67e-2
FNO3D = ["--num-samples", "1024", "--num-test-samples", "32", "--epochs", "10",
         "--batch-size", "4", "--lr", "1e-3", "--modes", "32", "--modes-t", "5",
         "--width", "10", "--time-steps", "10", "--t-start", "10", "--res", "64",
         "--seed", "42"]
# the FNO dataset of scripts/r4_measure2.sh, the data behind 9.5572e-3
FNO_GENERATE = ["--grid-size", "256", "--subsample", "4", "--num-samples", "1280",
                "--batch-size", "64", "--extra-vars", "--num-steps", "100"]
# the arguments of logs/train_fno_ref_r4.log, the JAX run behind 9.5572e-3
FNO_TRAIN = ["--example", "fno", "--epochs", "10", "--num-samples", "1152",
             "--num-val-samples", "128", "--batch-size", "4", "--lr", "1e-2",
             "--seed", "1127825", "--norm-order", "0", "--width", "20", "--modes", "12",
             "--modes-t", "5", "--num-layers", "4", "--time-steps", "10",
             "--out-time-steps", "40", "--beta", "0.02", "--activation", "GELU",
             "--train-only"]
# the arguments of logs/datagen_fp64_fno_r4.log, the FNO test set
FNO_FT_DATA = ["--grid-size", "256", "--subsample", "1", "--double", "--num-samples", "4",
               "--batch-size", "4", "--visc", "1e-3", "--time", "50", "--time-warmup", "30",
               "--dt", "1e-3", "--num-steps", "100", "--extra-vars", "--seed", "1127802"]
# the 256^2 zero-shot eval and the adopted FNO-data fine-tune of
# scripts/r4_measure5.sh, the JAX runs behind 7.2495e-3 and 2.027e-6
FNO_EVAL = ["--example", "fno", "--eval-only", "--double", "--num-test-samples", "4",
            "--width", "20", "--modes", "12", "--modes-t", "5", "--out-time-steps", "40",
            "--beta", "0.02"]
FNO_FINETUNE = ["--example", "fno", "--iters", "80", "--lr-decay", "0.05", "--gt-floor"]
FNO_FT_BUDGET = 50  # the iteration budget the FNO-data best is reported within


def override(argv, values: dict) -> list:
    """``argv`` with the value after each flag of ``values`` replaced (the
    flag appended where ``argv`` lacks it): a stage's arguments with its
    depth cut, as ``chip_smoke.py`` and the tests run them."""
    argv = list(argv)
    for flag, value in values.items():
        if flag in argv:
            argv[argv.index(flag) + 1] = value
        else:
            argv += [flag, value]
    return argv


def get_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--data-dir", required=True,
                        help="where the datasets, checkpoints and stage records are "
                             "written and resumed")
    parser.add_argument("--stages", nargs="+", choices=STAGES, default=list(STAGES),
                        help="the recipes to run (default: both)")
    return parser


def _stage(data_dir: str, name: str, fn) -> dict:
    """``fn()``'s record, kept as ``<data_dir>/recipe_<name>.json``: where
    that file exists, the stage ran to its end before and is read back."""
    path = os.path.join(data_dir, f"recipe_{name}.json")
    if os.path.exists(path):
        with open(path) as f:
            record = json.load(f)
        print(f"recipe_accuracy: {name} read back from {path}", flush=True)
        return record
    t0 = time.perf_counter()
    record = fn()  # host values (paths, histories, floats): the work is done
    record["seconds"] = time.perf_counter() - t0
    with open(path, "w") as f:
        json.dump(record, f)
    return record


def _finetune_record(ft: dict, budget: int) -> dict:
    """The fine-tune's numbers: the zero-shot rel-L2, the GT floor, iteration
    0, the best within ``budget`` iterations and over the run, each with its
    index, the last, and each iteration's wall time."""
    from tpu_cfd_torch.train import finetune

    hist = [h["residual"] for h in ft["history"]]
    best_i, best = finetune.best_of(ft["history"][: budget + 1])
    all_i, best_all = finetune.best_of(ft["history"])
    return {"zero_shot_rel_l2": ft["zero_shot_rel_l2"], "gt_floor": ft["gt_floor"],
            "iter0": hist[0], f"best_within_{budget}": best,
            f"best_iter_within_{budget}": best_i, "best": best_all, "best_iter": all_i,
            "last": hist[-1], "best_over_gt_floor": best / ft["gt_floor"],
            "history": ft["history"], "iter_seconds": ft["iter_seconds"]}


def _print_finetune(tag: str, r: dict, budget: int, seconds: float) -> None:
    best, best_i = r[f"best_within_{budget}"], r[f"best_iter_within_{budget}"]
    print(f"recipe_accuracy: {tag} fine-tune GT floor {r['gt_floor']:.4e}, iter 0 "
          f"{r['iter0']:.4e}, best within {budget} {best:.4e} at iter {best_i} "
          f"({best / r['gt_floor']:.3f} of the floor), best {r['best']:.4e} at iter "
          f"{r['best_iter']}, zero-shot rel-L2 {r['zero_shot_rel_l2']:.4e} "
          f"({seconds:.1f} s)", flush=True)


def mcwilliams(data_dir: str) -> dict:
    """The McWilliams stages (module docstring); returns their records."""
    from tpu_cfd_torch.data import generate
    from tpu_cfd_torch.examples import ex2_sfno_finetune
    from tpu_cfd_torch.train import train, train_fno3d

    def dataset():
        path = generate.main_mcwilliams(GENERATE + ["--filepath", data_dir])
        with open(path + ".meta.json") as f:
            return {"path": path, "fft_impl": json.load(f)["fft_impl"]}

    data = _stage(data_dir, "mcwilliams_dataset", dataset)
    print(f"recipe_accuracy: dataset {data['path']} in {data['seconds']:.1f} s", flush=True)

    def sfno():
        run = train.main(TRAIN + ["--train-file", data["path"]])
        return {"history": run["history"], "val_rel_l2": run["history"][-1]["val"],
                "n_params": run["n_params"], "checkpoint": run["checkpoint"]}

    sfno_r = _stage(data_dir, "mcwilliams_sfno", sfno)
    print(f"recipe_accuracy: SFNO val rel-L2 {sfno_r['val_rel_l2']:.4e} after 15 "
          f"epochs ({sfno_r['seconds']:.1f} s)", flush=True)

    def fno3d():
        fno = train_fno3d.main(FNO3D + ["--data-file", data["path"]])
        return {"history": fno["history"], "test_rel_l2": fno["history"][-1]["test"]}

    fno3d_r = _stage(data_dir, "mcwilliams_fno3d", fno3d)
    print(f"recipe_accuracy: FNO3d test rel-L2 {fno3d_r['test_rel_l2']:.4e} after 10 "
          f"epochs ({fno3d_r['seconds']:.1f} s)", flush=True)

    ft_data = _stage(data_dir, "mcwilliams_fp64_test_set", lambda: {
        "path": generate.main_mcwilliams(FT_DATA + ["--filepath", data_dir])})
    ft = _stage(data_dir, "mcwilliams_finetune", lambda: _finetune_record(
        ex2_sfno_finetune.main(FINETUNE + ["--test-file", ft_data["path"],
                                           "--ckpt", sfno_r["checkpoint"]]), FT_BUDGET))
    _print_finetune("McWilliams", ft, FT_BUDGET, ft["seconds"])
    return {"dataset": data, "sfno": sfno_r, "fno3d": fno3d_r, "fp64_test_set": ft_data,
            "finetune": ft}


def fno(data_dir: str) -> dict:
    """The FNO stages (module docstring); returns their records."""
    from tpu_cfd_torch.data import generate
    from tpu_cfd_torch.examples import ex2_sfno_finetune
    from tpu_cfd_torch.train import train

    def dataset():
        path = generate.main_fno(FNO_GENERATE + ["--filepath", data_dir])
        with open(path + ".meta.json") as f:
            return {"path": path, "fft_impl": json.load(f)["fft_impl"]}

    data = _stage(data_dir, "fno_dataset", dataset)
    print(f"recipe_accuracy: FNO dataset {data['path']} in {data['seconds']:.1f} s",
          flush=True)

    def sfno():
        run = train.main(FNO_TRAIN + ["--train-file", data["path"]])
        return {"history": run["history"], "val_rel_l2": run["history"][-1]["val"],
                "n_params": run["n_params"], "checkpoint": run["checkpoint"]}

    sfno_r = _stage(data_dir, "fno_sfno", sfno)
    print(f"recipe_accuracy: FNO-data SFNO val rel-L2 {sfno_r['val_rel_l2']:.4e} after "
          f"{len(sfno_r['history'])} epochs ({sfno_r['seconds']:.1f} s)", flush=True)

    ft_data = _stage(data_dir, "fno_fp64_test_set", lambda: {
        "path": generate.main_fno(FNO_FT_DATA + ["--filepath", data_dir])})
    print(f"recipe_accuracy: FNO fp64 test set {ft_data['path']} in "
          f"{ft_data['seconds']:.1f} s", flush=True)

    def evaluate():
        # the eval loads the best checkpoint that step 2 wrote under MODEL_PATH
        run = train.main(FNO_EVAL + ["--train-file", data["path"],
                                     "--test-file", ft_data["path"]])
        return {"test_rel_l2_256": run["test"]}

    eval_r = _stage(data_dir, "fno_eval_256", evaluate)
    print(f"recipe_accuracy: FNO-data SFNO zero-shot eval in fp64, rel Sobolev "
          f"{eval_r['test_rel_l2_256']:.4e} ({eval_r['seconds']:.1f} s)", flush=True)
    ft = _stage(data_dir, "fno_finetune", lambda: _finetune_record(
        ex2_sfno_finetune.main(FNO_FINETUNE + ["--test-file", ft_data["path"],
                                               "--ckpt", sfno_r["checkpoint"]]),
        FNO_FT_BUDGET))
    _print_finetune("FNO-data", ft, FNO_FT_BUDGET, ft["seconds"])
    return {"dataset": data, "sfno": sfno_r, "fp64_test_set": ft_data, "eval_256": eval_r,
            "finetune": ft}


def main(argv=None) -> int:
    args = get_parser().parse_args(argv)
    # the training CLIs read a relative data path as relative to their DATA_PATH
    args.data_dir = os.path.abspath(args.data_dir)
    if not torch.cuda.is_available():
        print("recipe_accuracy: no CUDA device is available", file=sys.stderr)
        return 1
    os.makedirs(args.data_dir, exist_ok=True)
    # the training CLIs read their output paths when they are imported
    for var in ("MODEL_PATH", "LOG_PATH", "FIG_PATH"):
        os.environ.setdefault(var, os.path.join(args.data_dir, var.lower()))
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip()
    print(f"recipe_accuracy: {card}; stages {args.stages}", flush=True)
    runs = {"mcwilliams": mcwilliams, "fno": fno}
    out = {"card": card, **{name: runs[name](args.data_dir) for name in args.stages}}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
