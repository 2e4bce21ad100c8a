"""The McWilliams recipe end to end on the card, for its accuracy.

Run from the root of a checkout on one card:
``python3 -m tpu_cfd_torch.train.recipe_accuracy --data-dir <dir>``.

1. generates the McWilliams dataset at the recipe's defaults with the
   dataset CLI (256² solve, subsampled to 64², 1,152 samples, viscosity
   1e-3, T = 10 of which 4.5 warm-up, dt 1e-3, 100 records; batch 32):
   1.15e7 sample-steps. The CLI resumes from its part files, so a second run
   on the same ``--data-dir`` continues where one stopped;
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
   stage 2 on it with the adopted McWilliams recipe
   (``ex2_sfno_finetune --example McWilliams2d --gt-floor --lr-decay 0.05
   --iters 160``), reporting the zero-shot rel-L2, the GT floor (the exact
   trajectory's residual under the same norm), the residual at iteration 0,
   the best within 100 iterations with its index, the last, and each
   iteration's wall time (the JAX package's: 1.783e-1, 5.477e-6, 5.781e-6,
   5.251e-6 at iteration 76; ``logs/finetune_mc_r4.log``).

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

GENERATE = ["--grid-size", "256", "--subsample", "4", "--num-samples", "1152",
            "--batch-size", "32", "--visc", "1e-3", "--time", "10",
            "--time-warmup", "4.5", "--dt", "1e-3", "--num-steps", "100"]
# the arguments of logs/train_mc_r4.log, the JAX run behind 3.10e-2
# (tests/test_torch_train.py holds them against that log)
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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--data-dir", required=True,
                        help="where the dataset's parts are written and resumed")
    args = parser.parse_args(argv)
    # the training CLIs read a relative data path as relative to their DATA_PATH
    args.data_dir = os.path.abspath(args.data_dir)
    if not torch.cuda.is_available():
        print("recipe_accuracy: no CUDA device is available", file=sys.stderr)
        return 1
    os.makedirs(args.data_dir, exist_ok=True)
    # the training CLIs read their output paths when they are imported
    for var in ("MODEL_PATH", "LOG_PATH", "FIG_PATH"):
        os.environ.setdefault(var, os.path.join(args.data_dir, var.lower()))
    from tpu_cfd_torch.data import generate
    from tpu_cfd_torch.examples import ex2_sfno_finetune
    from tpu_cfd_torch.train import finetune, train, train_fno3d

    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip()
    out = {"card": card}
    t0 = time.perf_counter()
    path = generate.main_mcwilliams(GENERATE + ["--filepath", args.data_dir])
    torch.cuda.synchronize()
    out["generate_s"] = time.perf_counter() - t0
    with open(path + ".meta.json") as f:
        out["fft_impl"] = json.load(f)["fft_impl"]
    print(f"recipe_accuracy: dataset {path} in {out['generate_s']:.1f} s", flush=True)

    t0 = time.perf_counter()
    run = train.main(TRAIN + ["--train-file", path])
    out["sfno_s"] = time.perf_counter() - t0
    out["sfno_history"] = run["history"]
    out["sfno_val_rel_l2"] = run["history"][-1]["val"]
    out["sfno_n_params"] = run["n_params"]
    print(f"recipe_accuracy: SFNO val rel-L2 {out['sfno_val_rel_l2']:.4e} after 15 "
          f"epochs ({out['sfno_s']:.1f} s)", flush=True)

    t0 = time.perf_counter()
    fno = train_fno3d.main(FNO3D + ["--data-file", path])
    out["fno3d_s"] = time.perf_counter() - t0
    out["fno3d_history"] = fno["history"]
    out["fno3d_test_rel_l2"] = fno["history"][-1]["test"]
    print(f"recipe_accuracy: FNO3d test rel-L2 {out['fno3d_test_rel_l2']:.4e} after 10 "
          f"epochs ({out['fno3d_s']:.1f} s)", flush=True)

    t0 = time.perf_counter()
    ft_path = generate.main_mcwilliams(FT_DATA + ["--filepath", args.data_dir])
    torch.cuda.synchronize()
    out["ft_generate_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ft = ex2_sfno_finetune.main(FINETUNE + ["--test-file", ft_path, "--ckpt", run["checkpoint"]])
    out["ft_s"] = time.perf_counter() - t0
    hist = [h["residual"] for h in ft["history"]]
    best_i, best = finetune.best_of(ft["history"][: FT_BUDGET + 1])
    out["finetune"] = {
        "zero_shot_rel_l2": ft["zero_shot_rel_l2"], "gt_floor": ft["gt_floor"],
        "iter0": hist[0], f"best_within_{FT_BUDGET}": best,
        f"best_iter_within_{FT_BUDGET}": best_i, "last": hist[-1],
        "best_over_gt_floor": best / ft["gt_floor"], "history": ft["history"],
        "iter_seconds": ft["iter_seconds"]}
    print(f"recipe_accuracy: fine-tune GT floor {ft['gt_floor']:.4e}, iter 0 "
          f"{hist[0]:.4e}, best within {FT_BUDGET} {best:.4e} at iter {best_i} "
          f"({best / ft['gt_floor']:.3f} of the floor), zero-shot rel-L2 "
          f"{ft['zero_shot_rel_l2']:.4e} ({out['ft_generate_s']:.1f} s of fp64 "
          f"generation, {out['ft_s']:.1f} s of fine-tune)", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
