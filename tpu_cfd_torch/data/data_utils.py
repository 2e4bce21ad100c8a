"""Shared data-generation CLI, logging, and incremental IO (port's own copy).

Counterpart of ``tpu_cfd/data/data_utils.py``, kept as a copy so that the
port imports nothing of the JAX package. The npz part/meta format is the
same, so ``tpu_cfd.data.datasets.load_trajectory_dict`` reads the port's
datasets:

  - ``--diam`` and ``--forcing`` are typed values (float / named enum);
  - incremental output is per-batch ``.npz`` part files merged into one
    final ``.npz``; resume detection counts samples in existing parts, and
    per-sample seeds derive from ``(seed, sample_index)``, so regeneration
    continues exactly where it stopped.
"""

from __future__ import annotations

import argparse
import logging
import math
import os
import sys
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

DATA_PATH = os.environ.get("DATA_PATH", os.path.join(os.getcwd(), "data"))
LOG_PATH = os.environ.get("LOG_PATH", os.path.join(os.getcwd(), "logs"))


def get_logger(log_filename: Optional[str] = None, name: str = "tpu_cfd_torch.datagen"):
    """File + stream logger (counterpart of data_utils.py:22-46)."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    logger.propagate = False  # avoid duplicate lines via the root logger
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)s - %(levelname)s - %(message)s")
    stream = logging.StreamHandler(sys.stdout)
    stream.setFormatter(fmt)
    logger.addHandler(stream)
    if log_filename is not None:
        os.makedirs(os.path.dirname(log_filename) or ".", exist_ok=True)
        fh = logging.FileHandler(log_filename)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


_DIAM_CONSTANTS = {"pi": math.pi, "2pi": 2 * math.pi, "2*pi": 2 * math.pi}


def parse_diam(value) -> float:
    """Accepts a float or the named constants 'pi' / '2pi' (no eval)."""
    if isinstance(value, (int, float)):
        return float(value)
    v = str(value).strip().lower().replace(" ", "")
    if v in _DIAM_CONSTANTS:
        return _DIAM_CONSTANTS[v]
    return float(v)


def get_args_ns2d(desc: str = "NSE 2D data generation") -> argparse.ArgumentParser:
    """The data-gen flag set (reference data_utils.py:49-284, typed)."""
    p = argparse.ArgumentParser(description=desc)
    p.add_argument("--example", type=str, default=None, help="data name")
    p.add_argument("--grid-size", type=int, default=256, help="grid size n of the n x n domain")
    p.add_argument("--boundary", type=str, default="periodic",
                   help="boundary type: periodic, dirichlet, neumann")
    p.add_argument("--subsample", type=int, default=1, help="spatial subsample factor")
    p.add_argument("--diam", type=parse_diam, default=1.0,
                   help="domain is (0,d)x(0,d); accepts a float or 'pi'/'2pi'")
    p.add_argument("--scale", type=float, default=1.0, help="forcing amplitude")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--num-samples", type=int, default=1200)
    p.add_argument("--visc", type=float, default=1e-3, help="viscosity (1/Re)")
    p.add_argument("--Re", type=float, default=None, help="Reynolds number; overrides --visc")
    p.add_argument("--time", type=float, default=20.0, help="total simulated time")
    p.add_argument("--time-warmup", type=float, default=4.5, help="warmup time (not recorded)")
    p.add_argument("--dt", type=float, default=1e-4, help="solver time step")
    p.add_argument("--num-steps", type=int, default=50, help="number of recorded snapshots")
    p.add_argument("--normalize", action="store_true", default=False,
                   help="normalize the GRF initial condition to unit L2 norm")
    p.add_argument("--double", action="store_true", default=False,
                   help="save data (and solve on CPU) in float64")
    p.add_argument("--alpha", type=float, default=2.5, help="GRF smoothness")
    p.add_argument("--tau", type=float, default=7.0, help="GRF covariance regularizer")
    p.add_argument("--epsilon", type=float, default=1e-2, help="elliptic singular coefficient")
    p.add_argument("--gamma", type=float, default=0.0, help="drag coefficient")
    p.add_argument("--forcing", type=str, default="sincos",
                   help="forcing name: none | sincos | kolmogorov")
    p.add_argument("--peak-wavenumber", type=int, default=4)
    p.add_argument("--max-velocity", type=float, default=5.0)
    p.add_argument("--filepath", type=str, default=None, help="output directory")
    p.add_argument("--logpath", type=str, default=None, help="log directory")
    p.add_argument("--filename", type=str, default=None, help="output file name")
    p.add_argument("--no-cuda", action="store_true", default=False,
                   help="run on the CPU (without it the run needs a CUDA card)")
    p.add_argument("--extra-vars", action="store_true", default=False,
                   help="store stream/vort_t/residual in addition to vorticity")
    p.add_argument("--force-rerun", action="store_true", default=False)
    p.add_argument("--max-steps-per-program", type=int, default=2000,
                   help="solver steps per recorded chunk (bounds the records "
                        "held on the device before they are copied out)")
    p.add_argument("--replicable-init", action="store_true", default=False,
                   help="sample the GRF at the reference 2048^2 mesh then downsample")
    p.add_argument("--no-dealias", action="store_true", default=False)
    p.add_argument("--no-tqdm", action="store_true", default=False)
    p.add_argument("--demo-plots", action="store_true", default=False)
    p.add_argument("--seed", type=int, default=1127802, help="base RNG seed")
    p.add_argument("--data-parallel", action="store_true", default=False,
                   help="shard each batch over several devices (not ported)")
    p.add_argument("--fft-impl", type=str, default=None,
                   choices=["fft", "dft", "dft_aligned", "dft_galerkin",
                            "dft_aligned_fused", "dft_galerkin_fused"],
                   help="solver transform implementation; the default is "
                        "dft_galerkin_fused (the hand-written CUDA RK4-CN "
                        "rollout on the 2/3-rule block) where the kernel "
                        "can step the run, else fft (torch.fft): --double, "
                        "--no-dealias, another integrator or a grid size "
                        "that is not a power of two from 16 to 2048")
    p.add_argument("--mxu-precision", type=str, default="high",
                   choices=["highest", "high", "default"],
                   help="precision of the dense-DFT paths, named as in the "
                        "JAX package; every mode computes in fp32 here")
    return p


def parts_dir(data_filepath: os.PathLike) -> Path:
    return Path(str(data_filepath) + ".parts")


def count_existing_samples(data_filepath: os.PathLike, field: str = "vorticity") -> int:
    """Counts samples already generated (final file or part files)."""
    path = Path(data_filepath)
    total = 0
    if path.exists():
        with np.load(path) as z:
            if field in z.files:
                total += z[field].shape[0]
    pdir = parts_dir(path)
    if pdir.exists():
        for part in sorted(pdir.glob("part*.npz")):
            with np.load(part) as z:
                total += z[field].shape[0]
    return total


def save_part(result: Dict[str, np.ndarray], data_filepath: os.PathLike) -> Path:
    """Appends one batch as a part file (resume-safe incremental output)."""
    pdir = parts_dir(data_filepath)
    pdir.mkdir(parents=True, exist_ok=True)
    idx = len(list(pdir.glob("part*.npz")))
    out = pdir / f"part{idx:05d}.npz"
    np.savez(out, **{k: np.asarray(v) for k, v in result.items()})
    return out


def merge_parts(data_filepath: os.PathLike, cleanup: bool = True) -> Path:
    """Merges part files into the final .npz (counterpart of pickle_to_pt)."""
    path = Path(data_filepath)
    pdir = parts_dir(path)
    parts = sorted(pdir.glob("part*.npz"))
    if not parts:
        raise FileNotFoundError(f"no part files found in {pdir}")
    merged: Dict[str, List[np.ndarray]] = {}
    # a pre-existing final file holds previously generated samples (resume):
    # fold it in first so merging never loses them
    if path.exists():
        with np.load(path) as z:
            for k in z.files:
                merged.setdefault(k, []).append(z[k])
    for part in parts:
        with np.load(part) as z:
            for k in z.files:
                merged.setdefault(k, []).append(z[k])
    final = {
        k: (np.concatenate(v, axis=0) if v[0].ndim > 0 else np.stack(v))
        for k, v in merged.items()
    }
    # write-then-rename: the final path only ever appears fully formed, so
    # a concurrent reader (e.g. a training job waiting on the dataset) never
    # sees a truncated zip
    tmp = path.with_name(path.name + ".tmp.npz")
    np.savez(tmp, **final)
    os.replace(tmp, path)
    if cleanup:
        for part in parts:
            part.unlink()
        pdir.rmdir()
    return path


def verify_trajectories(
    data_filepath: os.PathLike,
    dt: float = 1.0,
    T_warmup: float = 0.0,
    n_samples: int = 1,
    save_dir: Optional[str] = None,
):
    """Plots a few stored trajectories (counterpart of data_utils.py:347)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    with np.load(data_filepath) as z:
        w = z["vorticity"]
    n_show = min(8, w.shape[1])
    fig, axes = plt.subplots(
        n_samples, n_show, figsize=(2 * n_show, 2 * n_samples), squeeze=False
    )
    for i in range(n_samples):
        for j, t in enumerate(
            np.linspace(0, w.shape[1] - 1, n_show).astype(int)
        ):
            axes[i][j].imshow(w[i, t], cmap="RdBu_r")
            axes[i][j].set_title(f"t={T_warmup + t * dt:.1f}", fontsize=8)
            axes[i][j].axis("off")
    fig.tight_layout()
    out = Path(save_dir or os.path.dirname(data_filepath) or ".") / (
        Path(data_filepath).stem + "_verify.png"
    )
    fig.savefig(out, dpi=100)
    plt.close(fig)
    return out
