"""Visualization and physics diagnostics: contours and enstrophy spectra.

Counterpart of ``tpu_cfd/utils/visualizations.py`` (the reference's
``fno/visualizations.py``: plot_contour :14, get_enstrophy_spectrum
:114-138, plot_enstrophy_spectrum :141-191, plot_contour_trajectory
:193-252). The spectrum is numpy only; the plot functions import matplotlib
inside their bodies, so that the rest runs where matplotlib is missing.
``save_figure`` writes a figure, or says in one line that it could not.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np


def get_enstrophy_spectrum(vorticity: np.ndarray, h: float) -> np.ndarray:
    """Shell-averaged enstrophy spectrum, normalized to sum 1.

    vorticity: (n, n) physical-space field; h: grid spacing.
    Returns E(k) for k = 1..n//2-1 (the reference's binning).
    """
    vorticity = np.asarray(vorticity)
    n = vorticity.shape[0]
    kx = np.fft.fftfreq(n, d=h)
    ky = np.fft.fftfreq(n, d=h)
    kx, ky = np.meshgrid(kx, ky, indexing="ij")
    kmax = n // 2
    kx = kx[..., : kmax + 1]
    ky = ky[..., : kmax + 1]
    k2 = (4 * np.pi**2) * (kx**2 + ky**2)
    k2[0, 0] = 1.0

    wh = np.fft.rfft2(vorticity)
    tke = (0.5 * wh * wh.conj()).real
    kmod = np.sqrt(k2)

    k = np.arange(1, kmax, dtype=np.float64)
    dk = (k.max() - k.min()) / (2 * n)
    # the shells [k - dk, k + dk) of the reference's loop, by two searches
    idx_hi = np.searchsorted(k, kmod.ravel() - dk, side="right")
    idx_lo = np.searchsorted(k, kmod.ravel() + dk, side="left")
    ens = np.zeros(len(k))
    flat = tke.ravel()
    in_shell = idx_lo > idx_hi
    np.add.at(ens, idx_hi[in_shell].clip(0, len(k) - 1), flat[in_shell])
    s = ens.sum()
    return ens / s if s > 0 else ens


def save_figure(plot: Callable, path: str, **savefig_kwargs) -> Optional[str]:
    """Calls ``plot()`` (which returns ``(fig, axes)``) and saves the figure
    to ``path``. Where matplotlib is not installed, prints one line saying
    that no figure was written and returns None; any other error raises."""
    try:
        import matplotlib.pyplot as plt
    except ModuleNotFoundError as e:
        if (e.name or "").split(".")[0] != "matplotlib":
            raise
        print(f"no figure written to {path}: matplotlib is not installed")
        return None
    fig, _ = plot()
    try:
        fig.savefig(path, **savefig_kwargs)
    finally:
        plt.close(fig)
    return path


def plot_contour(field, ax=None, cmap="RdBu_r", **kwargs):
    """Simple filled contour of a 2-D field."""
    import matplotlib.pyplot as plt

    field = np.asarray(field)
    if ax is None:
        _, ax = plt.subplots(figsize=(4, 4), dpi=100)
    im = ax.imshow(field, cmap=cmap, **kwargs)
    ax.axis("off")
    return im


def plot_enstrophy_spectrum(
    fields: Sequence[np.ndarray],
    h: Optional[float] = None,
    slope: float = 5,
    factor: Optional[float] = None,
    cutoff: float = 1e-15,
    plot_cutoff_factor: float = 1 / 8,
    labels: Optional[List[str]] = None,
    title: Optional[str] = None,
    legend_loc: str = "upper right",
    fontsize: int = 15,
    subplot_kw=None,
):
    """Log-log spectra with a k^(-slope) guide line."""
    import matplotlib.pyplot as plt

    fields = [np.asarray(f) for f in fields]
    if labels is None:
        labels = [f"Field {i}" for i in range(len(fields))]
    n = fields[0].shape[0]
    h = 1 / n if h is None else h
    kmax = n // 2
    k = np.arange(1, kmax, dtype=np.float64)
    spectra = [get_enstrophy_spectrum(f, h) for f in fields]
    if factor is None:
        factor = np.quantile(spectra[-1], 0.8) / (k[-1] ** (-slope))

    subplot_kw = subplot_kw or {"figsize": (5, 5), "dpi": 100, "facecolor": "w"}
    fig, ax = plt.subplots(**subplot_kw)
    plot_cutoff = int(n * plot_cutoff_factor)
    for label, E in zip(labels, spectra):
        E = E.copy()
        if cutoff is not None:
            E[E < cutoff] = np.nan
        if plot_cutoff > 0:
            E[-plot_cutoff:] = np.nan
        ax.loglog(k, E, label=label)
    guide = factor * k ** (-slope)
    ax.loglog(k[:-plot_cutoff or None], guide[:-plot_cutoff or None], "b--",
              label=f"$O(k^{{{-slope:.3g}}})$")
    ax.grid(True, which="both", ls="--", linewidth=0.4)
    ax.autoscale(enable=True, axis="x", tight=True)
    ax.legend(fontsize=fontsize, loc=legend_loc)
    ax.set_title(title, fontsize=fontsize)
    ax.set_xlabel("Wavenumber", fontsize=fontsize)
    return fig, ax


def plot_contour_trajectory(
    field: np.ndarray,
    num_snapshots: int = 5,
    cmap: str = "RdBu_r",
    titles: Optional[List[str]] = None,
):
    """Facet plot of ``num_snapshots`` frames of a (t, n, n) trajectory."""
    import matplotlib.pyplot as plt

    field = np.asarray(field)
    nt = field.shape[0]
    idx = np.linspace(0, nt - 1, num_snapshots).astype(int)
    fig, axes = plt.subplots(
        1, num_snapshots, figsize=(2.2 * num_snapshots, 2.2), dpi=100
    )
    for j, (ax, t) in enumerate(zip(np.atleast_1d(axes), idx)):
        plot_contour(field[t], ax=ax, cmap=cmap)
        ax.set_title(titles[j] if titles else f"t={t}", fontsize=9)
    fig.tight_layout()
    return fig, axes


def plot_contour_plotly(field, colorscale: str = "RdBu", **layout_kwargs):
    """Interactive contour through plotly, an optional dependency: raises
    ImportError naming the matplotlib alternative when it is missing."""
    try:
        import plotly.graph_objects as go
    except ImportError as e:
        raise ImportError(
            "plotly is not installed; use plot_contour (matplotlib) instead"
        ) from e
    fig = go.Figure(data=go.Contour(z=np.asarray(field), colorscale=colorscale))
    if layout_kwargs:
        fig.update_layout(**layout_kwargs)
    return fig
