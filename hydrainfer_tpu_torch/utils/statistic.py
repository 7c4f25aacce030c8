"""Attention and statistics plotting helpers (port of hydrainfer_tpu/utils/statistic.py):
attention sparsity, heatmaps, histograms. numpy, and matplotlib where a plot
is asked for."""
import numpy as np


def attention_sparsity(scores: np.ndarray, threshold: float = 0.01) -> float:
    """Fraction of attention mass entries below threshold."""
    scores = np.asarray(scores)
    return float((scores < threshold).mean())


def plot_heatmap(matrix, path: str, title: str = "", cmap: str = "viridis") -> None:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(6, 5))
    im = ax.imshow(np.asarray(matrix), aspect="auto", cmap=cmap)
    ax.set_title(title)
    fig.colorbar(im)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def plot_histogram(values, path: str, bins: int = 50, title: str = "",
                   log: bool = False) -> None:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.hist(np.asarray(values).ravel(), bins=bins, log=log)
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
