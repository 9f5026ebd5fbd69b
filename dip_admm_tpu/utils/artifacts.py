"""Run-artifact writers: plots, arrays, parameter dumps.

Host-side reproduction of the reference orchestrator's artifact set
(``/root/reference/block_7_main_ver3.py:16-27`` reconstructions,
``:110-168`` stationarity curves, ``:174-231`` objective/residual curves,
``:236-325`` residual/MSE plots and ``.npy`` dumps; plus the parameter text
files at ``:38-57`` and ``block_6_admm_loop_ver2.py:291-306``). The device
loop returns dense history arrays; everything here is host-side numpy.
``.npy`` arrays and ``run_parameters.txt`` are always written; plots only
where matplotlib is installed (the ``plots`` extra).
"""

from __future__ import annotations

import dataclasses
import json
import os
from datetime import datetime

import numpy as np


def _pyplot():
    """matplotlib's pyplot on the Agg backend, or None when matplotlib is
    not installed (plots are skipped, arrays still written)."""
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _trim(history: dict, n_iters: int) -> dict:
    return {k: np.asarray(v)[:n_iters] for k, v in history.items()}


def save_run_parameters(out_dir: str, cfg, extra: dict | None = None) -> str:
    """Parameter dump (ref ``block_7_main_ver3.py:38-57``)."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "run_parameters.txt")
    with open(path, "w") as f:
        f.write("===== Global Parameters =====\n")
        f.write(json.dumps(dataclasses.asdict(cfg), indent=2, default=str))
        f.write(f"\nDate-Time: {datetime.now().strftime('%Y-%m-%d %H:%M:%S')}\n")
        for k, v in (extra or {}).items():
            f.write(f"{k}: {v}\n")
    return path


def save_recons(x, N: int, out_dir: str, tag: str) -> None:
    """Per-node reconstruction images + arrays (ref ``:16-27``).

    Uses the native async writer (``utils.native_artifacts``) when the
    toolchain is available — non-blocking (flushed by :func:`flush_async`);
    falls back to numpy (+ matplotlib images where installed) otherwise.
    """
    os.makedirs(out_dir, exist_ok=True)
    x = np.asarray(x)
    from dip_admm_tpu.utils import native_artifacts as na

    native = na.available()
    for i, xi in enumerate(x):
        img = xi.reshape(N, N)
        if native:
            na.save_npy(os.path.join(out_dir, f"{tag}_node_{i}.npy"), img)
            na.save_png_gray(os.path.join(out_dir, f"{tag}_node_{i}.png"), img)
            continue
        np.save(os.path.join(out_dir, f"{tag}_node_{i}.npy"), img)
        plt = _pyplot()
        if plt is None:
            continue
        plt.figure(figsize=(5, 5))
        plt.imshow(img, cmap="gray")
        plt.title(f"{tag}  node {i}")
        plt.axis("off")
        plt.tight_layout()
        plt.savefig(os.path.join(out_dir, f"{tag}_node_{i}.png"), dpi=160)
        plt.close()


def flush_async() -> None:
    """Wait for queued native writes (no-op without the native writer)."""
    from dip_admm_tpu.utils import native_artifacts as na

    if na.available():
        na.flush()


def _semilogy_per_node(arr, title, ylabel, path, floor=1e-12):
    plt = _pyplot()
    if plt is None:
        return
    plt.figure(figsize=(6, 4))
    for i in range(arr.shape[1]):
        plt.semilogy(np.abs(arr[:, i]) + floor, label=f"node {i}")
    plt.xlabel("iteration")
    plt.ylabel(ylabel)
    plt.title(title)
    plt.legend(ncol=2, fontsize=8)
    plt.tight_layout()
    plt.savefig(path, dpi=160)
    plt.close()


def _semilogy_total(arr, title, ylabel, path, floor=1e-12):
    plt = _pyplot()
    if plt is None:
        return
    plt.figure(figsize=(6, 4))
    plt.semilogy(np.abs(np.asarray(arr)) + floor)
    plt.xlabel("iteration")
    plt.ylabel(ylabel)
    plt.title(title)
    plt.tight_layout()
    plt.savefig(path, dpi=160)
    plt.close()


def save_mse_curves(curves: dict, out_dir: str) -> None:
    """Named MSE/residual trajectories as .npy + semilogy plots (the legacy
    solver's plotting set, ref ``ADMM_Tomo_Only.py:171-296``). 2-D arrays
    [T, P] are drawn per-node, 1-D arrays as single curves."""
    os.makedirs(out_dir, exist_ok=True)
    for name, arr in curves.items():
        arr = np.asarray(arr)
        np.save(os.path.join(out_dir, f"{name}.npy"), arr)
        path = os.path.join(out_dir, f"{name}.png")
        if arr.ndim == 2:
            _semilogy_per_node(arr, name, name, path)
        else:
            _semilogy_total(arr, name, name, path)


def _stationarity_plots(plt, g, h, out_dir, tag, written) -> None:
    """Per-node stationarity with the eps-target overlay (ref :110-154)
    and its mean/median (ref :155-168)."""
    plt.figure(figsize=(7, 4))
    ax1 = plt.gca()
    for i in range(g.shape[1]):
        ax1.semilogy(g[:, i], label=f"node {i}")
    ax1.semilogy(h["eps_target"], "k--", alpha=0.7, label=r"$\varepsilon_k$")
    ax1.set_xlabel("iteration")
    ax1.set_ylabel(r"$\|g_{x,i}\|_2$")
    ax1.set_title(f"Per node stationarity residual, {tag}")
    ax1.grid(True, which="both")
    ax1.legend(ncol=2, fontsize=8)
    plt.tight_layout()
    p = os.path.join(out_dir, f"{tag}_g_norm_per_node.png")
    plt.savefig(p, dpi=160)
    plt.close()
    written.append(p)

    # Mean/median stationarity (ref :155-168).
    plt.figure(figsize=(6, 4))
    plt.semilogy(g.mean(axis=1), label="mean")
    plt.semilogy(np.median(g, axis=1), label="median")
    plt.xlabel("iteration")
    plt.ylabel(r"$\|g_{x,i}\|_2$")
    plt.title(f"Mean and median stationarity residual, {tag}")
    plt.legend()
    plt.tight_layout()
    p = os.path.join(out_dir, f"{tag}_g_norm_stats.png")
    plt.savefig(p, dpi=160)
    plt.close()
    written.append(p)


def _residual_plot(plt, h, out_dir, tag, written) -> None:
    """Global primal/dual residuals (ref :240-253)."""
    plt.figure(figsize=(6, 4))
    plt.semilogy(h["primal"], label="primal")
    plt.semilogy(h["dual"], label="dual")
    plt.xlabel("iteration")
    plt.ylabel("L2 norm")
    plt.title(f"Residuals, {tag}")
    plt.legend()
    plt.tight_layout()
    p = os.path.join(out_dir, f"{tag}_residuals.png")
    plt.savefig(p, dpi=160)
    plt.close()
    written.append(p)


def save_history_artifacts(
    history: dict,
    n_iters: int,
    out_dir: str,
    tag: str,
    m_per_node: np.ndarray | None = None,
    N: int | None = None,
) -> list[str]:
    """The full block-7 artifact set from a run history.

    Sinogram MSE is normalized by m_i (ref ``:260-262``), image MSE by N^2
    (ref ``:295-298``); residuals/objectives/stationarity norms are plotted
    per node and total, and every curve is also saved as ``.npy``.
    """
    os.makedirs(out_dir, exist_ok=True)
    h = _trim(history, n_iters)
    written: list[str] = []

    def saveit(name, arr):
        p = os.path.join(out_dir, f"{tag}_{name}.npy")
        np.save(p, arr)
        written.append(p)
        return arr

    plt = _pyplot()

    # Stationarity residual curves with eps-target overlay (ref :110-168).
    g = saveit("g_norm_per_node", h["g_norm"])
    if plt is not None:
        _stationarity_plots(plt, g, h, out_dir, tag, written)

    # Objectives (ref :174-203).
    obj_pn = saveit("obj_per_node", h["obj_per_node"])
    _semilogy_per_node(
        obj_pn, f"Objective per node, {tag}", "objective",
        os.path.join(out_dir, f"{tag}_obj_per_node.png"),
    )
    obj_t = saveit("obj_total", h["obj_total"])
    _semilogy_total(
        obj_t, f"Total objective, {tag}", "objective",
        os.path.join(out_dir, f"{tag}_obj_total.png"),
    )

    # Primal/dual residuals per node (ref :205-231).
    pri_pn = saveit("pri_per_node", h["pri_per_node"])
    _semilogy_per_node(
        pri_pn, f"Primal residual per node, {tag}", "primal residual",
        os.path.join(out_dir, f"{tag}_pri_per_node.png"),
    )
    dual_pn = saveit("dual_per_node", h["dual_per_node"])
    _semilogy_per_node(
        dual_pn, f"Dual residual per node, {tag}", "dual residual",
        os.path.join(out_dir, f"{tag}_dual_per_node.png"),
    )

    # Global residuals (ref :240-253).
    saveit("primal_hist", h["primal"])
    saveit("dual_hist", h["dual"])
    if plt is not None:
        _residual_plot(plt, h, out_dir, tag, written)

    # Sinogram MSE normalized by m_i (ref :255-288).
    if m_per_node is not None:
        m_vec = np.asarray(m_per_node, dtype=float)
        mse_pn = saveit("sino_mse_per_node", h["mse_sino_per_node"] / m_vec)
        _semilogy_per_node(
            mse_pn, f"Per node sinogram MSE, {tag}",
            "sinogram MSE (1/m_i)||A_i x_i - b_i||^2",
            os.path.join(out_dir, f"{tag}_sino_mse_per_node.png"),
        )
        mse_t = saveit(
            "sino_mse_total", h["mse_sino_total"] / float(m_vec.sum())
        )
        _semilogy_total(
            mse_t, f"Total sinogram MSE, {tag}", "total sinogram MSE",
            os.path.join(out_dir, f"{tag}_sino_mse_total.png"),
        )

    # Image MSE normalized by N^2 (ref :291-325).
    if N is not None:
        n_pix = float(N * N)
        img_pn = saveit("img_mse_per_node", h["img_mse_per_node"] / n_pix)
        _semilogy_per_node(
            img_pn, f"Per node image MSE, {tag}",
            "image MSE (1/N^2)||x_i - x_true||^2",
            os.path.join(out_dir, f"{tag}_img_mse_per_node.png"),
        )
        img_t = saveit("img_mse_total", h["img_mse_total"] / n_pix)
        _semilogy_total(
            img_t, f"Total image MSE, {tag}", "total image MSE",
            os.path.join(out_dir, f"{tag}_img_mse_total.png"),
        )

    # Round-5 observability: per-node inner iterations + acceptance codes
    # (the auditable accept/tighten/retry record, ref ver2:155-176) and the
    # effective-rho trajectory (plotted only when it actually moves —
    # residual balancing, AdmmConfig.adapt_rho).
    if "inner_iters" in h:
        saveit("inner_iters_per_node", h["inner_iters"])
    if "accept_code" in h:
        saveit("accept_code_per_node", h["accept_code"])
    if "rho" in h:
        rho = saveit("rho_hist", h["rho"])
        finite = rho[np.isfinite(rho)]
        moves = finite.size and (finite.max() - finite.min()) > 1e-12
        if plt is not None and moves:
            plt.figure(figsize=(6, 4))
            plt.semilogy(rho)
            plt.xlabel("iteration")
            plt.ylabel(r"effective $\rho$")
            plt.title(f"Adaptive rho trajectory, {tag}")
            plt.grid(True, which="both")
            plt.tight_layout()
            p = os.path.join(out_dir, f"{tag}_rho_hist.png")
            plt.savefig(p, dpi=160)
            plt.close()
            written.append(p)

    return written


def save_union_graph(adj, out_dir: str, tag: str) -> str:
    """Union node-graph picture + degree histogram
    (ref ``block_3_graph_and_precisions.py:219-256``), without networkx:
    nodes on a circle, straight edges."""
    os.makedirs(out_dir, exist_ok=True)
    adj = np.asarray(adj)
    P = adj.shape[0]
    theta = 2 * np.pi * np.arange(P) / P
    xs, ys = np.cos(theta), np.sin(theta)
    p = os.path.join(out_dir, f"pixel_union_graph_{tag}.png")
    plt = _pyplot()
    if plt is None:
        return p
    plt.figure(figsize=(6, 6))
    for i in range(P):
        for j in range(i + 1, P):
            if adj[i, j]:
                plt.plot([xs[i], xs[j]], [ys[i], ys[j]], "b-", alpha=0.6)
    plt.scatter(xs, ys, s=600, c="#ffcc66", zorder=3, edgecolors="k")
    for i in range(P):
        plt.text(xs[i], ys[i], str(i), ha="center", va="center", zorder=4)
    plt.axis("off")
    plt.title(f"pixel union graph, {tag}")
    plt.tight_layout()
    plt.savefig(p, dpi=160)
    plt.close()

    degrees = adj.sum(axis=1)
    plt.figure(figsize=(6, 4))
    plt.hist(degrees, bins=range(int(degrees.min()), int(degrees.max()) + 2))
    plt.xlabel("Degree")
    plt.ylabel("Count")
    plt.title(f"Node degree histogram, {tag}")
    ph = os.path.join(out_dir, f"pixel_union_degree_{tag}.png")
    plt.tight_layout()
    plt.savefig(ph, dpi=160)
    plt.close()
    return p


def save_edge_map(x, N: int, path: str) -> None:
    """Edge-magnitude diagnostic image
    (ref ``block_4_tv_helpers_with_plot.py:42-62``)."""
    img = np.asarray(x).reshape(N, N)
    gx = np.zeros_like(img)
    gy = np.zeros_like(img)
    gx[:-1, :] = img[1:, :] - img[:-1, :]
    gy[:, :-1] = img[:, 1:] - img[:, :-1]
    mag = np.sqrt(gx**2 + gy**2)
    plt = _pyplot()
    if plt is None:
        return
    plt.figure(figsize=(5, 5))
    plt.imshow(mag, cmap="gray")
    plt.axis("off")
    plt.title("edge map")
    plt.tight_layout()
    plt.savefig(path, dpi=160)
    plt.close()
