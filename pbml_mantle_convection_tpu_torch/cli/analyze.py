"""Rollout-run comparison report (``pmc-analyze``).

The port's counterpart of the JAX package's ``cli/analyze.py``, with its
flags, rows and metric dicts (numpy and scipy; matplotlib and PIL only
under ``--figures`` or ``--scalings``); it reads the run directories of
either package's rollout CLI. The analogue of the reference's analysis
notebook (load_advection_results-checkpoint.ipynb cells 3-6): ingest N
run directories written by ``sim/rollout.py`` (the reference pickle
layout — ``snapshots_<mode>.pkl`` / ``t_vec`` / ``T_vec`` / ``TS_vec``,
advect_wi_gaia.py:654-668), designate one as the solver baseline, and
emit the per-run comparison the notebook plots:

* final-snapshot temperature Pearson correlation vs the baseline
  (cell 5: ``pearsonr(z.flatten(), z_t.flatten())``),
* horizontally-averaged temperature profile MAE
  (``np.mean(np.abs(Tp_t - Tp))``),
* mean-temperature trace MAE over the common length,
* cumulative computation time and the matched-physical-time speedup
  (cell 5's ``ts_mark`` logic), plus per-step latency percentiles from
  TS_vec.

Output: a markdown table on stdout (STUDY.md-style) and, with
``--json``, the full metric dict per run::

    python -m pbml_mantle_convection_tpu_torch.cli.analyze RUN_DIR ... \
        [--truth GAIA_RUN_DIR] [--json out.json] [--figures DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import sys

import numpy as np


def load_run(run_dir: str, mode: str | None = None):
    """Load one rollout run directory. ``mode`` defaults to whatever
    single ``snapshots_*.pkl`` is present (error if ambiguous)."""
    if mode is None:
        cands = [f[len("snapshots_"):-len(".pkl")]
                 for f in os.listdir(run_dir)
                 if f.startswith("snapshots_") and f.endswith(".pkl")]
        if len(cands) != 1:
            raise ValueError(
                f"{run_dir}: expected exactly one snapshots_<mode>.pkl, "
                f"found {cands}; pass --mode")
        mode = cands[0]

    def _ld(name):
        with open(os.path.join(run_dir, f"{name}_{mode}.pkl"), "rb") as f:
            return pickle.load(f)

    return dict(mode=mode, name=os.path.basename(os.path.normpath(run_dir)),
                snapshots=_ld("snapshots"), t=np.asarray(_ld("t_vec")),
                T=np.asarray(_ld("T_vec")), TS=np.asarray(_ld("TS_vec")))


def _field(snapshots, index: int, var: str = "T"):
    """Snapshot field reshaped to (H, W), inferred from the stored
    cell-centre grids (the notebook hard-codes 128×506;
    load_advection_results cell 4 ``get_plot_data``)."""
    xcc = np.asarray(snapshots["xcc"])
    H, W = xcc.reshape(xcc.shape[-2:]).shape if xcc.ndim > 2 else xcc.shape
    if var in ("u", "v"):
        z = np.asarray(snapshots["v"][index])[:, 0 if var == "u" else 1]
    else:
        z = np.asarray(snapshots[var][index])
    return z.reshape(H, W)


def profile(z):
    """Horizontally-averaged profile + its vertical derivative on the
    reference's stretched height coordinate (get_plot_data)."""
    H = z.shape[0]
    n_in = H - 2
    r = np.asarray([0.0] + np.linspace(1 / (2 * n_in), 1 - 1 / (2 * n_in),
                                       n_in).tolist() + [1.0])
    Tp = np.mean(z, axis=-1).ravel()
    dTp = (Tp[1:] - Tp[:-1]) / (r[1:] - r[:-1])
    return r, Tp, dTp


def _speedup(t, TS, t_t, TS_t):
    """Matched-physical-time speedup (cell 5's ts_mark logic): compare
    cumulative compute time at the largest common physical time."""
    ct = np.cumsum(TS) / 3600.0
    ct_t = np.cumsum(TS_t) / 3600.0
    n = min(len(t), len(ct))
    n_t = min(len(t_t), len(ct_t))
    t, ct = t[:n], ct[:n]
    t_t, ct_t = t_t[:n_t], ct_t[:n_t]
    if len(t) == 0 or len(t_t) == 0:
        return float("nan")
    if t[-1] == t_t[-1]:
        return float(ct_t[-1] / ct[-1])
    if t[-1] > t_t[-1]:
        idx = np.where(t < t_t[-1])[0]
        if len(idx) == 0:
            return float("nan")
        return float(ct_t[-1] / ct[idx[-1]])
    idx = np.where(t_t < t[-1])[0]
    if len(idx) == 0:
        return float("nan")
    return float(ct_t[idx[-1]] / ct[-1])


def compare(run, truth, snap_index: int = -1):
    """All notebook cell-5 metrics of ``run`` against ``truth``."""
    try:
        from scipy.stats import pearsonr
        _pearson = lambda a, b: float(pearsonr(a, b)[0])
    except ImportError:                      # scipy not guaranteed
        def _pearson(a, b):
            a = a - a.mean()
            b = b - b.mean()
            return float((a * b).sum()
                         / np.sqrt((a * a).sum() * (b * b).sum()))

    z = _field(run["snapshots"], snap_index)
    z_t = _field(truth["snapshots"], snap_index)
    _, Tp, dTp = profile(z)
    _, Tp_t, dTp_t = profile(z_t)
    n = min(len(run["T"]), len(truth["T"]))
    out = dict(
        name=run["name"], mode=run["mode"],
        steps=int(len(run["t"])),
        t_end=float(run["t"][-1]) if len(run["t"]) else float("nan"),
        pearson_T=_pearson(z.ravel(), z_t.ravel()),
        profile_mae=float(np.mean(np.abs(Tp_t - Tp))),
        dprofile_mae=float(np.mean(np.abs(dTp_t - dTp))),
        trace_mae=float(np.mean(np.abs(run["T"][:n] - truth["T"][:n]))),
        T_rmse=float(np.sqrt(np.mean((z - z_t) ** 2))),
        speedup=_speedup(run["t"], run["TS"], truth["t"], truth["TS"]),
    )
    if len(run["TS"]):
        ts = np.asarray(run["TS"], float)
        out.update(
            step_ms_mean=float(ts.mean() * 1e3),
            step_ms_p50=float(np.percentile(ts, 50) * 1e3),
            step_ms_p90=float(np.percentile(ts, 90) * 1e3),
            compute_hours=float(ts.sum() / 3600.0))
    return out


_COLS = [("name", "run"), ("mode", "mode"), ("steps", "steps"),
         ("t_end", "t_end"), ("pearson_T", "Pearson(T)"),
         ("T_rmse", "T-RMSE"), ("profile_mae", "profile MAE"),
         ("trace_mae", "trace MAE"), ("speedup", "speedup"),
         ("step_ms_mean", "ms/step"), ("step_ms_p90", "p90 ms")]


def _fmt(v):
    if isinstance(v, float):
        if v != v:
            return "-"
        return f"{v:.4g}"
    return str(v)


def report(rows):
    head = [h for _, h in _COLS]
    lines = ["| " + " | ".join(head) + " |",
             "|" + "|".join("---" for _ in head) + "|"]
    for r in rows:
        lines.append("| " + " | ".join(
            _fmt(r.get(k, float("nan"))) for k, _ in _COLS) + " |")
    return "\n".join(lines)


def write_figures(runs, truth, out_dir: str, gif: bool = True):
    """Figure/gif artifacts of the analysis notebook
    (load_advection_results-checkpoint.ipynb cells 3-6): the mean-T
    trace comparison, final-snapshot temperature heatmaps, the
    horizontally-averaged T(z) profiles, and per-run temperature-field
    gifs over the recorded snapshots."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    written = []

    # 1. mean-T trace vs physical time (cell 3's T_vec plots)
    fig, ax = plt.subplots(figsize=(7, 4))
    for r in runs:
        n = min(len(r["t"]), len(r["T"]))
        ax.plot(r["t"][:n], r["T"][:n],
                lw=2.2 if r is truth else 1.2,
                color="k" if r is truth else None,
                label=f"{r['name']} [{r['mode']}]")
    ax.set_xlabel("physical time")
    ax.set_ylabel("mean T")
    ax.legend(fontsize=7)
    fig.tight_layout()
    p = os.path.join(out_dir, "mean_T_trace.png")
    fig.savefig(p, dpi=130)
    plt.close(fig)
    written.append(p)

    # 2. final-snapshot temperature heatmaps (cell 4 get_plot_data)
    for r in runs:
        if not len(r["snapshots"]["T"]):
            continue
        z = _field(r["snapshots"], -1)
        fig, ax = plt.subplots(
            figsize=(8, 8 * z.shape[0] / max(z.shape[1], 1) + 0.8))
        im = ax.imshow(z, origin="lower", cmap="inferno",
                       vmin=0.0, vmax=max(1.0, float(z.max())),
                       aspect="auto")
        fig.colorbar(im, ax=ax, shrink=0.8, label="T")
        ax.set_title(f"{r['name']} [{r['mode']}] — final T")
        fig.tight_layout()
        p = os.path.join(out_dir, f"snapshot_{r['name']}.png")
        fig.savefig(p, dpi=130)
        plt.close(fig)
        written.append(p)

    # 3. horizontally-averaged profiles (cell 4's Tp plots)
    fig, ax = plt.subplots(figsize=(4, 5))
    for r in runs:
        if not len(r["snapshots"]["T"]):
            continue
        rr, Tp, _ = profile(_field(r["snapshots"], -1))
        ax.plot(Tp, rr, lw=2.2 if r is truth else 1.2,
                color="k" if r is truth else None,
                label=f"{r['name']}")
    ax.set_xlabel("horizontally averaged T")
    ax.set_ylabel("height")
    ax.legend(fontsize=7)
    fig.tight_layout()
    p = os.path.join(out_dir, "profiles.png")
    fig.savefig(p, dpi=130)
    plt.close(fig)
    written.append(p)

    # 4. per-run temperature gifs (the notebook's gif generation)
    if gif:
        try:
            from PIL import Image
        except ImportError:
            return written
        for r in runs:
            frames = []
            for i in range(len(r["snapshots"]["T"])):
                z = np.clip(_field(r["snapshots"], i), 0.0, 1.0)
                rgba = (plt.get_cmap("inferno")(z) * 255).astype(np.uint8)
                frames.append(Image.fromarray(rgba[::-1]))  # origin lower
            if len(frames) > 1:
                p = os.path.join(out_dir, f"T_{r['name']}.gif")
                frames[0].save(p, save_all=True, append_images=frames[1:],
                               duration=120, loop=0)
                written.append(p)
    return written


def write_scalings_figure(pkl_path: str, out_dir: str):
    """The paper's scaling-law figure (Paper/figures.ipynb cells 1-2)
    from a ``scalings.pkl``: per-simulation min–max ranges of T, V, P
    and of the raw vs scaling-law-normalized velocities, plotted
    against RaQ. The 15 arrays are (raq, fkt, fkp, u_mi, u_ma, v_mi,
    v_ma, p_mi, p_ma, V_mi, V_ma, T_mi, T_ma, dt_mi, dt_ma); the
    velocity normalizer is the C1 scaling law (scaler.py:4-36). The
    notebook's "unscaled" panels divide by the global |u,v| range
    (its ``uv_std`` — defined only in a comment there; reproduced
    here as written)."""
    import pickle as _pickle

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ..constants import velocity_scaler

    with open(pkl_path, "rb") as f:
        (raq, fkt, fkp, u_mi, u_ma, v_mi, v_ma, p_mi, p_ma,
         V_mi, V_ma, T_mi, T_ma, dt_mi, dt_ma) = _pickle.load(f)
    raq, fkt, fkp = (np.asarray(a, float) for a in (raq, fkt, fkp))
    s = velocity_scaler(raq, fkt, fkp)
    uv_std = (np.max(np.abs([u_mi, u_ma, v_mi, v_ma]))
              - np.min(np.abs([u_mi, u_ma, v_ma, v_ma])))

    panels = [
        ("T", T_mi, T_ma), ("V", V_mi, V_ma), ("P", p_mi, p_ma),
        ("Unscaled u", u_mi / uv_std, u_ma / uv_std),
        ("Unscaled v", v_mi / uv_std, v_ma / uv_std),
        ("dt", dt_mi, dt_ma), ("Scaled u", u_mi / s, u_ma / s),
        ("Scaled v", v_mi / s, v_ma / s),
    ]
    fig = plt.figure(figsize=(15, 6), dpi=160)
    for k, (title, lo, hi) in enumerate(panels):
        ax = fig.add_subplot(2, 4, k + 1)
        for i in range(len(raq)):
            ax.plot([raq[i], raq[i]], [lo[i], hi[i]], "b-", lw=0.8)
        ax.set_xlabel("Q")
        ax.set_title(title)
        if k % 4 == 0:
            ax.set_ylabel("Min-Max")
    fig.tight_layout()
    os.makedirs(out_dir, exist_ok=True)
    p = os.path.join(out_dir, "scalings.png")
    fig.savefig(p)
    plt.close(fig)
    return p


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="pmc-analyze",
        description="Compare rollout run directories against a solver "
                    "baseline (load_advection_results cells 3-6).")
    ap.add_argument("runs", nargs="*",
                    help="run directories (sim/rollout.py pickle sets)")
    ap.add_argument("--truth", default=None,
                    help="baseline run directory (default: the first "
                         "run with mode GAIA, else the first run)")
    ap.add_argument("--mode", default=None,
                    help="pickle mode suffix when a dir holds several")
    ap.add_argument("--snap-index", type=int, default=-1,
                    help="snapshot index for field metrics (the "
                         "notebook uses -10 of its 200-step snaps)")
    ap.add_argument("--json", dest="json_out", default=None,
                    help="also write the metric dicts to this file")
    ap.add_argument("--figures", default=None, metavar="DIR",
                    help="write trace/snapshot/profile figures and "
                         "per-run T gifs to DIR (the notebook's plot "
                         "and gif cells)")
    ap.add_argument("--scalings", default=None, metavar="PKL",
                    help="write the paper's scaling-law figure "
                         "(Paper/figures.ipynb) from a scalings.pkl to "
                         "--figures DIR (default '.')")
    args = ap.parse_args(argv)

    if args.scalings:
        p = write_scalings_figure(args.scalings, args.figures or ".")
        print(f"scalings figure: {p}")
        if not args.runs:
            return [p]
    elif not args.runs:
        ap.error("no run directories given (and no --scalings)")

    runs = [load_run(d, args.mode) for d in args.runs]
    if args.truth is not None:
        truth = load_run(args.truth, args.mode)
    else:
        truth = next((r for r in runs if r["mode"] == "GAIA"), runs[0])

    rows = [compare(r, truth, args.snap_index) for r in runs]
    for row, r in zip(rows, runs):
        if r is truth:
            row["name"] += " (baseline)"
    print(f"baseline: {truth['name']} [{truth['mode']}]")
    print(report(rows))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(rows, f, indent=1)
    if args.figures:
        written = write_figures(runs, truth, args.figures)
        print(f"figures: {len(written)} files in {args.figures}")
    return rows


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
