"""Trajectory plots + animation from a states.json (counterpart of
``mpc_cbf_tpu/apps/plot_results.py``; host code). matplotlib is imported
inside the plotting functions only, so the package imports without it.

Reference parity: ``experiments/python/visualization/plot_results.py``
(trajectory figure with start/goal markers, optional connectivity edges,
mp4/gif animation of robot motion).

Usage:
  python -m mpc_cbf_torch.apps.plot_results --states /tmp/states.json \
      --out /tmp/traj.png [--edges-dmax 4.0] [--gif /tmp/traj.gif]
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def load_states(path: str):
    with open(path) as f:
        d = json.load(f)
    robots = d["robots"]
    keys = sorted(robots, key=int)
    traj = np.stack([np.asarray(robots[k]["states"])[:, :3] for k in keys], axis=1)
    # goal fallback indexes by enumeration position, not robot id — ids may
    # be non-contiguous (e.g. keys "0","2") while traj columns are packed
    goals = np.stack([np.asarray(robots[k].get("goal", traj[-1, idx]))
                      for idx, k in enumerate(keys)])
    return traj, goals, d  # traj [T, R, 3]


def plot_trajectories(traj: np.ndarray, goals: np.ndarray, ax=None,
                      edges_dmax: float | None = None):
    plt = _pyplot()
    T, R = traj.shape[:2]
    if ax is None:
        _, ax = plt.subplots(figsize=(6, 6))
    cmap = plt.get_cmap("tab10")
    for i in range(R):
        c = cmap(i % 10)
        ax.plot(traj[:, i, 0], traj[:, i, 1], "-", color=c, lw=1.2,
                label=f"robot {i}")
        ax.plot(traj[0, i, 0], traj[0, i, 1], "o", color=c, ms=7)
        ax.plot(goals[i, 0], goals[i, 1], "*", color=c, ms=12)
    if edges_dmax is not None:
        last = traj[-1, :, :2]
        for i in range(R):
            for j in range(i + 1, R):
                if np.linalg.norm(last[i] - last[j]) <= edges_dmax:
                    ax.plot([last[i, 0], last[j, 0]], [last[i, 1], last[j, 1]],
                            ":", color="gray", lw=0.8)
    ax.set_aspect("equal")
    ax.grid(alpha=0.3)
    ax.legend(fontsize=7, loc="best")
    return ax


def animate(traj: np.ndarray, goals: np.ndarray, out: str, fps: int = 10,
            edges_dmax: float | None = None):
    plt = _pyplot()
    from matplotlib import animation

    T, R = traj.shape[:2]
    fig, ax = plt.subplots(figsize=(6, 6))
    cmap = plt.get_cmap("tab10")
    lo = traj[..., :2].reshape(-1, 2).min(0) - 1
    hi = traj[..., :2].reshape(-1, 2).max(0) + 1

    def draw(t):
        ax.clear()
        ax.set_xlim(lo[0], hi[0])
        ax.set_ylim(lo[1], hi[1])
        for i in range(R):
            c = cmap(i % 10)
            ax.plot(traj[: t + 1, i, 0], traj[: t + 1, i, 1], "-", color=c, lw=0.8)
            ax.plot(traj[t, i, 0], traj[t, i, 1], "o", color=c, ms=8)
            ax.plot(goals[i, 0], goals[i, 1], "*", color=c, ms=10)
        if edges_dmax is not None:
            cur = traj[t, :, :2]
            for i in range(R):
                for j in range(i + 1, R):
                    if np.linalg.norm(cur[i] - cur[j]) <= edges_dmax:
                        ax.plot([cur[i, 0], cur[j, 0]], [cur[i, 1], cur[j, 1]],
                                ":", color="gray", lw=0.8)
        ax.set_aspect("equal")
        return []

    anim = animation.FuncAnimation(fig, draw, frames=T, blit=False)
    anim.save(out, writer=animation.PillowWriter(fps=fps))
    plt.close(fig)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--states", required=True)
    p.add_argument("--out", default="traj.png")
    p.add_argument("--gif", default=None)
    p.add_argument("--edges-dmax", type=float, default=None,
                   help="draw connectivity edges for pairs within this range")
    args = p.parse_args(argv)

    traj, goals, _ = load_states(args.states)
    ax = plot_trajectories(traj, goals, edges_dmax=args.edges_dmax)
    ax.figure.savefig(args.out, dpi=130, bbox_inches="tight")
    print(args.out)
    if args.gif:
        animate(traj, goals, args.gif, edges_dmax=args.edges_dmax)
        print(args.gif)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
