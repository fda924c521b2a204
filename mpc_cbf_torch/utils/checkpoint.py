"""Checkpoint / resume for long rollouts and sweeps (counterpart of
``mpc_cbf_tpu/utils/checkpoint.py``).

The reference has no checkpointing (a per-run JSON written only at process
end: a crash loses everything). Here an atomic plain-npz snapshot of any
nested container of tensors (sim state, generator state, step counter)
survives a crash. Leaves are written as ``leaf_0``, ``leaf_1``, ... in the
order of ``jax.tree.flatten`` (``utils/tree.py``), so the same tree saved by
either package gives the same ``leaf_i`` arrays; the stored structure
string is this package's own, and a JAX checkpoint does not load here.

Usage:
    ckpt = Checkpointer("/tmp/run1")
    ckpt.save(step, {"state": state, "generator": generator.get_state()})
    step, tree = ckpt.restore_latest(like)   # (None, None) if nothing saved
"""

from __future__ import annotations

import os
import re
from typing import Any, Optional, Tuple

import numpy as np
import torch

from mpc_cbf_torch.types import State
from mpc_cbf_torch.utils.tree import tree_flatten, tree_unflatten


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _like(arr: np.ndarray, like):
    """arr on like's device in like's dtype (a tensor), else a numpy array."""
    if isinstance(like, torch.Tensor):
        return torch.as_tensor(arr, dtype=like.dtype, device=like.device)
    return arr


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"ckpt_{step:08d}.npz")

    def save(self, step: int, tree: Any) -> str:
        """Snapshot a tree of tensors at ``step``. Atomic (tmp + rename).
        Device tensors are copied to the host: one wait for the device."""
        leaves, structure = tree_flatten(tree)
        arrs = {f"leaf_{i}": _host(x) for i, x in enumerate(leaves)}
        path = self._path(step)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, __treedef__=np.frombuffer(structure.encode(), dtype=np.uint8), **arrs)
        os.replace(tmp, path)
        self._gc()
        return path

    def steps(self):
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"ckpt_(\d+)\.npz", name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def restore(self, step: int, like: Any) -> Any:
        """Restore the tree saved at ``step`` in ``like``'s structure, each
        tensor leaf on its ``like`` leaf's device and in its dtype. Fails
        loudly if the stored structure does not match ``like`` (a silent
        shape-mismatch restore is worse than no checkpoint)."""
        like_leaves, structure = tree_flatten(like)
        with np.load(self._path(step)) as data:
            n = len([k for k in data.files if k.startswith("leaf_")])
            leaves = [data[f"leaf_{i}"] for i in range(n)]
            stored = bytes(data["__treedef__"]).decode() if "__treedef__" in data.files else None
        if stored is not None and stored != structure:
            raise ValueError(f"checkpoint structure mismatch at step {step}:\n"
                             f"  stored:   {stored}\n  expected: {structure}")
        if len(leaves) != len(like_leaves):
            raise ValueError(f"checkpoint at step {step} holds {len(leaves)} leaves, "
                             f"expected {len(like_leaves)}")
        return tree_unflatten(like, [_like(a, x) for a, x in zip(leaves, like_leaves)])

    def restore_latest(self, like: Any) -> Tuple[Optional[int], Any]:
        steps = self.steps()
        if not steps:
            return None, None
        s = steps[-1]
        return s, self.restore(s, like)

    def _gc(self):
        steps = self.steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            try:
                os.remove(self._path(s))
            except OSError:
                pass


def checkpointed_rollout(sim, init: State, goals: torch.Tensor, num_steps: int,
                         generator: torch.Generator, ckpt: Checkpointer, every: int = 50):
    """Run ``sim.rollout`` in segments of at most ``every`` steps, saving
    {"step", "pos", "vel", "generator"} after each segment and resuming from
    the latest snapshot if one exists. Warm starts restart at every segment,
    as in the JAX package. One generator (``generator``, on init's device,
    advanced in place) draws every segment's noise and is restored from the
    snapshot on resume, so a resumed run equals an uninterrupted one; the JAX
    package splits a key per segment instead, so noisy runs differ between
    the packages.

    Returns ((traj_pos, traj_vel, success) concatenated over the time axis
    of the steps run in this call, final State), or (None, state) when the
    snapshot already reaches ``num_steps``.
    """
    template = {"step": np.asarray(0), "pos": init.pos, "vel": init.vel,
                "generator": generator.get_state()}
    _, snap = ckpt.restore_latest(template)
    state = init
    start = 0
    if snap is not None:
        state = State(pos=snap["pos"], vel=snap["vel"])
        generator.set_state(snap["generator"])
        start = int(snap["step"])

    chunks = []
    step = start
    while step < num_steps:
        seg = min(every, num_steps - step)
        res = sim.rollout(state, goals, seg, generator=generator)
        state = res.states
        chunks.append((res.traj_pos, res.traj_vel, res.success))
        step += seg
        ckpt.save(step, {"step": np.asarray(step), "pos": state.pos, "vel": state.vel,
                         "generator": generator.get_state()})
    if not chunks:
        return None, state
    t_axis = init.pos.dim() - 2                       # [.., T, A, dim]
    return tuple(torch.cat([c[i] for c in chunks], dim=t_axis) for i in range(3)), state
