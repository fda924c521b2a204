"""Task-instance generator CLI (counterpart of
``mpc_cbf_tpu/apps/generate_instances.py``; host code, no device).

Reference parity: ``experiments/python/instances/generate_circle_instance.py``,
``generate_fov_instance.py``, ``generate_formation_instance1.py`` and the
``experiments/config/baseline/{2r,3r,5r,6r,8r}`` instance set.

Usage:
  # one instance
  python -m mpc_cbf_torch.apps.generate_instances --kind circle -n 4 -r 3 \
      --out configs/tasks_4r_circle.json
  # the full baseline set (circle swaps at the reference sizes)
  python -m mpc_cbf_torch.apps.generate_instances --baseline-dir configs/baseline
"""

from __future__ import annotations

import argparse
import json
import os

from mpc_cbf_torch.utils import instances as gen

KINDS = {
    "circle": lambda a: gen.circle_swap_instance(a.num_robots, a.radius),
    "rotate": lambda a: gen.circle_rotate_instance(a.num_robots, a.radius),
    "line": lambda a: gen.line_to_line_instance(a.num_robots),
    "formation": lambda a: gen.formation_instance(a.num_robots),
    "random": lambda a: gen.random_instance(a.num_robots, seed=a.seed),
    "fov": lambda a: gen.fov_circle_instance(a.num_robots, a.radius),
}

#: the reference baseline sizes (experiments/config/baseline/{N}r)
BASELINE_SIZES = (2, 3, 5, 6, 8)


def write(path: str, payload: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f, indent=4)
    print(path)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--kind", choices=sorted(KINDS), default="circle")
    p.add_argument("-n", "--num-robots", type=int, default=4)
    p.add_argument("-r", "--radius", type=float, default=3.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None)
    p.add_argument("--baseline-dir", default=None,
                   help="emit the full baseline set (circle + rotate per size) here")
    args = p.parse_args(argv)

    if args.baseline_dir:
        for n in BASELINE_SIZES:
            # chord spacing ~ 2R sin(pi/n): keep it >= ~1.5x the default d_min
            ns = argparse.Namespace(num_robots=n, radius=max(2.0, n / 2.0),
                                    seed=args.seed)
            write(os.path.join(args.baseline_dir, f"{n}r", "circle.json"),
                  KINDS["circle"](ns))
            write(os.path.join(args.baseline_dir, f"{n}r", "rotate.json"),
                  KINDS["rotate"](ns))
        return 0

    out = args.out or f"tasks_{args.num_robots}r_{args.kind}.json"
    write(out, KINDS[args.kind](args))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
