"""Device-mesh helpers (counterpart of ``mpc_cbf_tpu/parallel/mesh.py``).

The reference has no distributed runtime at all — scale-out is bash loops
launching independent processes (``experiments/bash/ScaleScript.sh:16-35``).
Here scale is an axis pair over a grid of devices:

- ``scenario`` (data axis): embarrassingly parallel Monte-Carlo / sweep
  instances, split across devices and processes.
- ``agent`` (model axis): robots within one scenario. The port keeps a
  scenario's agents on one device (the axis is carried for the JAX
  package's layouts and replicates a scenario shard).

PyTorch has no global array that stays distributed without DTensor, so a
``Mesh`` is a plain [scenario, agent] grid of ``torch.device`` (with the
process that owns each entry), and a ``Sharding`` says which device takes
which slice of the leading axes; ``sharded_rollout`` and
``host_scenarios_to_global`` move the tensors themselves.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch


SCENARIO_AXIS = "scenario"
AGENT_AXIS = "agent"


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """devices: [scenario, agent] object array of torch.device;
    processes: the same shape, the rank of the process that drives each
    device (all 0 in one process)."""

    devices: np.ndarray
    processes: np.ndarray
    axis_names: Tuple[str, str] = (SCENARIO_AXIS, AGENT_AXIS)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size


def _grid(devices: Sequence[torch.device], scenario: int, agent: int) -> np.ndarray:
    arr = np.empty(len(devices), dtype=object)
    arr[:] = list(devices)
    return arr.reshape(scenario, agent)


def make_mesh(scenario: Optional[int] = None, agent: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Mesh over (scenario, agent). Default: every CUDA device of this
    process on the scenario axis (a mesh with none raises; pass a list of
    CPU devices to run on the CPU)."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("make_mesh: no CUDA device (pass devices=[...] for the CPU)")
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if scenario is None:
        scenario = n // agent
    if scenario * agent != n:
        raise ValueError(f"{scenario}x{agent} mesh needs {scenario * agent} devices, have {n}")
    rank = torch.distributed.get_rank() if torch.distributed.is_initialized() else 0
    return Mesh(_grid(devices, scenario, agent), np.full((scenario, agent), rank))


@dataclasses.dataclass(frozen=True)
class Sharding:
    """The counterpart of ``NamedSharding(mesh, P(*axes))``: the leading
    len(axes) axes of an array are split into equal contiguous slices over
    those mesh axes; a mesh axis not named replicates."""

    mesh: Mesh
    axes: Tuple[str, ...]

    def shards(self, shape) -> List[Tuple[torch.device, int, Tuple[slice, ...]]]:
        """(device, process, index) of every mesh entry, in mesh order, for
        an array of ``shape``."""
        out = []
        S, A = self.mesh.devices.shape
        for i in range(S):
            for j in range(A):
                index = []
                for ax, (pos, count) in zip(self.axes, ((i, S), (j, A))):
                    size = shape[len(index)]
                    if size % count:
                        raise ValueError(f"axis {len(index)} of {tuple(shape)} does not split "
                                         f"into {count} ({ax})")
                    step = size // count
                    index.append(slice(pos * step, (pos + 1) * step))
                out.append((self.mesh.devices[i, j], int(self.mesh.processes[i, j]),
                            tuple(index)))
        return out


def scenario_sharding(mesh: Mesh) -> Sharding:
    """Leading-axis split over scenarios, replicated over agents."""
    return Sharding(mesh, (SCENARIO_AXIS,))


def scenario_agent_sharding(mesh: Mesh) -> Sharding:
    """[S, A, ...] arrays split over both mesh axes."""
    return Sharding(mesh, (SCENARIO_AXIS, AGENT_AXIS))
