"""Production layouts: named axis sizes, no process group.

Port of ``repro.launch.mesh`` as metadata. A ``Layout`` carries what the
placement arithmetic (``dist.sharding``) reads of a mesh -- its axis
names and ``shape`` -- and nothing else, so importing or building one
touches no device. Coded gradient workers live on the (pod, data) axes,
tensor parallelism on ``model``. ``dist.process_group`` forms the
process groups of a layout.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class Layout:
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"{len(self.axis_names)} axis names for "
                             f"{len(self.sizes)} sizes")
        if any(int(s) < 1 for s in self.sizes):
            raise ValueError(f"axis sizes must be >= 1, got {self.sizes}")

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, like a mesh's ``shape``."""
        return dict(zip(self.axis_names, (int(s) for s in self.sizes)))

    @property
    def size(self) -> int:
        """Devices the layout spans."""
        return math.prod(int(s) for s in self.sizes)


def make_production_layout(*, multi_pod: bool = False) -> Layout:
    """Single pod: (data=16, model=16) = 256 devices. Multi-pod: a
    leading pod=2 axis = 512 devices."""
    if multi_pod:
        return Layout(("pod", "data", "model"), (2, 16, 16))
    return Layout(("data", "model"), (16, 16))


def make_test_layout(shape=(1, 1), axes=("data", "model")) -> Layout:
    return Layout(tuple(axes), tuple(int(s) for s in shape))


def num_coded_workers(layout) -> int:
    m = layout.shape["data"]
    if "pod" in layout.axis_names:
        m *= layout.shape["pod"]
    return m
