"""slam_robot_tpu — a SLAM robot framework in JAX, run on a GPU.

A from-scratch rebuild of the capabilities of the ywrt/slam-robot C++ stack
(monocular/alternating-stereo SLAM + Dubins planning + vehicle control) as a
fixed-capacity, mask-based, struct-of-arrays JAX program:

- ``ops``       pure geometry + image kernels (quaternions, projection,
                pyramids, patch tracking, corner detection, Gauss-Newton BA)
- ``models``    stateful-but-functional subsystems (localmap pytree, matcher,
                slam solver windows, full pipeline step, planner, vehicle, sim)
- ``parallel``  multi-device sharding: shard_map bundle adjustment, vmapped
                rollout fleets, multi-robot shared maps
- ``io``        host-side frame sources / recorders (outside the jit boundary)
- ``utils``     histograms, timers, metrics, checkpointing, debug rendering
"""

__version__ = "0.1.0"

from slam_robot_tpu.config import SlamConfig  # noqa: F401
