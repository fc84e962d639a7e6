"""Multi-device scaling: meshes, sharded bundle adjustment, rollout fleets,
multi-robot shared maps.

The reference is strictly single-process (SURVEY §2: no DP/TP/PP/EP, no
communication backend). The JAX equivalents built here:

- data parallel: fleets of independent SLAM rollouts sharded over a mesh
  axis (``rollouts``)
- tensor parallel: the bundle-adjustment block assembly sharded over the
  observation table, with XLA inserting the all-reduces
  (``sharded_ba``)
- multi-robot: per-robot trajectories against one shared landmark table,
  alternating frame/point solves with cross-robot accumulation
  (``multi_robot``)

Sequence/pipeline/expert parallelism have no analog in this workload (no
attention, no experts; the trajectory-length axis is windowed instead —
SURVEY §5).
"""
