"""voxelhashing_tpu_torch: the PyTorch/CUDA port of ``voxelhashing_tpu``.

The paths it runs, each written in PyTorch and tested against the JAX
package, which stays the reference (module and function names mirror it):

* the per-frame reconstruction step (``engine.step``: preprocess ->
  compactify -> render -> ICP track -> DDA alloc -> fused integrate -> GC
  -> maintain), with the splat renderer and depth-only ICP by default,
  and ``engine.make_step``, the same step on a CUDA state as replays of
  captured CUDA graphs (a front graph to tracking, a back graph from
  allocation, one host read between them and one after);
* the march renderer (``RaycastConfig(mode="march")``) and RGB-D tracking
  (``TrackerConfig(use_rgbd=True)``), with ``render`` for shaded images
  and point clouds;
* the out-of-core path: ``streaming`` (HBM <-> host chunk streaming over
  the native chunk store of ``native``), checkpoints
  (``streaming.save_map``/``load_map``) and meshes (``meshing``);
* the SLAM layer: ``posegraph`` (keyframes, loop closure, relocalization,
  the pose-graph solve, re-integration), ``diagnostics``, recorded input
  (``io/``: .sens, TUM, mLib dumps, a network sensor) and the entry point
  ``python -m voxelhashing_tpu_torch.run_slam``;
* the multi-device path (``parallel/``), on ``torch.distributed`` with one
  rank per process: the hash-partitioned step (``sharded``: each rank owns
  the keys with ``mix(k) % D == rank`` in a map of 1/D capacity and runs
  kernels A and B on it; one MIN all-reduce of the z-buffers, one SUM
  all-reduce per ICP sum), the sharded march render, ``gather_map``, the
  sharded streaming manager and ``PoseGraph.optimize_distributed``; gloo
  (also for ranks that share a card, staged through pinned memory) or
  NCCL;
* the dense voxel-grid baseline: ``densegrid`` (a ``[Z,Y,X]`` TSDF volume:
  integrate, trilinear sampling, the march render, the mesh), its
  per-frame loop ``denseengine`` (preprocess -> dense render -> ICP ->
  dense integrate) and the entry point ``python -m
  voxelhashing_tpu_torch.run_dense``; plain torch, as the JAX package runs
  it as XLA, and an oracle for kernel A's fusion.

The hand-written CUDA kernels for Hopper (``ops/``, sources in
``csrc/``), and the two TPU Pallas kernels they replace, where there is
one:

* kernel A, the fused TSDF integrate (``ops/fused_integrate.py``,
  ``csrc/fused_integrate.cu``), for ``voxelhashing_tpu/ops/
  pallas_integrate.py`` (``pl.pallas_call`` at :321); with
  ``MapConfig.bilinear_color`` a per-frame color-word image and A's
  bilinear variant (XLA on the TPU);
* kernel B, the splat z-buffer (``ops/splat_zbuf.py``,
  ``csrc/splat_zbuf.cu``), for ``voxelhashing_tpu/ops/pallas_splat.py``
  (``pl.pallas_call`` at :188); a color render runs B's walk once with a
  64-bit (depth, index) key per voxel and a per-pixel resolve (XLA on the
  TPU);
* the tracker's ICP update (``ops/icp_update.py``, ``csrc/solve6.cu``),
  one launch a solve: the 6x6 truncated-SVD solve (Jacobi on the f64
  Gram matrix, with no host read where ``torch.linalg.svd`` reads the
  device twice a call), the step gate, the de-whitened pose update and
  the tracker's carry written in place (XLA on the TPU); ``ops/solve6.py``
  runs its solve batched, for the checks;
* the tracker's passes (``ops/icp_linearize.py``,
  ``csrc/icp_linearize.cu``): on a single device one launch an ICP
  iteration (the association, a grid barrier, the linearization), on
  the sharded path the association and the linearization apart, with
  the cross-rank reduction between them (XLA on the TPU);
* the march renderer's tile bounds and per-ray march (``ops/raymarch.py``,
  ``csrc/raymarch.cu``), one launch each a render on a single device
  (XLA on the TPU).

The port imports ``torch`` and never ``jax``, nor anything of the JAX
package: it carries its own ``config``, synthetic frames
(``io/synthetic.py``, rendered on the device) and ATE (``evaluation``).
``convert`` turns the JAX package's configs and states into the port's.

The tracker's normal equations and every rigid transform must stay in full
f32, so TF32 is switched off for matmuls and cuDNN here.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
