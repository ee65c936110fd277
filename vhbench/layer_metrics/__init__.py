"""Per-layer metric readers: ``<name>.py`` holds ``read(ctx)``, which
returns the metric ``<name>`` of ``BENCHMARK.json`` or None when the run
has nothing to read for it (the harness then leaves it out).

``ctx`` (``harness.layer_metrics``) holds:

- ``cfg``: the program's ``EngineConfig``; ``work``: ``vhbench/work.py``;
- ``device_ops``: (kernel name, start us, end us) of every device op of
  the ``prof_frames`` profiled graphed frames (one whole lap);
  ``busy_ms``: device-busy ms a frame there; ``frame_ms``: wall ms a frame
  there; ``syncs_per_frame``: host syncs a graphed frame;
- ``stage_ms``: device ms a frame by ``engine.STAGES`` stage of the eager
  frames split by stage, and ``frames``: for each of those frames, its
  ``kernels`` ({name: ms}), ``n_active`` rows, ``n_updated`` voxels whose
  bits the fusion changed, and with the depth-only splat ``splat``
  (surface rows, band voxels) or with the march ``march``
  (``work.MarchWork``);
- ``stream``: None, or under streaming the window's streaming halves:
  ``ms``, host ms a half inside the manager's step over the frames not
  profiled.
"""
