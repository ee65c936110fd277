"""The multi-device path of the port, on ``torch.distributed`` (port of
``voxelhashing_tpu.parallel``): ``sharded`` (the hash-partitioned step,
its render and ``gather_map``), ``distributed`` (process groups, devices,
launch), ``streaming`` (``ShardedStreamingManager``) and ``collectives``
(the all-reduces and row gathers they run, with gloo's host staging)."""
