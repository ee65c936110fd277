"""The least bytes of the streaming half's sweep, for
``layer_metrics/stream_out_roofline.py`` (kept apart from ``work.py``,
whose counts the other cells' readers use).

A sweep reads the pool key of every row of one part: the rows ``part``,
``part + parts``, ... of an ``num_blocks``-row pool, ``parts`` int32 keys
apart. Keys 32 bytes or more apart each cost a 32-byte sector of memory
traffic, closer keys their 4 bytes."""

SECTOR = 32


def sweep_bytes(mp, scfg) -> float:
    """The mean bytes a sweep moves over the ``out_parts`` parts."""
    rows = mp.num_blocks / scfg.out_parts
    stride = 4 * scfg.out_parts
    return rows * (SECTOR if stride >= SECTOR else 4)
