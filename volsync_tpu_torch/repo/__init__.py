"""Repository layer of the port (ports ``volsync_tpu/repo/``): blob ids,
the content-addressed repository with its packs, sharded compact index,
cipher and compression, and the restore pack cache. ``scrub.py``,
``erasure.py`` and ``repack.py`` are not ported yet (ROADMAP.md)."""
