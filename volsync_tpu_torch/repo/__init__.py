"""Repository layer of the port (ports ``volsync_tpu/repo/``): blob ids,
the content-addressed repository with its packs, sharded compact index,
cipher and compression, the restore pack cache, the Reed-Solomon shard
codec (``erasure.py``), the integrity scrub (``scrub.py``) and the
online repack (``repack.py``)."""
